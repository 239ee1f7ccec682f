"""The memory cells behind the contract of the sparse-rollback unroll
engine (`core/unroll.py`), the port of `repro/core/cell.py`'s `SAMCell`
and `SDNCCell`:

  * ``step(params, state, x, collect_deltas=)`` — one forward step; with
    ``collect_deltas=True`` it also returns the step's deltas (the
    touched rows, their old contents, the selections): O(K·W) per step;
  * ``residual_state(state)`` — the small part of the state that the
    backward restores directly (the previous read and the controller;
    the SDNC's also its write weights and precedence);
  * ``rollback(state, prev_small, deltas)`` — undo one step: 'set' the
    recorded old rows back into the dense buffers, in place, and splice
    the small state back in. The usage table stays stale on purpose: the
    backward never reads it (``stale_buffers`` names it);
  * ``redo_deltas(state, prev_small, deltas)`` — the step's deltas with
    the rows the rollback is about to overwrite (the rows the step left)
    in place of the old ones: `rollback` with them 'sets' the step again,
    which is how `unroll.roll_forward` brings the final state back after
    a backward. Gathered before the step's rollback, O(K·W);
  * ``replay_step(params, state, x, deltas, cts)`` — recompute the step
    from the rolled-back state with the recorded selections as fixed
    inputs. It needs neither the usage table, nor a sweep, nor the LSH
    index (an LSH cell's recorded selection is signed: -1 replays with
    weight exactly 0), so the rollback leaves the index as it is, as the
    JAX cell does.

Each cell names the buffers of its state that it updates in place
(``dense_buffers``: SAM's memory and usage table; the SDNC's memory, usage
table and N_t, P_t) and, among them, those that carry a cotangent
(``cotangent_buffers``: the memory; the SDNC's also N_t's and P_t's
values). Such a buffer's cotangent cannot follow JAX's functional replay,
which hands every step a fresh dense gradient. The backward instead keeps
**one** dense cotangent buffer per such buffer for the whole backward
(``cts``, in the order of ``cotangent_buffers``) and updates it in place,
O(K·W) per step, through autograd Functions of the replay:

  * the write (`_ReplayWrite`) writes the memory in place and outputs an
    empty token; its backward hands w and a the cotangent rows at the
    written rows, then zeroes the erased rows of ``mem_ct``;
  * a read's row gather (`_ReadRows`) takes the token, so autograd runs
    its backward first: it adds the K rows' cotangents into ``mem_ct``
    with `scatter_rows('add')` (two heads may read one row, and
    `index_put_(accumulate=True)` would sum them in an unspecified order
    on the card);
  * the SDNC's link reads (`_LinkRows`) gather rows of N_{t-1} and
    P_{t-1} scaled by the previous read weights and output a token that
    the linkage update (`_ReplayLinkage`) takes, so autograd runs the
    update's backward first: it hands each winning row its gradient
    through the merge, zeroes the overwritten rows of the cotangent and
    adds the old rows' gradient back in j order; then the link reads add
    their rows' cotangents. O(J·K_L + K_L²) per step.

The per-step autograd graph holds only small tensors: parameters, the
controller state, the previous read, x and the gathered rows.

On a rank's block of a slot-sharded memory (`distributed/mem_shard.py`)
``mem_ct`` is the rank's cotangent block. The SAM replay gathers the rows
it reads, and the write's cotangent rows, from the ranks that own them,
so every rank computes the single-device gradients of the replicated
leaves; each rank adds, zeroes and sets only the rows it owns, and the
rollback and the redo restore only those (module docstring there).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import addressing as addr
from repro_torch.core import dnc as dnc_lib
from repro_torch.core import sam as sam_lib
from repro_torch.core.controller import linear, lstm_step
from repro_torch.core.quant import dequantize_rows
from repro_torch.core.sam import SAMConfig, _interface, apply_write, write_plan
from repro_torch.core.types import (SAMState, SparseRead, StepDeltas,
                                    tree_bytes)
from repro_torch.distributed import mem_shard
from repro_torch.kernels import ops, ref


class _ReplayWrite(torch.autograd.Function):
    """The replay's memory-only write on a memory outside the graph; its
    gradient goes through ``mem_ct``, the cotangent of the memory after the
    write, which it leaves as the cotangent of the memory before it.

    On int8 rows (``mem_scale`` given) ``mem_ct`` is the scales'
    cotangent, the write is the fused quantized one against the throwaway
    table ``usage`` (`sam.apply_write`), and ``old`` holds the touched
    rows' recorded codes and scales (`StepDeltas`): the backward hands w
    and a the closed-form gradient of the new scales (`ops.write_q_vjp`),
    then sets each touched row of ``mem_ct`` to its old scale's gradient,
    which the winning column carries.

    On a rank's block (``shard``) the memory and ``mem_ct`` are blocks:
    the written rows' cotangents are gathered from the ranks that own
    them (O(J·W)), so w and a get the single-device gradients on every
    rank, and each rank zeroes or sets only the rows it owns."""

    @staticmethod
    def forward(ctx, write_w, a, memory, mem_ct, write_idx, lra_idx,
                mem_scale=None, usage=None, old=None, shard=None):
        apply_write(memory, write_idx, write_w, a, lra_idx,
                    mem_scale=mem_scale, usage=usage, shard=shard)
        ctx.save_for_backward(write_w, a)
        ctx.mem_ct, ctx.write_idx, ctx.lra_idx = mem_ct, write_idx, lra_idx
        ctx.old, ctx.shard = old, shard
        return write_w.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        write_w, a = ctx.saved_tensors
        ct, widx, shard = ctx.mem_ct, ctx.write_idx, ctx.shard
        nones = (None,) * 8
        if ctx.old is not None:
            win = (ops.winners(ct, widx) if shard is None
                   else mem_shard.winners_sharded(shard, ct, widx))
            g_old_s, g_w, g_a = ops.write_q_vjp(win, *ctx.old, widx,
                                                ctx.lra_idx, write_w, a)
            addr.scatter_set_rows(ct[..., None], widx, g_old_s[..., None],
                                  shard=shard)
            return (g_w, g_a) + nones
        # The written rows' cotangents, read before the erase zeroes them.
        g_w, g_a = ops.write_rows_vjp(
            addr.gather_rows(ct, widx, shard=shard).to(torch.float32),
            write_w, a)
        addr.scatter_set_rows(ct, ctx.lra_idx, ct.new_zeros(a.shape),
                              shard=shard)
        return (g_w, g_a) + nones


class _ReadRows(torch.autograd.Function):
    """The rows ``idx`` (B, H, K) names, gathered after the write that
    ``token`` stands for, as f32 words (bf16 rows upcast, int8 rows
    dequantized with ``mem_scale``); their cotangents are added into
    ``mem_ct`` (bf16: rounded to bf16 first, as JAX's cast transposes
    them). On int8 rows ``mem_ct`` is the scales' cotangent, and each row
    adds Σ_w g_w · code_w into its scale's. On a rank's block
    (``shard``) the rows come from the ranks that own them, and each rank
    adds the (replicated) cotangents of the rows it owns: the backward of
    the owned-rows sum is the identity on them."""

    @staticmethod
    def forward(ctx, token, memory, mem_ct, idx, mem_scale=None, shard=None):
        ctx.mem_ct, ctx.idx, ctx.shard = mem_ct, idx, shard
        rows = addr.gather_rows(memory, idx, shard=shard)
        if mem_scale is None:
            return rows.to(torch.float32)
        ctx.save_for_backward(rows)
        return dequantize_rows(rows, addr.gather_scales(mem_scale, idx,
                                                        shard=shard))

    @staticmethod
    def backward(ctx, g_words):
        B, W = g_words.shape[0], g_words.shape[-1]
        flat = ctx.idx.reshape(B, -1)
        if ctx.saved_tensors:
            codes, = ctx.saved_tensors
            g_s = (g_words * codes.to(torch.float32)).sum(-1)
            addr.scatter_add_rows(ctx.mem_ct[..., None], flat,
                                  g_s.reshape(B, -1, 1), shard=ctx.shard)
        else:
            addr.scatter_add_rows(ctx.mem_ct, flat,
                                  g_words.reshape(B, -1, W), shard=ctx.shard)
        return g_words.new_zeros(0), None, None, None, None, None


def _replay_usage(ct: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """The throwaway usage table of an int8 replay's write (`apply_write`),
    made at the first replayed step of a backward and kept on the scales'
    cotangent, which lives for that backward: (B, N+1) int32 zeros, 32 MiB
    at B = 8, N = 2^20."""
    usage = getattr(ct, "replay_usage", None)
    if usage is None:
        usage = ct.replay_usage = torch.zeros(memory.shape[:2],
                                              dtype=torch.int32,
                                              device=memory.device)
    return usage


def sam_replay_step(params, cfg: SAMConfig, s: SAMState, x: torch.Tensor,
                    deltas: StepDeltas, mem_ct: torch.Tensor):
    """Recompute one SAM step from the rolled-back state ``s`` with the
    recorded selections. Writes the memory (and an int8 memory's scales)
    in place (it then holds the step's memory again, bit for bit) and
    returns (new_state, y), which are differentiable in the parameters, x
    and the small float leaves of ``s``; the memory's gradient goes
    through ``mem_ct`` (module docstring), the scales' cotangent for int8
    rows."""
    B = x.shape[0]
    H, K = cfg.memory.num_heads, cfg.memory.k
    ctrl_in = torch.cat([x, s.read.words.reshape(B, -1)], dim=-1)
    ctrl, h = lstm_step(params["lstm"], s.ctrl, ctrl_in)
    q, a, beta, alpha, gamma = _interface(params, cfg, h)
    lra_idx = deltas.write_idx.reshape(B, H, K + 1)[..., -1].contiguous()
    _, ww, _, _ = write_plan(cfg, s.read, lra_idx, alpha, gamma)
    q8 = s.mem_scale is not None
    shard = mem_shard.memory_layout(cfg.memory.num_slots, s.memory.shape[1])
    token = _ReplayWrite.apply(
        ww, a, s.memory, mem_ct, deltas.write_idx, lra_idx, s.mem_scale,
        _replay_usage(mem_ct, s.memory) if q8 else None,
        (deltas.old_rows, deltas.old_scale) if q8 else None, shard)
    idx = deltas.read_idx.clamp_min(0)
    words = _ReadRows.apply(token, s.memory, mem_ct, idx, s.mem_scale, shard)
    read = addr.read_from_rows(q, words, beta, deltas.read_idx)
    y = linear(params["out"], torch.cat([h, read.words.reshape(B, -1)], -1))
    return SAMState(memory=s.memory, last_access=s.last_access, read=read,
                    ctrl=ctrl, step=s.step + 1, ann=s.ann,
                    mem_scale=s.mem_scale), y


@dataclasses.dataclass(frozen=True)
class SAMCell:
    """SAM (paper §3) behind the unroll engine's cell contract."""

    cfg: SAMConfig

    @property
    def dense_buffers(self):
        """The memory and the usage table, and an int8 memory's scales."""
        return ("memory", "last_access") + (
            ("mem_scale",) if self.cfg.memory.mem_dtype == "int8" else ())

    @property
    def cotangent_buffers(self):
        """The memory (f32 or bf16 rows), or an int8 memory's scales: its
        codes carry no cotangent."""
        return (("mem_scale",) if self.cfg.memory.mem_dtype == "int8"
                else ("memory",))

    stale_buffers = ("last_access",)

    def init_params(self, generator: torch.Generator, *, device="cuda"):
        return sam_lib.init_params(generator, self.cfg, device=device)

    def init_state(self, batch: int, *, device="cuda") -> SAMState:
        return sam_lib.init_state(batch, self.cfg, device=device)

    def step(self, params, state, x, *, collect_deltas: bool = False):
        return sam_lib.sam_step(params, self.cfg, state, x,
                                collect_deltas=collect_deltas)

    def residual_state(self, state: SAMState):
        return (state.read, state.ctrl)

    def _shard(self, state: SAMState):
        return mem_shard.memory_layout(self.cfg.memory.num_slots,
                                       state.memory.shape[1])

    def rollback(self, state: SAMState, prev_small, deltas: StepDeltas):
        read, ctrl = prev_small
        # write_idx names logical rows only, so scratch row N is untouched;
        # int8 rows get their recorded (row, scale) pairs back. On a rank's
        # block, the rows this rank owns.
        addr.scatter_set_rows(state.memory, deltas.write_idx, deltas.old_rows,
                              mem_scale=state.mem_scale,
                              rows_scale=deltas.old_scale,
                              shard=self._shard(state))
        return state._replace(read=read, ctrl=ctrl, step=state.step - 1)

    def redo_deltas(self, state: SAMState, prev_small, deltas: StepDeltas):
        """The rows (and int8 scales) at the write's rows; on a rank's
        block only those it owns, zeros for the others, with no collective:
        `rollback` restores no other."""
        shard, widx = self._shard(state), deltas.write_idx

        def rows(buf):
            if shard is None:
                return ref.gather_rows(buf, widx)
            return mem_shard.owned_rows(shard, buf, widx)

        return deltas._replace(
            old_rows=rows(state.memory),
            old_scale=None if state.mem_scale is None else rows(
                state.mem_scale))

    def replay_step(self, params, state, x, deltas: StepDeltas, cts):
        mem_ct, = cts
        return sam_replay_step(params, self.cfg, state, x, deltas, mem_ct)

    def step_residual_bytes(self, state: SAMState) -> int:
        """Bytes of one step's rollback record: `residual_state` plus the
        `StepDeltas` (J·W old rows in the memory's dtype, and J old scales
        on int8 rows)."""
        B, _, W = state.memory.shape
        mem = self.cfg.memory
        J = self.cfg.total_write_rows
        deltas = (B * J * 4 + B * J * W * state.memory.element_size()
                  + B * mem.num_heads * mem.k * 4
                  + (B * J * 4 if state.mem_scale is not None else 0))
        return tree_bytes(self.residual_state(state)) + deltas


# --------------------------------------------------------------------------
# Sparse DNC
# --------------------------------------------------------------------------

class _LinkRows(torch.autograd.Function):
    """The rows ``idx`` (B, R, K) of N_{t-1}'s or P_{t-1}'s values ``vals``
    (outside the graph), scaled by the previous read weights (B, R, K),
    and a token for the linkage update, whose backward must run first;
    the rows' cotangents are added into ``ct``, the values' cotangent."""

    @staticmethod
    def forward(ctx, weights, vals, ct, idx):
        B, R, K = idx.shape
        rows = ref.gather_rows(vals, idx.reshape(B, -1)).reshape(B, R, K, -1)
        ctx.save_for_backward(weights, rows)
        ctx.ct, ctx.idx = ct, idx
        return rows * weights[..., None], weights.new_empty(0)

    @staticmethod
    def backward(ctx, g_rows, _):
        weights, rows = ctx.saved_tensors
        B = weights.shape[0]
        ops.scatter_rows(ctx.ct, ctx.idx.reshape(B, -1),
                         (g_rows * weights[..., None]).reshape(
                             B, -1, rows.shape[-1]), "add")
        return (g_rows * rows).sum(-1), None, None, None


class _ReplayLinkage(torch.autograd.Function):
    """The replay's linkage update on N_t and P_t outside the graph: merge
    the old rows, set the new ones in place (`dnc._linkage_rows`,
    `dnc._write_linkage`), return the new precedence (idx, val). Its
    backward hands the new rows the cotangents of their winners (a row
    set twice keeps its last value), differentiates the merges on the old
    rows and ``prec_val``, zeroes the overwritten rows of ``nv_ct`` and
    ``pv_ct`` and adds the old rows' gradients back, in j order."""

    @staticmethod
    def forward(ctx, prec_val, tok_n, tok_p, ww, n_mat, p_mat, nv_ct, pv_ct,
                widx, prec_idx, k_l):
        p_rows = prec_idx.clamp_min(0)
        old = (ref.gather_rows(n_mat.cols, widx),
               ref.gather_rows(n_mat.vals, widx),
               ref.gather_rows(p_mat.cols, p_rows),
               ref.gather_rows(p_mat.vals, p_rows))
        m, mp, prec = dnc_lib._linkage_rows(
            *old, dnc_lib.SparseVec(prec_idx, prec_val), widx, ww, k_l)
        dnc_lib._write_linkage(n_mat, p_mat, widx, p_rows, m, mp)
        ctx.save_for_backward(prec_val, ww, *old)
        ctx.cts, ctx.rows = (nv_ct, pv_ct), (widx, p_rows, prec_idx)
        ctx.k_l = k_l
        ctx.mark_non_differentiable(prec[0])
        return prec

    @staticmethod
    def backward(ctx, _, g_prec):
        prec_val, ww, n_cols, n_vals, p_cols, p_vals = ctx.saved_tensors
        (nv_ct, pv_ct), (widx, p_rows, prec_idx) = ctx.cts, ctx.rows
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_()
                      for t in (prec_val, n_vals, p_vals)]
            m, mp, prec = dnc_lib._linkage_rows(
                n_cols, leaves[1], p_cols, leaves[2],
                dnc_lib.SparseVec(prec_idx, leaves[0]), widx, ww, ctx.k_l)
            g_val, g_n, g_p = torch.autograd.grad(
                [m[1], mp[1], prec[1]], leaves,
                [ops.winners(nv_ct, widx), ops.winners(pv_ct, p_rows),
                 g_prec])
        for ct, idx, g in ((nv_ct, widx, g_n), (pv_ct, p_rows, g_p)):
            ops.scatter_rows(ct, idx, torch.zeros_like(g), "set")
            ops.scatter_rows(ct, idx, g, "add")
        empty = g_prec.new_zeros(0)
        return (g_val, empty, empty) + (None,) * 8


def sdnc_replay_step(params, cfg: dnc_lib.DNCConfig, s: dnc_lib.DNCState,
                     x: torch.Tensor, deltas: dnc_lib.SDNCDeltas, cts):
    """Recompute one SDNC step from the rolled-back state ``s`` with the
    recorded selections (the LRA row, the content read's rows). Writes the
    memory, N_t and P_t in place (they then hold the step's buffers again,
    bit for bit) and returns (new_state, y), differentiable in the
    parameters, x and the small float leaves of ``s``; the buffers'
    gradients go through ``cts`` = (mem_ct, nv_ct, pv_ct) (module
    docstring). The usage table and an LSH index pass through stale."""
    mem_ct, nv_ct, pv_ct = cts
    K, KL = cfg.memory.k, cfg.k_l
    B = x.shape[0]
    ctrl, h, (rk, rb, modes, _, _, _, wv, _, alloc_g,
              write_g) = dnc_lib._controller(params, cfg, s, x)
    widx = deltas.write_idx
    _, ww = dnc_lib._write_plan(s.read, deltas.lra, alloc_g, write_g)

    # The link reads' rows of N_{t-1} and P_{t-1}, before the update.
    idx = s.read.indices
    flat = idx.reshape(B, -1)
    fwd_v, tok_n = _LinkRows.apply(s.read.weights, s.n_mat.vals, nv_ct, idx)
    bwd_v, tok_p = _LinkRows.apply(s.read.weights, s.p_mat.vals, pv_ct, idx)
    fwd = dnc_lib._link_top(ref.gather_rows(s.n_mat.cols, flat), fwd_v, K)
    bwd = dnc_lib._link_top(ref.gather_rows(s.p_mat.cols, flat), bwd_v, K)

    token = _ReplayWrite.apply(ww, wv[:, None, :], s.memory, mem_ct, widx,
                               deltas.lra)
    prec = _ReplayLinkage.apply(s.prec_sp.val, tok_n, tok_p, ww.detach(),
                                s.n_mat, s.p_mat, nv_ct, pv_ct, widx,
                                s.prec_sp.idx, KL)

    cont = addr.read_from_rows(
        rk, _ReadRows.apply(token, s.memory, mem_ct,
                            deltas.cont_idx.clamp_min(0)), rb, deltas.cont_idx)
    top_idx, top_w = dnc_lib._combine(modes, bwd, cont.indices, cont.weights,
                                      fwd, K)
    words = _ReadRows.apply(token, s.memory, mem_ct, top_idx)
    read_words = torch.einsum("brk,brkw->brw", top_w, words)
    read = SparseRead(indices=top_idx, weights=top_w, words=read_words)
    return s._replace(read=read, read_words=read_words, write_w=ww,
                      write_idx=widx, prec_sp=dnc_lib.SparseVec(*prec),
                      ctrl=ctrl, step=s.step + 1), \
        dnc_lib._output(params, h, read_words)


@dataclasses.dataclass(frozen=True)
class SDNCCell:
    """The sparse DNC (paper Suppl. D) behind the unroll engine's cell
    contract. N_t, P_t and the precedence get their own sparse deltas
    (`dnc.SDNCDeltas`), extending the §3.4 rollback to the link state."""

    cfg: dnc_lib.DNCConfig
    dense_buffers = ("memory", "usage", "n_mat.cols", "n_mat.vals",
                     "p_mat.cols", "p_mat.vals")
    cotangent_buffers = ("memory", "n_mat.vals", "p_mat.vals")
    stale_buffers = ("usage",)

    def __post_init__(self):
        if not self.cfg.sparse:
            raise ValueError("SDNCCell requires DNCConfig.sparse=True; the "
                             "dense DNC checkpoints O(N) state per step and "
                             "has no sparse rollback contract")

    def init_params(self, generator: torch.Generator, *, device="cuda"):
        return dnc_lib.init_params(generator, self.cfg, device=device)

    def init_state(self, batch: int, *, device="cuda") -> dnc_lib.DNCState:
        return dnc_lib.init_state(batch, self.cfg, device=device)

    def step(self, params, state, x, *, collect_deltas: bool = False):
        return dnc_lib.dnc_step(params, self.cfg, state, x,
                                collect_deltas=collect_deltas)

    def residual_state(self, state: dnc_lib.DNCState):
        return (state.read, state.write_w, state.prec_sp, state.ctrl)

    def rollback(self, state, prev_small, deltas):
        return dnc_lib.sdnc_rollback(self.cfg, state, prev_small, deltas)

    def redo_deltas(self, state, prev_small, deltas):
        """The memory's and N_t's rows at the write's rows, P_t's at the
        previous precedence's support (where `sdnc_rollback` sets them)."""
        widx = deltas.write_idx
        p_rows = prev_small[2].idx.clamp_min(0)
        return deltas._replace(
            old_rows=addr.gather_rows(state.memory, widx),
            n_cols=ref.gather_rows(state.n_mat.cols, widx),
            n_vals=ref.gather_rows(state.n_mat.vals, widx),
            p_cols=ref.gather_rows(state.p_mat.cols, p_rows),
            p_vals=ref.gather_rows(state.p_mat.vals, p_rows))

    def replay_step(self, params, state, x, deltas, cts):
        return sdnc_replay_step(params, self.cfg, state, x, deltas, cts)

    def step_residual_bytes(self, state: dnc_lib.DNCState) -> int:
        """Bytes of one step's rollback record: `residual_state` plus the
        `SDNCDeltas` (J memory rows in the memory's dtype, J N_t rows and
        K_L P_t rows)."""
        B, _, W = state.memory.shape
        mem, KL = self.cfg.memory, self.cfg.k_l
        J = mem.num_heads * mem.k + 1
        deltas = (4 * B * (J + 1 + mem.num_heads * mem.k + 2 * J * KL
                           + 2 * KL * KL)
                  + B * J * W * state.memory.element_size())
        return tree_bytes(self.residual_state(state)) + deltas
