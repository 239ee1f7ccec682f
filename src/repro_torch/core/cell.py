"""The SAM cell behind the contract of the sparse-rollback unroll engine
(`core/unroll.py`), the port of `repro/core/cell.py`'s `SAMCell`:

  * ``step(params, state, x, collect_deltas=)`` — one forward step; with
    ``collect_deltas=True`` it also returns the step's `StepDeltas` (the
    touched rows, their old contents, the read's selection): O(K·W);
  * ``residual_state(state)`` — the small part of the state that the
    backward restores directly (the previous read and the controller);
  * ``rollback(state, prev_small, deltas)`` — undo one step: 'set' the
    recorded old rows back into the memory, in place, and splice the
    small state back in. The usage table stays stale on purpose: the
    backward never reads it;
  * ``replay_step(params, state, x, deltas, mem_ct)`` — recompute the step
    from the rolled-back state with the recorded selections as fixed
    inputs. It needs neither the usage table, nor a sweep, nor the LSH
    index (an LSH cell's recorded selection is signed: -1 replays with
    weight exactly 0), so the rollback leaves the index as it is, as the
    JAX cell does.

The memory is a (B, N+1, W) buffer updated in place, so the memory's
cotangent cannot follow JAX's functional replay, which hands every step a
fresh (B, N+1, W) gradient. The backward instead keeps **one** dense
cotangent buffer ``mem_ct`` for the whole backward and updates it in place,
O(K·W) per step, through two autograd Functions of the replay:

  * the write (`_ReplayWrite`) writes the memory in place and outputs an
    empty token; its backward hands w and a the cotangent rows at the
    written rows, then zeroes the erased rows of ``mem_ct``;
  * the read's row gather (`_ReadRows`) takes the token, so autograd runs
    its backward first: it adds the K rows' cotangents into ``mem_ct``
    with `scatter_rows('add')` (two heads may read one row, and
    `index_put_(accumulate=True)` would sum them in an unspecified order
    on the card).

The per-step autograd graph holds only small tensors: parameters, the
controller state, the previous read, x and the gathered rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import addressing as addr
from repro_torch.core import sam as sam_lib
from repro_torch.core.controller import linear, lstm_step
from repro_torch.core.sam import SAMConfig, _interface, apply_write, write_plan
from repro_torch.core.types import SAMState, StepDeltas, tree_bytes
from repro_torch.kernels import ops


class _ReplayWrite(torch.autograd.Function):
    """The replay's memory-only write on a memory outside the graph; its
    gradient goes through ``mem_ct``, the cotangent of the memory after the
    write, which it leaves as the cotangent of the memory before it."""

    @staticmethod
    def forward(ctx, write_w, a, memory, mem_ct, write_idx, lra_idx):
        apply_write(memory, write_idx, write_w, a, lra_idx)
        ctx.save_for_backward(write_w, a)
        ctx.mem_ct, ctx.write_idx, ctx.lra_idx = mem_ct, write_idx, lra_idx
        return write_w.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        write_w, a = ctx.saved_tensors
        # The written rows' cotangents, read before the erase zeroes them.
        g_w, g_a = ops.write_rows_vjp(
            addr.gather_rows(ctx.mem_ct, ctx.write_idx), write_w, a)
        ops.scatter_rows(ctx.mem_ct, ctx.lra_idx, ctx.mem_ct.new_zeros(a.shape),
                         "set")
        return g_w, g_a, None, None, None, None


class _ReadRows(torch.autograd.Function):
    """The rows ``idx`` (B, H, K) names, gathered after the write that
    ``token`` stands for; their cotangents are added into ``mem_ct``."""

    @staticmethod
    def forward(ctx, token, memory, mem_ct, idx):
        ctx.mem_ct, ctx.idx = mem_ct, idx
        return addr.gather_rows(memory, idx)

    @staticmethod
    def backward(ctx, g_words):
        B, W = g_words.shape[0], g_words.shape[-1]
        ops.scatter_rows(ctx.mem_ct, ctx.idx.reshape(B, -1),
                         g_words.reshape(B, -1, W), "add")
        return g_words.new_zeros(0), None, None, None


def sam_replay_step(params, cfg: SAMConfig, s: SAMState, x: torch.Tensor,
                    deltas: StepDeltas, mem_ct: torch.Tensor):
    """Recompute one SAM step from the rolled-back state ``s`` with the
    recorded selections. Writes the memory in place (it then holds the
    step's memory again, bit for bit) and returns (new_state, y), which
    are differentiable in the parameters, x and the small float leaves of
    ``s``; the memory's gradient goes through ``mem_ct`` (module
    docstring)."""
    B = x.shape[0]
    H, K = cfg.memory.num_heads, cfg.memory.k
    ctrl_in = torch.cat([x, s.read.words.reshape(B, -1)], dim=-1)
    ctrl, h = lstm_step(params["lstm"], s.ctrl, ctrl_in)
    q, a, beta, alpha, gamma = _interface(params, cfg, h)
    lra_idx = deltas.write_idx.reshape(B, H, K + 1)[..., -1].contiguous()
    _, ww, _, _ = write_plan(cfg, s.read, lra_idx, alpha, gamma)
    token = _ReplayWrite.apply(ww, a, s.memory, mem_ct, deltas.write_idx,
                               lra_idx)
    idx = deltas.read_idx.clamp_min(0)
    words = _ReadRows.apply(token, s.memory, mem_ct, idx)
    read = addr.read_from_rows(q, words, beta, deltas.read_idx)
    y = linear(params["out"], torch.cat([h, read.words.reshape(B, -1)], -1))
    return SAMState(memory=s.memory, last_access=s.last_access, read=read,
                    ctrl=ctrl, step=s.step + 1, ann=s.ann), y


@dataclasses.dataclass(frozen=True)
class SAMCell:
    """SAM (paper §3) behind the unroll engine's cell contract."""

    cfg: SAMConfig

    def init_params(self, generator: torch.Generator, *, device="cuda"):
        return sam_lib.init_params(generator, self.cfg, device=device)

    def init_state(self, batch: int, *, device="cuda") -> SAMState:
        return sam_lib.init_state(batch, self.cfg, device=device)

    def step(self, params, state, x, *, collect_deltas: bool = False):
        return sam_lib.sam_step(params, self.cfg, state, x,
                                collect_deltas=collect_deltas)

    def residual_state(self, state: SAMState):
        return (state.read, state.ctrl)

    def rollback(self, state: SAMState, prev_small, deltas: StepDeltas):
        read, ctrl = prev_small
        # write_idx names logical rows only, so scratch row N is untouched.
        addr.scatter_set_rows(state.memory, deltas.write_idx, deltas.old_rows)
        return state._replace(read=read, ctrl=ctrl, step=state.step - 1)

    def replay_step(self, params, state, x, deltas: StepDeltas,
                    mem_ct: torch.Tensor):
        return sam_replay_step(params, self.cfg, state, x, deltas, mem_ct)

    def step_residual_bytes(self, state: SAMState) -> int:
        """Bytes of one step's rollback record: `residual_state` plus the
        `StepDeltas` (J·W old rows in the memory's dtype)."""
        B, _, W = state.memory.shape
        mem = self.cfg.memory
        J = self.cfg.total_write_rows
        deltas = (B * J * 4 + B * J * W * state.memory.element_size()
                  + B * mem.num_heads * mem.k * 4)
        return tree_bytes(self.residual_state(state)) + deltas
