"""SAM external memory as an LM layer: the single-device, f32-row part
of the JAX package's `models/sam_layer.py`.

Every `every_n_layers`-th block is followed by a read and a write of a
per-sequence (B, N+1, W) memory in the scratch-row layout (row N is the
write scratch, its usage entry pinned at `LA_SCRATCH`): a sparse top-K
content read (§3.1) and a write to {previously read ∪ LRA} rows (§3.2),
with the δ-thresholded last-access usage. The forward runs one read and
write per segment of the sequence (`memory_layer_seq`), the decode one
per token (`lm.decode_step`). The memory ops go through
`repro_torch.core.addressing`, so on the card they launch the read (B1),
write (B2) and LRA (B3) kernels.

The write updates the memory and the usage table **in place** (JAX
returns new buffers): a `MemoryState` handed to `memory_access` is
consumed. In training the segment loop runs through the sparse-rollback
engine (`core/unroll.py`) as `LMMemoryCell`, in the mode that
``cfg.memory.unroll_mode`` names; the backward's rollback restores rows
with `scatter_rows` (B4). bf16 and int8 rows are ROADMAP item A9c.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import addressing as addr
from repro_torch.core import unroll as unroll_lib
from repro_torch.core.cell import _ReadRows, _ReplayWrite
from repro_torch.core.types import (SCRATCH_ROWS, init_scratch_last_access,
                                    init_scratch_memory, require_live,
                                    tree_bytes)
from repro_torch.kernels.ops import _records
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import lane_einsum, pdef


class MemoryState(NamedTuple):
    """Per-sequence external memory in the scratch-row layout."""

    memory: torch.Tensor       # (B, N+1, W) f32; row N = write scratch
    last_access: torch.Tensor  # (B, N+1) int32; [N] = LA_SCRATCH
    read_idx: torch.Tensor     # (B, H, K) int32, the previous read's rows
    read_w: torch.Tensor       # (B, H, K) f32
    step: torch.Tensor         # () int32, or (B, 1) per-lane steps


class MemDeltas(NamedTuple):
    """What one access records for the backward (paper §3.4): the touched
    rows and their contents before the write, the LRA rows and the read's
    selection. O(H·K·W) per segment."""

    write_idx: torch.Tensor    # (B, H·(K+1)) int32
    old_rows: torch.Tensor     # (B, H·(K+1), W) f32
    lra: torch.Tensor          # (B, H) int32
    read_idx: torch.Tensor     # (B, H, K) int32


def _require_f32_rows(cfg: ModelConfig) -> None:
    if cfg.memory.mem_dtype != "float32":
        raise ValueError(f"the LM memory layer runs f32 rows; mem_dtype="
                         f"{cfg.memory.mem_dtype!r} is ROADMAP item A9c")


def memory_defs(cfg: ModelConfig):
    m = cfg.memory
    d, W, H = cfg.d_model, m.word_size, m.num_heads
    return {"wq": pdef((d, H, W)), "wa": pdef((d, H, W)),
            "wr": pdef((H, W, d), scale=0.02),
            "gates": pdef((d, H, 3), init="zeros")}


def memory_state_shapes(cfg: ModelConfig, batch: int):
    m = cfg.memory
    rows = m.num_slots + SCRATCH_ROWS
    return {"memory": (batch, rows, m.word_size),
            "last_access": (batch, rows),
            "read_idx": (batch, m.num_heads, m.k),
            "read_w": (batch, m.num_heads, m.k)}


def init_memory_state(cfg: ModelConfig, batch: int, *,
                      device="cuda") -> MemoryState:
    """Zero memory, the staggered usage table (the first LRA picks are
    N-1, N-2, ...), zero read history, step 0."""
    _require_f32_rows(cfg)
    m = cfg.memory
    return MemoryState(
        memory=init_scratch_memory(batch, m.num_slots, m.word_size,
                                   device=device),
        last_access=init_scratch_last_access(batch, m.num_slots,
                                             device=device),
        read_idx=torch.zeros((batch, m.num_heads, m.k), dtype=torch.int32,
                             device=device),
        read_w=torch.zeros((batch, m.num_heads, m.k), device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _interface(p, cfg: ModelConfig, pooled: torch.Tensor):
    """Project a summary (B, d) to (q, a, alpha, gamma, beta), each in
    the promoted dtype of the summary and the weights."""
    q = lane_einsum("bd,dhw->bhw", pooled, p["wq"])
    a = lane_einsum("bd,dhw->bhw", pooled, p["wa"])
    g = torch.sigmoid(lane_einsum("bd,dhg->bhg", pooled, p["gates"]))
    alpha, gamma, beta_g = g[..., 0], g[..., 1], g[..., 2]
    return q, a, alpha, gamma, 1.0 + 9.0 * beta_g            # key strength


def _write_weights(state: MemoryState, lra: torch.Tensor,
                   alpha: torch.Tensor, gamma: torch.Tensor):
    """Eq. (5): w^W = α (γ w^R_{t-1} + (1-γ) I^U), flattened to
    (B, H·(K+1)). α·γ is formed in the gates' dtype and then meets the
    f32 read weights, as JAX promotes it."""
    B = alpha.shape[0]
    w_read = (alpha[..., None] * gamma[..., None]) * state.read_w
    w_lra = (alpha * (1.0 - gamma))[..., None]
    widx = torch.cat([state.read_idx, lra[..., None]], dim=-1)  # (B,H,K+1)
    ww = torch.cat([w_read, w_lra.to(w_read.dtype)], dim=-1)
    return widx.reshape(B, -1), ww.reshape(B, -1)


def memory_access(p, cfg: ModelConfig, pooled: torch.Tensor,
                  state: MemoryState, *, collect_deltas: bool = False):
    """One SAM read and write for a summary ``pooled`` (B, d). The kernels
    take f32: q and beta are cast as the JAX read kernels cast them, the
    write word ``a`` to the memory's dtype as the JAX write does. Returns
    (new_state, read_out (B, d)[, `MemDeltas`]) with read_out in the
    promoted dtype of the f32 read and the weights (f32). The products
    with the weights run through `layers.lane_einsum`, so a lane's bits
    do not depend on how many lanes the batch holds."""
    m = cfg.memory
    B = pooled.shape[0]
    H, K, N = m.num_heads, m.k, m.num_slots
    if state.memory.shape[1] != N + SCRATCH_ROWS:
        raise ValueError(f"a memory of {state.memory.shape[1]} rows is not "
                         f"the scratch-row layout of N = {N}")
    require_live(state)
    q, a, alpha, gamma, beta = _interface(p, cfg, pooled)
    step = state.step + 1
    lra = addr.least_recently_accessed(state.last_access, H, valid_n=N)
    widx, ww = _write_weights(state, lra, alpha, gamma)
    widx = widx.contiguous()
    if collect_deltas:
        old_rows = addr.gather_rows(state.memory, widx)
    memory, la = addr.sparse_write_update(
        state.memory, state.last_access, widx, ww.contiguous(),
        a.to(state.memory.dtype).contiguous(), lra, step, m.delta)
    read = addr.sparse_read_exact(q.float().contiguous(), memory,
                                  beta.float().contiguous(), K, valid_n=N)
    la = addr.update_last_access(la, read.indices.reshape(B, -1),
                                 read.weights.reshape(B, -1), step, m.delta)
    out = lane_einsum("bhw,hwd->bd", read.words, p["wr"])
    new_state = MemoryState(memory=memory, last_access=la,
                            read_idx=read.indices, read_w=read.weights,
                            step=step)
    if collect_deltas:
        return new_state, out, MemDeltas(write_idx=widx, old_rows=old_rows,
                                         lra=lra, read_idx=read.indices)
    return new_state, out


def memory_replay(p, cfg: ModelConfig, pooled: torch.Tensor,
                  state: MemoryState, deltas: MemDeltas,
                  mem_ct: torch.Tensor):
    """Recompute one access from the rolled-back ``state`` with the
    recorded rows: the memory-only write (the LRA rows set to zero, then
    w·a added at the written rows; `core/cell.py::_ReplayWrite`) in place,
    which gives the fused write's rows bit for bit, then the read's tail on
    the recorded rows. The usage table stays stale. Differentiable in the
    parameters, ``pooled`` and ``state.read_w``; the memory's gradient goes
    through ``mem_ct`` (`core/cell.py`). Returns (new_state, read_out)."""
    q, a, alpha, gamma, beta = _interface(p, cfg, pooled)
    _, ww = _write_weights(state, deltas.lra, alpha, gamma)
    token = _ReplayWrite.apply(ww, a.to(state.memory.dtype), state.memory,
                               mem_ct, deltas.write_idx, deltas.lra)
    words = _ReadRows.apply(token, state.memory, mem_ct, deltas.read_idx)
    read = addr.read_from_rows(q.float(), words, beta.float(),
                               deltas.read_idx)
    out = lane_einsum("bhw,hwd->bd", read.words, p["wr"])
    return state._replace(read_idx=deltas.read_idx, read_w=read.weights,
                          step=state.step + 1), out


@dataclasses.dataclass(frozen=True)
class LMMemoryCell:
    """The LM memory layer behind the unroll engine's cell contract
    (`core/cell.py`): one engine step is one segment's read and write."""

    cfg: ModelConfig
    dense_buffers = ("memory", "last_access")
    cotangent_buffers = ("memory",)
    stale_buffers = ("last_access",)

    def init_state(self, batch: int, *, device="cuda") -> MemoryState:
        return init_memory_state(self.cfg, batch, device=device)

    def step(self, params, state, pooled, *, collect_deltas: bool = False):
        return memory_access(params, self.cfg, pooled, state,
                             collect_deltas=collect_deltas)

    def residual_state(self, state: MemoryState):
        return (state.read_idx, state.read_w)

    def rollback(self, state: MemoryState, prev_small, deltas: MemDeltas):
        read_idx, read_w = prev_small
        # The written rows are logical ones, so scratch row N is untouched.
        addr.scatter_set_rows(state.memory, deltas.write_idx, deltas.old_rows)
        return state._replace(read_idx=read_idx, read_w=read_w,
                              step=state.step - 1)

    def redo_deltas(self, state: MemoryState, prev_small, deltas: MemDeltas):
        return deltas._replace(
            old_rows=addr.gather_rows(state.memory, deltas.write_idx))

    def replay_step(self, params, state, pooled, deltas: MemDeltas, cts):
        mem_ct, = cts
        return memory_replay(params, self.cfg, pooled, state, deltas, mem_ct)

    def step_residual_bytes(self, state: MemoryState) -> int:
        """Bytes of one step's rollback record: `residual_state` plus the
        `MemDeltas` (J·W old rows)."""
        B, _, W = state.memory.shape
        m = self.cfg.memory
        J = m.num_heads * (m.k + 1)
        deltas = 4 * B * (J + J * W + m.num_heads + m.num_heads * m.k)
        return tree_bytes(self.residual_state(state)) + deltas


def memory_layer_seq(p, cfg: ModelConfig, x: torch.Tensor,
                     state: MemoryState, segment: int | None = None):
    """The memory over a whole sequence x (B, S, d), in segments of
    ``segment`` tokens (default ``cfg.memory.segment``): each segment's
    mean is one summary, the segments' reads and writes run in order, and
    each read is added to its segment's tokens. ``x + read`` promotes: a
    bf16 stream comes out f32, as in JAX. When autograd records, the
    segments run through the unroll engine in ``cfg.memory.unroll_mode``
    (naive, sparse or chunked, with ``unroll_chunk``); otherwise as a plain
    loop of `memory_access` under inference mode, which is the engine's
    forward. Returns (y (B, S, d), state)."""
    m = cfg.memory
    B, S, d = x.shape
    seg = min(segment if segment is not None else m.segment, S)
    if S % seg:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"memory segment {seg}")
    n = S // seg
    # jnp.mean of a bf16 tensor sums in f32 and rounds once.
    pooled = x.reshape(B, n, seg, d).float().mean(2).to(x.dtype)
    if _records(pooled, *p.values()):
        state, outs = unroll_lib.unroll(
            LMMemoryCell(cfg), p, state, pooled.transpose(0, 1).contiguous(),
            mode=m.unroll_mode, chunk=m.unroll_chunk)
        reads = outs.transpose(0, 1)
    else:
        outs = []
        with torch.inference_mode():
            for t in range(n):
                state, out = memory_access(p, cfg, pooled[:, t], state)
                outs.append(out)
        reads = torch.stack(outs, dim=1)
    reads = reads.repeat_interleave(seg, dim=1)
    ct = torch.promote_types(x.dtype, reads.dtype)
    return x.to(ct) + reads.to(ct), state
