"""Sparse Access Memory (SAM) — the paper's cell (§3).

One step runs the LSTM controller, splits its interface, picks the H
least-recently-accessed rows, plans the eq. 5 write, runs the fused write
(erase + w^W a^T + usage stamp), the top-K read, and the read-side usage
stamp — the same sequence as `repro/core/sam.py::sam_step` on one device,
for f32, bf16 or int8 rows (``MemoryConfig.mem_dtype``; int8 rows carry
their per-row scales in ``SAMState.mem_scale``, which the write updates
and the reads dequantize with). The read is exact (a sweep of the
memory) or, with ``MemoryConfig(ann="lsh")``, a re-rank of the LSH
index's candidates plus the freshly written rows, after which the written
rows go into the index (`core/ann.py`). The memory and the usage table
are updated **in place**: the state handed to `sam_step` shares its
`memory` and `last_access` tensors with the state it returns; the LSH
index is a new tensor each step. With ``collect_deltas=True`` a step
also returns what the sparse-rollback backward needs (`StepDeltas`,
`core/cell.py`).

`sam_step` records an autograd graph when its inputs require grad (the
naive unroll of `core/unroll.py`), on f32, bf16 or int8 rows (a bf16
memory's gradient is bf16; an int8 memory's codes get none, its scales
do). `sam_unroll` and `SAM.forward`, the forward-only path, run under
`torch.inference_mode` and record none.

Slot-sharded memory (`distributed/mem_shard.py`): under
``mem_shard.memory_mesh(N)`` in each rank of a process group,
`init_state` builds this rank's block and `sam_step` runs every memory op
through its sharded counterpart (`mem_shard.memory_layout` tells a block
from a whole memory): the exact read on f32, bf16 or int8 rows, forward,
recorded by autograd (the naive unroll) or with ``collect_deltas`` (the
sparse-rollback engine, `core/cell.py`). The LSH read raises there
(`MESH_ITEM`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import addressing as addr
from repro_torch.core import ann as ann_lib
from repro_torch.core.controller import (linear, linear_init, lstm_init,
                                         lstm_step, lstm_zero_state)
from repro_torch.core.types import (MEM_DTYPES, ControllerConfig,
                                    MemoryConfig, SAMState, SparseRead,
                                    StepDeltas, init_scratch_last_access,
                                    init_scratch_mem_scale,
                                    init_scratch_memory, require_live)
from repro_torch.distributed import mem_shard
from repro_torch.kernels import ref

# The open roadmap item that the slot-sharded memory's other routes wait on.
MESH_ITEM = ("on a slot-sharded memory the port runs the exact read, on "
             "f32, bf16 and int8 rows, forward and in training; the LSH "
             "read (the sharded index) is ROADMAP.md A11, item 2")


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    memory: MemoryConfig
    controller: ControllerConfig

    @property
    def write_rows_per_head(self) -> int:
        return self.memory.k + 1          # K previously-read + 1 LRA

    @property
    def total_write_rows(self) -> int:
        return self.memory.num_heads * self.write_rows_per_head


def init_params(generator: torch.Generator, cfg: SAMConfig, *, device="cuda"):
    """Weights of the JAX shapes and glorot scale, drawn in order (LSTM wx,
    wh, interface, output) from ``generator``; an LSH cell's fixed planes
    (``lsh_planes``, (T, bits, W)) are drawn after them, so a seed gives an
    exact-read cell the same weights as before."""
    mem, ctl = cfg.memory, cfg.controller
    H, W = mem.num_heads, mem.word_size
    # Per head: query (W), beta (1), write word (W), alpha (1), gamma (1).
    params = {
        "lstm": lstm_init(generator, ctl.input_size + H * W, ctl.hidden_size,
                          device=device),
        "iface": linear_init(generator, ctl.hidden_size, H * (2 * W + 3),
                             device=device),
        "out": linear_init(generator, ctl.hidden_size + H * W,
                           ctl.output_size, device=device),
    }
    if mem.ann == "lsh":
        params["lsh_planes"] = ann_lib.lsh_planes(generator, mem,
                                                  device=device)
    return params


def init_state(batch: int, cfg: SAMConfig, *, device="cuda") -> SAMState:
    """A zero state: the memory in the storage dtype ``mem_dtype`` (int8
    rows with all-zero scales, so every cold row dequantizes to exactly
    0.0), the staggered usage table, a zero read and controller, and an
    empty LSH index for an ``ann="lsh"`` cell. Under
    ``mem_shard.memory_mesh(N)`` the memory and usage table are this
    rank's block, (B, N/S + 1, ...), built directly
    (`mem_shard.init_layout`)."""
    mem, ctl = cfg.memory, cfg.controller
    H, K, W = mem.num_heads, mem.k, mem.word_size
    N, first = mem_shard.init_layout(mem.num_slots)
    read = SparseRead(
        indices=torch.zeros((batch, H, K), dtype=torch.int32, device=device),
        weights=torch.zeros((batch, H, K), device=device),
        words=torch.zeros((batch, H, W), device=device))
    return SAMState(
        memory=init_scratch_memory(batch, N, W,
                                   dtype=MEM_DTYPES[mem.mem_dtype],
                                   device=device),
        last_access=init_scratch_last_access(batch, N, first=first,
                                             device=device),
        read=read, ctrl=lstm_zero_state(batch, ctl.hidden_size, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        ann=(ann_lib.ann_init(batch, mem, device=device)
             if mem.ann == "lsh" else None),
        mem_scale=(init_scratch_mem_scale(batch, N, device=device)
                   if mem.mem_dtype == "int8" else None))


def _interface(params, cfg: SAMConfig, h: torch.Tensor):
    """Split the controller projection p_t = (q, a, beta, alpha, gamma),
    per head with stride 2W+3."""
    H, W = cfg.memory.num_heads, cfg.memory.word_size
    p = linear(params["iface"], h).reshape(h.shape[0], H, 2 * W + 3)
    q = p[..., :W].contiguous()
    a = p[..., W:2 * W].contiguous()
    beta = F.softplus(p[..., 2 * W]) + 1.0
    alpha = torch.sigmoid(p[..., 2 * W + 1])
    gamma = torch.sigmoid(p[..., 2 * W + 2])
    return q, a, beta, alpha, gamma


def write_plan(cfg: SAMConfig, prev_read: SparseRead, lra_idx: torch.Tensor,
               alpha: torch.Tensor, gamma: torch.Tensor):
    """Eq. (5): w^W = α (γ w^R_{t-1} + (1-γ) I^U), flattened to
    (B, H·(K+1)): each head's K previous read rows, in the read's order,
    then its LRA row."""
    B = prev_read.indices.shape[0]
    w_read = alpha[..., None] * gamma[..., None] * prev_read.weights
    w_lra = (alpha * (1.0 - gamma))[..., None]
    idx = torch.cat([prev_read.indices, lra_idx[..., None]], dim=-1)
    w = torch.cat([w_read, w_lra], dim=-1)
    return idx.reshape(B, -1), w.reshape(B, -1), idx, w


def apply_write(memory: torch.Tensor, write_idx: torch.Tensor,
                write_w: torch.Tensor, a: torch.Tensor,
                lra_idx: torch.Tensor, *, mem_scale=None, usage=None,
                shard=None):
    """The memory-only write used by the replay (`core/cell.py`), in place:
    erase the LRA rows (R_t = I^U 1^T), then add the outer product
    A_t = w^W a^T on the H·(K+1) touched rows, both through `scatter_rows`.
    Its floats are the fused write's bit for bit: each touched row starts
    from its old value (zero if erased) and adds its columns in j order
    (bf16 rows: each w·a rounded to bf16, each add rounded).

    int8 rows (``mem_scale`` given): an erase and an add would quantize a
    row twice, so the replay runs the *same* fused quantized write that
    the forward ran (`repro/core/sam.py:147-157`), each touched row
    rounded once, against ``usage``, a throwaway all-zero (B, N+1) int32
    usage table: the step is its scratch entry, 0, so the stamps leave it
    all zero, and nothing reads it. On a rank's block (``shard``) each
    rank writes the rows it owns. Returns the memory."""
    if mem_scale is not None:
        addr.sparse_write_update(memory, usage, write_idx, write_w, a,
                                 lra_idx, usage[:, -1], 0.0,
                                 mem_scale=mem_scale, shard=shard)
        return memory
    B, H, W = a.shape
    memory = addr.scatter_set_rows(memory, lra_idx,
                                   memory.new_zeros((B, H, W)), shard=shard)
    return addr.scatter_add_rows(memory, write_idx, ref.write_rows(write_w, a),
                                 shard=shard)


def sam_step(params, cfg: SAMConfig, state: SAMState, x: torch.Tensor, *,
             collect_deltas: bool = False):
    """One SAM time step. Returns (new_state, y_t[, deltas]);
    ``state.memory`` and ``state.last_access`` (and an int8 memory's
    ``state.mem_scale``) are updated in place."""
    mem = cfg.memory
    H, K, N = mem.num_heads, mem.k, mem.num_slots
    int8 = mem.mem_dtype == "int8"
    if (state.memory.dtype != MEM_DTYPES[mem.mem_dtype]
            or (state.mem_scale is not None) != int8):
        raise ValueError(f"mem_dtype={mem.mem_dtype!r} needs a "
                         f"{MEM_DTYPES[mem.mem_dtype]} memory "
                         f"{'with' if int8 else 'without'} mem_scale, got a "
                         f"{state.memory.dtype} memory and mem_scale "
                         f"{'set' if state.mem_scale is not None else 'None'}")
    if (state.ann is not None) != (mem.ann == "lsh"):
        raise ValueError(f"ann={mem.ann!r} needs a state "
                         f"{'with' if mem.ann == 'lsh' else 'without'} an "
                         f"LSH index")
    require_live(state)
    shard = mem_shard.memory_layout(N, state.memory.shape[1])
    if shard is not None and mem.ann == "lsh":
        raise NotImplementedError(f"ann={mem.ann!r}: {MESH_ITEM}")
    B = x.shape[0]
    ctrl_in = torch.cat([x, state.read.words.reshape(B, -1)], dim=-1)
    ctrl, h = lstm_step(params["lstm"], state.ctrl, ctrl_in)
    q, a, beta, alpha, gamma = _interface(params, cfg, h)

    # ---- write (uses the previous step's read locations, eq. 5) ----
    step = state.step + 1
    lra_idx = addr.least_recently_accessed(state.last_access, H, valid_n=N,
                                           shard=shard)
    widx, ww, _, _ = write_plan(cfg, state.read, lra_idx, alpha, gamma)
    old_scale = None
    if collect_deltas:
        # The raw storage bits (int8 codes) and, for int8 rows, the scales.
        old_rows = addr.gather_rows(state.memory, widx, shard=shard)
        if int8:
            old_scale = addr.gather_scales(state.mem_scale, widx,
                                           shard=shard)
    mem_scale = state.mem_scale
    if int8:
        memory, la, mem_scale = addr.sparse_write_update(
            state.memory, state.last_access, widx, ww, a, lra_idx, step,
            mem.delta, mem_scale=mem_scale, shard=shard)
    else:
        memory, la = addr.sparse_write_update(
            state.memory, state.last_access, widx, ww, a, lra_idx, step,
            mem.delta, shard=shard)

    # ---- read (content-based, sparse) and its usage stamp ----
    if mem.ann == "lsh":
        # Candidates: the buckets of q in the index from before this step's
        # insert, then the freshly written rows; the read runs on the
        # written memory, and the written rows then go into the index.
        planes = params["lsh_planes"]
        cand = ann_lib.ann_candidates(planes, state.ann, q, widx, mem)
        read, read_sel = addr.select_and_read_candidates(
            q, memory, beta, K, cand, mem_scale=mem_scale)
        # The written rows are hashed raw, upcast to f32 (exact for bf16
        # and int8 codes) and not dequantized: a row's positive scale
        # leaves its projections' signs as they are, and JAX hashes the
        # codes so.
        rows = addr.gather_rows(memory, widx).detach().to(torch.float32)
        ann_state = ann_lib.ann_insert(planes, state.ann, widx, rows, mem)
    else:
        read = addr.sparse_read_exact(q, memory, beta, K, valid_n=N,
                                      mem_scale=mem_scale, shard=shard)
        read_sel, ann_state = read.indices, None
    la = addr.update_last_access(la, read.indices.reshape(B, -1),
                                 read.weights.reshape(B, -1), step, mem.delta,
                                 shard=shard)

    y = linear(params["out"], torch.cat([h, read.words.reshape(B, -1)], -1))
    new_state = SAMState(memory=memory, last_access=la, read=read, ctrl=ctrl,
                         step=step, ann=ann_state, mem_scale=mem_scale)
    if collect_deltas:
        # Signed (-1 = no valid candidate), so the replay rebuilds the
        # read's validity mask.
        return new_state, y, StepDeltas(write_idx=widx, old_rows=old_rows,
                                        read_idx=read_sel,
                                        old_scale=old_scale)
    return new_state, y


@torch.inference_mode()
def sam_unroll(params, cfg: SAMConfig, state: SAMState, xs: torch.Tensor):
    """Run `sam_step` over xs (T, B, D). Returns (final_state, ys (T, B,
    output_size)); the memory is updated in place."""
    ys = []
    for x in xs:
        state, y = sam_step(params, cfg, state, x)
        ys.append(y)
    return state, torch.stack(ys)


class SAM(nn.Module):
    """The SAM cell as a module. Its weights are trainable parameters in
    the JAX tree layout (`params()` hands them to `core/unroll.py` for
    training); an LSH cell's fixed planes are a buffer, not a parameter.
    `forward` unrolls the cell over a sequence without a graph."""

    def __init__(self, cfg: SAMConfig, params=None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed), cfg,
                                 device=device)

        def group(tree):
            return nn.ParameterDict({k: nn.Parameter(v)
                                     for k, v in tree.items()})

        self.lstm = group(params["lstm"])
        self.iface = group(params["iface"])
        self.out = group(params["out"])
        if "lsh_planes" in params:
            self.register_buffer("lsh_planes", params["lsh_planes"])

    def params(self):
        """The weights as the nested dict that `sam_step` takes."""
        out = {"lstm": dict(self.lstm), "iface": dict(self.iface),
               "out": dict(self.out)}
        if self.cfg.memory.ann == "lsh":
            out["lsh_planes"] = self.lsh_planes
        return out

    def init_state(self, batch: int) -> SAMState:
        return init_state(batch, self.cfg, device=self.lstm["b"].device)

    def forward(self, state: SAMState, xs: torch.Tensor):
        return sam_unroll(self.params(), self.cfg, state, xs)
