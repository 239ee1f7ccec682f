"""The slot-sharded SAM memory on `torch.distributed`: the exact-read part
of `repro/distributed/mem_shard.py`, forward and in training, on f32, bf16
and int8 rows.

The memory's N slots split into S equal blocks, one per rank of a process
group. Rank s holds the logical rows [s·N/S, (s+1)·N/S) as its own
(B, N/S + 1, W) scratch-row buffer, whose last row is its write-scratch
row: block s of the JAX package's sharded layout (B, N + S, W)
(`to_shard_layout` there). An int8 memory's (B, N + 1) scales split the
same way. A block is a valid scratch-row buffer, so the kernels run on it
unchanged with ``valid_n = local_n``. Indices are global everywhere
outside the shard ops: row g lives on rank g // local_n at local row
g % local_n.

Each O(N) sweep runs on the rank's own block through the device dispatch
(`kernels/ops.py`: the `topk_read` and `lra_topn` kernels on the card).
`topk_read` ranks bf16 rows upcast and int8 rows dequantized, as the
single-device read does, so a row scores the same on a block as in the
whole memory. What crosses ranks is independent of N:

* top-K and LRA selection: each rank's local top-K (top-n), an
  all-gather of the (B, H, K) scores and global indices, and the same
  merge on every rank by (score desc, index asc), resp. (staleness asc,
  index asc). The gather is shard-major, so a position's order is its
  global index's order and a stable sort keeps the single-device tie
  order (`_concat_shards`);
* rows: each rank contributes the rows it owns and zeros for the others,
  and a sum over ranks assembles them (the owned-rows sum), in the rows'
  dtype: O(B·J·W). Adding S-1 zeros to a row is exact, except that -0.0
  comes back as +0.0; one rank owns each row, so an int8 sum cannot
  overflow. int8 rows' scales come the same way, as a width-1 row;
* writes, usage stamps and row scatters: none. Each rank applies the
  entries it owns; the others go to its scratch row with weight 0, which
  the write kernel skips and the stamp leaves at `LA_SCRATCH`, or with
  zeroed rows (`scatter_rows_sharded`).

Training follows the transpose of `shard_map`. Every rank runs the
replicated controller and gets the same loss, and each rank's parameter
gradients equal the single-device ones with no all-reduce of them: the
backward of the owned-rows sum is the identity on the rows a rank owns
(`_GatherRows`: the replicated cotangent is added into the rank's rows,
with no collective), and a replicated value that feeds owned-row work
(the write's w and a) gets the sum of its partial cotangents, here by
gathering the written rows' cotangents from their owners (`_Write`,
`_WriteQ`, and the replay's `core/cell.py::_ReplayWrite`): O(J·W) a
step. Selections carry no gradient. The sparse-rollback engine keeps one
cotangent block per rank and rolls back only the rows each rank owns.

A context's `collectives` counts the bytes this rank sends and the host
time spent in the collectives. Every rank runs the replicated controller
on the same inputs and gets the same merged selections and rows, so the
ranks stay in lockstep: their outputs and gradients are equal bit for
bit.

The JAX package runs S programs under `shard_map`; here one process per
shard runs the same code, over gloo on the CPU (the tests) or on the card
(gloo takes CUDA tensors and copies them through host memory; NCCL on a
machine with one card per rank). GSPMD placement (`leaf_spec`,
`state_shardings`, `place_state`, `constrain_state`) has no counterpart:
a process holds only its own block, so there is nothing to place. Not
ported yet (ROADMAP A11): the sharded LSH index, the SDNC and the LM
memory layer on the mesh, streaming on the mesh, 2D data axes and
checkpoint layouts.

Activation, in each rank after `torch.distributed.init_process_group`::

    with mem_shard.memory_mesh(num_slots=N):
        state = sam.init_state(B, cfg)      # this rank's block
        state, ys = sam.sam_unroll(params, cfg, state, xs)
        # or a train step: training.make_task_train_step(spec)[2](...)
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.types import LA_SCRATCH, SCRATCH_ROWS
from repro_torch.kernels import ops, ref


# --------------------------------------------------------------------------
# Context
# --------------------------------------------------------------------------

class Collectives:
    """What this rank sent through a context's two collectives: bytes and
    calls by op, and the host seconds spent in them (waits for the kernels queued
    before them included: a collective reads their results). `reset`
    before a measured window."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = {"all_gather": 0, "psum": 0}
        self.calls = {"all_gather": 0, "psum": 0}
        self.seconds = 0.0

    def _count(self, op: str, x: torch.Tensor, t0: float) -> None:
        self.bytes[op] += x.numel() * x.element_size()
        self.calls[op] += 1
        self.seconds += time.perf_counter() - t0


@dataclasses.dataclass(frozen=True)
class MemShardCtx:
    """N logical slots split into `shards` contiguous blocks over the ranks
    of `group`; this process is `rank` and holds block `rank`."""

    group: object                  # a torch.distributed process group
    rank: int
    shards: int
    num_slots: int
    collectives: Collectives = dataclasses.field(
        default_factory=Collectives, compare=False)

    @property
    def local_n(self) -> int:
        return self.num_slots // self.shards

    @property
    def local_rows(self) -> int:
        """Row count of a block: its logical rows and its scratch row."""
        return self.local_n + SCRATCH_ROWS

    @property
    def first(self) -> int:
        """Global index of the block's first row."""
        return self.rank * self.local_n


class _Ctx(threading.local):
    def __init__(self):
        self.ctx: Optional[MemShardCtx] = None


_CTX = _Ctx()


@contextlib.contextmanager
def memory_mesh(num_slots: int, group=None):
    """Shard a memory of `num_slots` slots over the ranks of ``group``
    (default: the whole world): shards = its size, and this process holds
    block `rank`. Raises when the slots do not split into equal blocks."""
    group = dist.group.WORLD if group is None else group
    shards, rank = dist.get_world_size(group), dist.get_rank(group)
    if num_slots % shards:
        raise ValueError(
            f"num_slots={num_slots} not divisible by the {shards} ranks of "
            f"the group: slot sharding needs equal blocks")
    with activated(MemShardCtx(group=group, rank=rank, shards=shards,
                               num_slots=num_slots)) as ctx:
        yield ctx


def current() -> Optional[MemShardCtx]:
    """The context active in this thread, or None."""
    return _CTX.ctx


@contextlib.contextmanager
def activated(ctx: Optional[MemShardCtx]):
    """Make ``ctx`` (a context `current` returned, or None) the active one
    in this thread for the block. Autograd runs a CUDA graph's backward on
    a device thread of its own, where the caller's thread-local context is
    not set: a backward that routes by layout activates the context its
    forward ran under."""
    old = _CTX.ctx
    _CTX.ctx = ctx
    try:
        yield ctx
    finally:
        _CTX.ctx = old


def init_layout(num_slots: int):
    """(slots, first) of the buffers a fresh state holds in this process:
    this rank's block (local_n, first) under a context that shards a
    memory of this size, else the whole memory (num_slots, 0). The caller
    builds the block's buffers directly, so no process ever holds the
    whole memory (the JAX package builds the whole sharded buffer and
    places it)."""
    ctx = _CTX.ctx
    if ctx is not None and ctx.shards > 1 and ctx.num_slots == num_slots:
        return ctx.local_n, ctx.first
    return num_slots, 0


def memory_layout(num_slots: int, buf_rows: int) -> Optional[MemShardCtx]:
    """Classify a buffer of `buf_rows` rows of a memory of `num_slots`
    slots: the active context, iff the buffer is one of its blocks and
    there is more than one (one shard is the canonical layout), or None
    for a whole memory (swept with valid_n = N). Both the slot count and
    the row count must match: a block has local_n + 1 rows, which is also
    the canonical size of a local_n-slot memory. Raises on any other row
    count: a block used outside its `memory_mesh` context must fail
    loudly, not pass for a small memory."""
    ctx = _CTX.ctx
    if (ctx is not None and ctx.shards > 1 and ctx.num_slots == num_slots
            and buf_rows == ctx.local_rows):
        return ctx
    if buf_rows == num_slots + SCRATCH_ROWS:
        return None
    raise ValueError(
        f"memory buffer with {buf_rows} rows matches no known layout for "
        f"num_slots={num_slots}: expected {num_slots + SCRATCH_ROWS} (the "
        f"(B, N+1, W) scratch-row layout), or one rank's block of "
        f"N/shards + 1 rows under an active mem_shard.memory_mesh("
        f"{num_slots}) context")


# --------------------------------------------------------------------------
# Layouts: canonical (B, N+1, ...), sharded (B, N+S, ...), one block
# --------------------------------------------------------------------------

def _fill_value(dtype) -> int:
    """Scratch-row fill: `LA_SCRATCH` for int32 (and wider) usage tables,
    0 for everything else (int8 memory rows are integers too, and
    LA_SCRATCH does not fit in them)."""
    integer = not (dtype.is_floating_point or dtype.is_complex
                   or dtype == torch.bool)
    return LA_SCRATCH if integer and dtype.itemsize >= 4 else 0


def from_shard_layout(x: torch.Tensor, num_slots: int,
                      shards: int) -> torch.Tensor:
    """A buffer in the JAX package's (B, N+S, ...) sharded layout (S
    blocks of N/S logical rows, each followed by its scratch row) back in
    the canonical (B, N+1, ...) layout, the scratch row freshly filled."""
    B, tail = x.shape[0], tuple(x.shape[2:])
    blocks = x.reshape((B, shards, num_slots // shards + SCRATCH_ROWS)
                       + tail)
    logical = blocks[:, :, :num_slots // shards].reshape((B, num_slots)
                                                         + tail)
    fill = x.new_full((B, SCRATCH_ROWS) + tail, _fill_value(x.dtype))
    return torch.cat([logical, fill], 1)


def shard_block(x: torch.Tensor, num_slots: int, shards: int,
                rank: int) -> torch.Tensor:
    """Block `rank` of the (B, N+S, ...) sharded layout of a canonical
    buffer (the JAX package's `to_shard_layout`), cut without building the
    others: (B, N/S + 1, ...), its scratch row freshly filled."""
    n = num_slots // shards
    rows = x[:, rank * n:(rank + 1) * n]
    fill = x.new_full((x.shape[0], SCRATCH_ROWS) + tuple(x.shape[2:]),
                      _fill_value(x.dtype))
    return torch.cat([rows, fill], 1)


def gather_blocks(ctx: MemShardCtx, x: torch.Tensor) -> torch.Tensor:
    """Every rank's block of a slot leaf, gathered into the canonical
    (B, N+1, ...) layout on every rank. O(N) traffic: for checks and
    tests, never on a step's path."""
    g = all_gather(ctx, x)                           # (S, B, local_rows, ...)
    sharded = g.movedim(0, 1).reshape(
        (x.shape[0], ctx.shards * ctx.local_rows) + tuple(x.shape[2:]))
    return from_shard_layout(sharded, ctx.num_slots, ctx.shards)


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

def all_gather(ctx: MemShardCtx, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x``, stacked in rank order: (S, *x.shape)."""
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.shards)]
    dist.all_gather(parts, x, group=ctx.group)
    out = torch.stack(parts)
    ctx.collectives._count("all_gather", x, t0)
    return out


def psum(ctx: MemShardCtx, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``, on every rank."""
    t0 = time.perf_counter()
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
    ctx.collectives._count("psum", out, t0)
    return out


def _concat_shards(ctx: MemShardCtx, x: torch.Tensor) -> torch.Tensor:
    """All-gather a (..., K) per-rank tensor into (..., S·K), shard-major:
    position order is (rank, local rank) order, which is global-index order
    among ties (each rank owns an ascending block and ranks its ties by
    ascending index)."""
    g = all_gather(ctx, x).movedim(0, -2)           # (..., S, K)
    return g.reshape(tuple(g.shape[:-2]) + (g.shape[-2] * g.shape[-1],))


def _own_local(ctx: MemShardCtx, idx: torch.Tensor):
    """(owned mask, local index) of global indices on this rank; an index
    another rank owns maps to the block's scratch row."""
    own = torch.div(idx, ctx.local_n, rounding_mode="floor") == ctx.rank
    return own, torch.where(own, idx - ctx.first, ctx.local_n).to(idx.dtype)


# --------------------------------------------------------------------------
# The sharded ops
# --------------------------------------------------------------------------

def _masked(own: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``rows`` (B, J, ...) where ``own`` (B, J) holds, zeros (in the rows'
    dtype: int8 codes mask and sum as int8) elsewhere."""
    own = own.view(tuple(own.shape) + (1,) * (rows.dim() - own.dim()))
    return torch.where(own, rows, torch.zeros_like(rows))


def topk_read_sharded(ctx: MemShardCtx, q: torch.Tensor, mem: torch.Tensor,
                      k: int, *, mem_scale=None):
    """`ops.topk_read` over the whole memory: this rank's top-K over its
    block (f32, bf16, or int8 rows with their scales ``mem_scale``, ranked
    as the single-device read ranks them), then a (B, H, K) score and
    index all-gather and the merge. Returns (vals, idx) (B, H, K), idx
    global, the same on every rank and equal to the single-device
    selection, ties included."""
    if k > ctx.local_n:
        raise ValueError(f"a top-{k} read needs K <= N/shards = "
                         f"{ctx.local_n} rows per shard")
    vals, lidx = ops.topk_read(q, mem, k, valid_n=ctx.local_n,
                               mem_scale=mem_scale)
    av = _concat_shards(ctx, vals)                   # (B, H, S·K)
    ai = _concat_shards(ctx, lidx + ctx.first)
    mvals, pos = torch.sort(av, dim=-1, descending=True, stable=True)
    return mvals[..., :k], torch.gather(ai, -1, pos[..., :k])


def lra_topn_sharded(ctx: MemShardCtx, la: torch.Tensor, n: int):
    """`ops.lra_topn` over the whole usage table: this rank's n least
    recently accessed rows of its block, then an all-gather of their
    staleness and index and the merge by (staleness asc, index asc).
    Returns (B, n) global indices, the same on every rank."""
    if n > ctx.local_n:
        raise ValueError(f"an LRA top-{n} needs n <= N/shards = "
                         f"{ctx.local_n} rows per shard")
    lidx = ops.lra_topn(la, n, valid_n=ctx.local_n)
    av = _concat_shards(ctx, torch.gather(la, 1, lidx.long()))   # (B, S·n)
    ai = _concat_shards(ctx, lidx + ctx.first)
    _, pos = torch.sort(av, dim=-1, stable=True)
    return torch.gather(ai, -1, pos[..., :n])


def owned_rows(ctx: MemShardCtx, mem: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """The rows of this rank's block (B, rows, ...) that global indices
    idx (B, J) name and this rank owns, zeros for the others: (B, J, ...),
    with no collective."""
    own, lidx = _own_local(ctx, idx)
    return _masked(own, ref.gather_rows(mem, lidx))


class _GatherRows(torch.autograd.Function):
    """`gather_rows_sharded` while autograd records: the backward of the
    owned-rows sum is the identity on the rows this rank owns. The
    replicated cotangent (B, J, ...) is added into a zero gradient of the
    block at the rows this rank owns, in j order, with no collective: a
    collective there would count it once a rank."""

    @staticmethod
    def forward(ctx, mem, idx, shard):
        ctx.idx, ctx.shard = idx, shard
        ctx.shape, ctx.dtype = mem.shape, mem.dtype
        return psum(shard, owned_rows(shard, mem, idx))

    @staticmethod
    def backward(ctx, g):
        g_mem = g.new_zeros(ctx.shape, dtype=ctx.dtype)
        scatter_rows_sharded(ctx.shard, g_mem, ctx.idx, g, "add")
        return g_mem, None, None


def gather_rows_sharded(ctx: MemShardCtx, mem: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """The rows that global indices idx (B, J) name, (B, J, ...), on every
    rank: each rank gathers the rows it owns, zeros for the others, and a
    sum over ranks assembles them (O(B·J·W), independent of N), in the
    rows' dtype (f32, bf16, int8 codes, or the f32 scales of a (B, rows)
    table: one rank owns each row, so an int8 sum cannot overflow).
    Differentiable in ``mem`` (`_GatherRows`)."""
    if torch.is_grad_enabled() and mem.requires_grad:
        return _GatherRows.apply(mem, idx, ctx)
    return psum(ctx, owned_rows(ctx, mem, idx))


def winners_sharded(ctx: MemShardCtx, ct: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """`ops.winners` of a rank's cotangent block: the cotangent rows at
    global indices idx (B, J), gathered from their owners, each kept only
    at the last column naming its row."""
    last = ref.first_occurrence(idx.flip(1)).flip(1)
    return _masked(last, gather_rows_sharded(ctx, ct, idx))


def scatter_rows_sharded(ctx: MemShardCtx, mem: torch.Tensor,
                         idx: torch.Tensor, rows: torch.Tensor, mode: str, *,
                         mem_scale=None, rows_scale=None):
    """`ops.scatter_rows` ('add' or 'set') of replicated (index, row) pairs
    into this rank's block (B, rows, ...), in place, with no collective:
    each rank applies the pairs it owns in j order; the others' rows (and
    scales) are zeroed and go to the scratch row, so the scratch row of a
    memory or of a cotangent stays zero. On int8 rows (``mem_scale``) the
    owned (codes, scale) pairs of ``rows`` and ``rows_scale`` are 'set'.
    Returns ``mem``, or (mem, mem_scale)."""
    own, lidx = _own_local(ctx, idx)
    rows = _masked(own, rows)
    if mem_scale is not None:
        return ops.scatter_rows(
            mem, lidx, rows, mode, mem_scale=mem_scale,
            rows_scale=None if rows_scale is None else _masked(own,
                                                               rows_scale))
    if mem.dim() == 2:
        ops.scatter_rows(mem[..., None], lidx, rows[..., None], mode)
        return mem
    return ops.scatter_rows(mem, lidx, rows, mode)


def _local_write(ctx, write_idx, write_w, lra_idx):
    """The write's columns as this rank's block takes them: (local write
    indices, weights zeroed where another rank owns the row, local LRA
    rows), every index another rank owns sent to the scratch row."""
    own_w, l_widx = _own_local(ctx, write_idx)
    _, l_lra = _own_local(ctx, lra_idx)
    return l_widx, torch.where(own_w, write_w, 0.0), l_lra


class _Write(torch.autograd.Function):
    """The sharded write of f32 or bf16 rows while autograd records (the
    naive unroll), in place on the block. Its backward gathers the output
    gradient's rows at the written rows from their owners (the cotangent
    of the replicated w and a, O(J·W) a step), hands w and a the
    single-device write's gradients of them, and zeroes this rank's
    erased rows of the block's gradient."""

    @staticmethod
    def forward(ctx, mem, write_w, a, la, write_idx, lra_idx, step, delta,
                shard):
        l_widx, l_ww, l_lra = _local_write(shard, write_idx, write_w,
                                           lra_idx)
        ops.sparse_write_update(mem, la, l_widx, l_ww, a, l_lra, step,
                                delta=delta)
        ctx.mark_dirty(mem)
        ctx.save_for_backward(write_idx, write_w, a, lra_idx)
        ctx.shard = shard
        return mem

    @staticmethod
    def backward(ctx, g):
        write_idx, write_w, a, lra_idx = ctx.saved_tensors
        g_w, g_a = ops.write_rows_vjp(
            gather_rows_sharded(ctx.shard, g, write_idx).to(torch.float32),
            write_w, a)
        g_mem = scatter_rows_sharded(ctx.shard, g.clone(), lra_idx,
                                     g.new_zeros(a.shape), "set")
        return g_mem, g_w, g_a, None, None, None, None, None, None


class _WriteQ(torch.autograd.Function):
    """The sharded write of int8 rows while autograd records, in place on
    the block's codes, usage table and scales; only the scales' output is
    differentiable. It records the touched rows' old codes and scales as
    every rank sees them (gathered from their owners); its backward
    gathers the scales' cotangent at the written rows, hands w and a the
    single-device write's gradients (`ops.write_q_vjp`) and sets this
    rank's touched rows of the scales' gradient to their old scales'."""

    @staticmethod
    def forward(ctx, mem_scale, write_w, a, mem, la, write_idx, lra_idx,
                step, delta, shard):
        old_q = gather_rows_sharded(shard, mem, write_idx)
        old_s = gather_rows_sharded(shard, mem_scale, write_idx)
        l_widx, l_ww, l_lra = _local_write(shard, write_idx, write_w,
                                           lra_idx)
        ops.sparse_write_update(mem, la, l_widx, l_ww, a, l_lra, step,
                                delta=delta, mem_scale=mem_scale)
        ctx.mark_dirty(mem_scale, mem, la)
        ctx.mark_non_differentiable(mem, la)
        ctx.save_for_backward(old_q, old_s, write_idx, lra_idx, write_w, a)
        ctx.shard = shard
        return mem, la, mem_scale

    @staticmethod
    def backward(ctx, _, __, g_scale):
        old_q, old_s, write_idx, lra_idx, write_w, a = ctx.saved_tensors
        g_old_s, g_w, g_a = ops.write_q_vjp(
            winners_sharded(ctx.shard, g_scale, write_idx), old_q, old_s,
            write_idx, lra_idx, write_w, a)
        g_s = scatter_rows_sharded(ctx.shard, g_scale.clone(), write_idx,
                                   g_old_s, "set")
        return (g_s, g_w, g_a) + (None,) * 7


def sparse_write_update_sharded(ctx: MemShardCtx, mem, la, write_idx,
                                write_w, a, lra_idx, step, *, delta: float,
                                mem_scale=None):
    """`ops.sparse_write_update` on this rank's block (f32, bf16, or int8
    rows with their scales ``mem_scale``, which this rank re-quantizes
    where it owns the row), with no collective in the forward: the
    columns and LRA rows this rank owns write and erase as on one device;
    the others go to the scratch row with weight 0, which the write leaves
    as it is. An owned row takes the same columns in the same j order as
    on one device. Returns (mem, la), or (mem, la, mem_scale), updated in
    place. While autograd records, `_Write` and `_WriteQ` run it."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (write_w, a, mem, mem_scale)):
        if mem_scale is not None:
            return _WriteQ.apply(mem_scale, write_w, a, mem, la, write_idx,
                                 lra_idx, step, delta, ctx)
        return _Write.apply(mem, write_w, a, la, write_idx, lra_idx, step,
                            delta, ctx), la
    l_widx, l_ww, l_lra = _local_write(ctx, write_idx, write_w, lra_idx)
    return ops.sparse_write_update(mem, la, l_widx, l_ww, a, l_lra, step,
                                   delta=delta, mem_scale=mem_scale)


def update_last_access_sharded(ctx: MemShardCtx, la, idx, w, step,
                               delta: float):
    """The read-side usage stamp on this rank's block, in place, with no
    collective: owned entries as on one device; the others stamp the
    scratch entry, where max(LA_SCRATCH, step) changes nothing."""
    _, lidx = _own_local(ctx, idx)
    ref.stamp_usage(la, lidx, w, step, delta)
    return la
