"""Content-based addressing and usage tracking (paper §3.1-3.2), the port
of `repro/core/addressing.py`. The dense read (eq. 2) and DAM's
discounted usage for the dense models; the sparse reads, exact and LSH,
on f32, bf16 or int8 rows (``mem_scale=``: the (B, N+1) f32 per-row
scales of int8 rows). Every kernel operation goes through
`repro_torch.kernels.ops`, which runs the CUDA kernels on the card and the
plain versions on the CPU. `gather_rows` returns the raw storage bits;
the reads upcast or dequantize what they gather.

On a slot-sharded memory (`distributed/mem_shard.py`) the caller passes
``shard=``, the context of the block it holds (`mem_shard.memory_layout`
classifies the buffer), and the exact read, the LRA selection, the write,
the usage stamp and the row gather take their sharded counterparts,
which use global indices."""
from __future__ import annotations

import torch

from repro_torch.core.quant import dequantize_rows
from repro_torch.core.types import SparseRead
from repro_torch.distributed import mem_shard
from repro_torch.kernels import ops, ref


# Rows per chunk of the dense models' products over N. cuBLAS runs an
# (H, N) @ (N, W) product (a sum over N) as a batched GEMV on B blocks:
# the dense read took 30.9 of a DAM step's 41.2 ms of kernels at B = 8,
# N = 2^20, W = 32, H = 4 on an H100, and 0.50 ms as partial sums of 4096
# rows added afterwards (`chip_smoke.py`'s profile; PERF.md). Each product
# below therefore puts N's chunks in a batch dimension, in the forward
# and, through autograd, in the backward's sums over N.
READ_ROWS = 4096


def row_chunks(n: int) -> int:
    """The number of `READ_ROWS`-row chunks of n rows, or 1 (the whole
    product at once) where READ_ROWS does not divide n."""
    return n // READ_ROWS if n % READ_ROWS == 0 else 1


def cosine_sim(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """q: (B, H, W), m: (B, N, W) -> (B, H, N) cosine similarities, each
    side normalized as x·rsqrt(|x|² + 1e-6) (gradient-safe at 0)."""
    B, N, W = m.shape
    S = row_chunks(N)
    rows = ref._normalize(m).reshape(B, S, N // S, W).transpose(-1, -2)
    sims = torch.matmul(ref._normalize(q)[:, None], rows)    # (B, S, H, C)
    return sims.transpose(1, 2).reshape(B, -1, N)


def dense_read_weights(q: torch.Tensor, m: torch.Tensor,
                       beta: torch.Tensor) -> torch.Tensor:
    """Eq. (2): a softmax over every row's similarity, sharpened by the key
    strength beta (B, H) -> (B, H, N)."""
    return torch.softmax(cosine_sim(q, m) * beta[..., None], dim=-1)


def dense_read(w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Eq. (1): r = sum_i w(i) M(i). w: (B, H, N), m: (B, N, W) ->
    (B, H, W), summed over `READ_ROWS`-row chunks."""
    B, H, N = w.shape
    S = row_chunks(N)
    parts = torch.matmul(w.reshape(B, H, S, N // S).transpose(1, 2),
                         m.reshape(B, S, N // S, m.shape[-1]))  # (B,S,H,W)
    return parts.sum(1)


def outer_rows(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The dense write's add term w^T a: w (B, H, N), a (B, H, W) ->
    (B, N, W), sum_h w[b, h, n] a[b, h]; its gradient in a sums over
    `READ_ROWS`-row chunks."""
    B, H, N = w.shape
    S = row_chunks(N)
    out = torch.matmul(w.reshape(B, H, S, N // S).permute(0, 2, 3, 1),
                       a[:, None])                            # (B,S,C,W)
    return out.reshape(B, N, a.shape[-1])


def dam_usage_update(usage: torch.Tensor, read_w: torch.Tensor,
                     write_w: torch.Tensor, discount: float) -> torch.Tensor:
    """DAM's usage U^(1): the time-discounted sum of the read and write
    weights. usage: (B, N); read_w, write_w: (B, H, N)."""
    return discount * usage + read_w.sum(dim=1) + write_w.sum(dim=1)


def gather_rows(m: torch.Tensor, idx: torch.Tensor, *,
                shard=None) -> torch.Tensor:
    """m: (B, N, W), idx: (B, ...) -> the rows idx names, (B, ..., W)
    (`ref.gather_rows`); on a rank's block, ``shard`` given, the rows of
    global indices, assembled from the ranks that own them."""
    if shard is None:
        return ref.gather_rows(m, idx)
    B = m.shape[0]
    rows = mem_shard.gather_rows_sharded(shard, m, idx.reshape(B, -1))
    return rows.reshape(tuple(idx.shape) + (m.shape[-1],))


def gather_scales(mem_scale: torch.Tensor, idx: torch.Tensor, *,
                  shard=None) -> torch.Tensor:
    """mem_scale: (B, N), idx: (B, ...) -> (B, ...): the per-row scales of
    the rows idx names (int8 rows); on a rank's block, ``shard`` given, a
    width-1 row gather from the ranks that own them."""
    if shard is None:
        return gather_rows(mem_scale[..., None], idx)[..., 0]
    B = mem_scale.shape[0]
    return mem_shard.gather_rows_sharded(
        shard, mem_scale, idx.reshape(B, -1)).reshape(idx.shape)


def sparse_read_exact(q: torch.Tensor, m: torch.Tensor, beta: torch.Tensor,
                      k: int, *, valid_n: int | None = None, mem_scale=None,
                      shard=None) -> SparseRead:
    """'Linear index' SAM read: the exact K nearest rows by cosine
    similarity among rows [0, valid_n), softmax over the kept K only: one
    `ops.fused_read` call. On a rank's block (``shard``) the sweep and
    merge are `mem_shard.topk_read_sharded`, which ranks the block's rows
    as the single-device read ranks them (bf16 upcast, int8 dequantized),
    the K rows (and int8 rows' scales) come from the ranks that own them,
    and `read_from_rows` finishes the read on them as f32 words, with
    global indices."""
    if shard is not None:
        _, idx = mem_shard.topk_read_sharded(
            shard, q.detach(), m.detach(), k,
            mem_scale=None if mem_scale is None else mem_scale.detach())
        rows = gather_rows(m, idx, shard=shard)
        words = (rows.to(torch.float32) if mem_scale is None else
                 dequantize_rows(rows, gather_scales(mem_scale, idx,
                                                     shard=shard)))
        return read_from_rows(q, words, beta, idx)
    read, w, idx = ops.fused_read(q, m, beta, k, valid_n=valid_n,
                                  mem_scale=mem_scale)
    return SparseRead(indices=idx, weights=w, words=read)


def select_candidates(q: torch.Tensor, m: torch.Tensor, k: int,
                      cand_idx: torch.Tensor, *,
                      mem_scale=None) -> torch.Tensor:
    """The selection half of the ANN read: dedup the candidates (B, H, C),
    re-rank them without gradient and keep the K best. Returns *signed*
    indices (B, H, K) int32: -1 where fewer than K valid candidates
    existed."""
    return ref.candidate_topk(q.detach(), m.detach(), k,
                              ref.dedup(cand_idx), mem_scale)


def sparse_read_candidates(q: torch.Tensor, m: torch.Tensor,
                           beta: torch.Tensor, k: int, cand_idx: torch.Tensor,
                           *, mem_scale=None) -> SparseRead:
    """ANN read composed of its two halves: `select_candidates`, then
    `finish_candidate_read`. An invalid selection reads with weight exactly
    0 and gives no gradient."""
    sel = select_candidates(q, m, k, cand_idx, mem_scale=mem_scale)
    return finish_candidate_read(q, m, beta, sel, mem_scale=mem_scale)


def select_and_read_candidates(q: torch.Tensor, m: torch.Tensor,
                               beta: torch.Tensor, k: int,
                               cand_idx: torch.Tensor, *, mem_scale=None):
    """The ANN read as one kernel: dedup the raw candidates, then one
    `ops.fused_read(..., cand_idx=)` call re-ranks, selects, and runs the
    softmax tail and the weighted sum. Returns (the read, with its indices
    clamped to >= 0, and the *signed* (B, H, K) selection, which a step
    records so the replay rebuilds the same validity mask)."""
    read, w, sel = ops.fused_read(q, m, beta, k, cand_idx=ref.dedup(cand_idx),
                                  mem_scale=mem_scale)
    return SparseRead(indices=sel.clamp_min(0), weights=w, words=read), sel


def read_from_rows(q: torch.Tensor, words: torch.Tensor, beta: torch.Tensor,
                   idx: torch.Tensor) -> SparseRead:
    """The differentiable tail of a read on its gathered rows ``words``
    (B, H, K, W), selected by the *signed* ``idx`` (B, H, K): -1 marks an
    invalid selection, which gets weight exactly 0."""
    read, w = ref.read_tail_rows(q, words, beta, idx >= 0)
    return SparseRead(indices=idx.clamp_min(0), weights=w, words=read)


def finish_candidate_read(q: torch.Tensor, m: torch.Tensor, beta: torch.Tensor,
                          idx: torch.Tensor, *, mem_scale=None) -> SparseRead:
    """The differentiable tail of every sparse read, from recorded (signed)
    indices: gather the K rows, re-rank, softmax (`ref.sparse_read_tail`).
    Only those rows get a gradient. The replay (`core/cell.py`) runs the
    same tail on rows it gathers itself (`read_from_rows`)."""
    read, w = ref.sparse_read_tail(q, m, beta, idx, mem_scale)
    return SparseRead(indices=idx.clamp_min(0), weights=w, words=read)


def scatter_add_rows(m: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor, *, mem_scale=None, shard=None):
    """m[b, idx[b, j]] += rows[b, j], in place; duplicates sum in j order.
    idx: (B, J), rows: (B, J, W). With ``mem_scale`` (int8 rows) each
    touched row accumulates in f32 and re-quantizes once; returns (m,
    mem_scale). On a rank's block (``shard``) the rows it owns only."""
    if shard is not None:
        return mem_shard.scatter_rows_sharded(shard, m, idx, rows, "add",
                                              mem_scale=mem_scale)
    return ops.scatter_rows(m, idx, rows, "add", mem_scale=mem_scale)


def scatter_set_rows(m: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor, *, mem_scale=None, rows_scale=None,
                     shard=None):
    """m[b, idx[b, j]] = rows[b, j], in place; the last duplicate wins.
    With ``mem_scale`` (int8 rows) int8 ``rows`` and their scales
    ``rows_scale`` are restored bit for bit (the rollback); returns (m,
    mem_scale). On a rank's block (``shard``) the rows it owns only."""
    if shard is not None:
        return mem_shard.scatter_rows_sharded(shard, m, idx, rows, "set",
                                              mem_scale=mem_scale,
                                              rows_scale=rows_scale)
    return ops.scatter_rows(m, idx, rows, "set", mem_scale=mem_scale,
                            rows_scale=rows_scale)


def update_last_access(last_access: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor, step: torch.Tensor, delta: float, *,
                       shard=None) -> torch.Tensor:
    """Usage U^(2), in place: stamp `step` on the slots accessed with
    weight > δ. last_access: (B, N+1) int32; idx, w: (B, J)."""
    if shard is not None:
        return mem_shard.update_last_access_sharded(shard, last_access, idx,
                                                    w, step, delta)
    ref.stamp_usage(last_access, idx, w, step, delta)
    return last_access


def least_recently_accessed(last_access: torch.Tensor, n: int, *,
                            valid_n: int | None = None,
                            shard=None) -> torch.Tensor:
    """The n least-recently-accessed slots per batch row (B, n) int32
    (eq. 6; ties toward the lowest index)."""
    if shard is not None:
        return mem_shard.lra_topn_sharded(shard, last_access, n)
    return ops.lra_topn(last_access, n, valid_n=valid_n)


def sparse_write_update(memory, last_access, write_idx, write_w, a, lra_idx,
                        step, delta: float, *, mem_scale=None, shard=None):
    """The fused write side (eqs. 3/5/6 + the U^(2) stamp of written rows),
    in place on ``memory`` and ``last_access`` (and, for int8 rows, on
    their scales ``mem_scale``). Returns (memory, last_access), or
    (memory, last_access, mem_scale) with ``mem_scale``."""
    if shard is not None:
        return mem_shard.sparse_write_update_sharded(
            shard, memory, last_access, write_idx, write_w, a, lra_idx,
            step, delta=delta, mem_scale=mem_scale)
    return ops.sparse_write_update(memory, last_access, write_idx, write_w,
                                   a, lra_idx, step, delta=delta,
                                   mem_scale=mem_scale)
