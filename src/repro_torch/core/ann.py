"""The LSH approximate-nearest-neighbour index of the SAM read (paper §3.5),
the port of `repro/core/ann.py` for one device (P = 1 ownership
partitions, the canonical index).

    buckets: (B, T, 2**bits, 1, d) int32 — slot indices, -1 = empty
    cursor:  (B, T, 2**bits, 1) int32    — ring-insert position per bucket

Signatures come from fixed random hyperplanes (`lsh_planes`), which get no
gradient ("there are no gradients with respect to the ANN as its function
is fixed"): `lsh_hash` detaches both operands. Insert and query are
O(T · bucket_size) gathers and scatters, independent of N. The index is
carried in the state and kept in sync on every write.

`ann_insert` returns **new** tensors and leaves its input index as it was
(1 MiB per step at B = 8, T = 4, 2^8 buckets, d = 32). So a state that
holds an index keeps it, unlike the memory, which the cell updates in
place; the chunked unroll's boundary checkpoints (`core/unroll.py`) rely
on that to hold the index of their segment's start.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ANNState, MemoryConfig
from repro_torch.kernels import ops


def lsh_planes(generator: torch.Generator, cfg: MemoryConfig, *,
               device="cuda") -> torch.Tensor:
    """(T, bits, W) fixed random hyperplanes, standard normal, drawn on the
    generator's device and then moved, so a seed gives the same planes on
    every device."""
    shape = (cfg.lsh_tables, cfg.lsh_bits, cfg.word_size)
    return torch.randn(shape, generator=generator,
                       dtype=torch.float32).to(device)


def lsh_hash(planes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., W) -> bucket ids (..., T) int32: the sign bits of x's
    projections on each table's planes, packed per table. Both operands
    are detached: the hash is not differentiable."""
    return ops.lsh_hash(x.detach(), planes.detach())


def _require_one_partition(partitions: int) -> None:
    if partitions != 1:
        raise ValueError(f"partitions={partitions}: the port holds the "
                         f"single-device index (P = 1) only; the sharded "
                         f"index is not ported")


def index_partitions(state: ANNState) -> int:
    """Ownership-partition count P of an index (the cursor's last dim)."""
    return state.cursor.shape[-1]


def ann_init(batch: int, cfg: MemoryConfig, *, partitions: int = 1,
             device="cuda") -> ANNState:
    """An empty index: every bucket slot -1, every cursor 0."""
    _require_one_partition(partitions)
    nb = 2 ** cfg.lsh_bits
    return ANNState(
        buckets=torch.full((batch, cfg.lsh_tables, nb, 1,
                            cfg.lsh_bucket_size), -1, dtype=torch.int32,
                           device=device),
        cursor=torch.zeros((batch, cfg.lsh_tables, nb, 1), dtype=torch.int32,
                           device=device))


def ring_ranks(bucket_ids: torch.Tensor, group: torch.Tensor):
    """Per-entry insert rank and per-cell count for one batched insert.
    Entries that share a bucket (and an ownership group) are sequenced by
    their index order: entry j lands ``#{j' < j in the same cell}`` past
    the cursor, and the cursor advances by the cell's total.
    bucket_ids: (B, J, T); group: (B, J, J) bool -> (rank, count), each
    (B, J, T) int64."""
    same = ((bucket_ids[:, :, None, :] == bucket_ids[:, None, :, :])
            & group[..., None])                               # (B, J, J, T)
    J = bucket_ids.shape[1]
    ar = torch.arange(J, device=bucket_ids.device)
    before = ar[:, None] > ar[None, :]                        # j' < j
    rank = (same & before[None, :, :, None]).sum(2)
    count = same.sum(2)
    return rank, count


def ann_insert(planes: torch.Tensor, state: ANNState, idx: torch.Tensor,
               rows: torch.Tensor, cfg: MemoryConfig) -> ANNState:
    """Insert slots ``idx`` (B, J) with contents ``rows`` (B, J, W) into
    every table: ring overwrite within each bucket. Entries of one call
    that hash to one bucket are sequenced by rank, so one call equals J
    single-slot inserts while no bucket takes more than d entries in it.
    Returns a new index; ``state`` is left as it was."""
    _require_one_partition(index_partitions(state))
    B, J = idx.shape
    T = cfg.lsh_tables
    d = state.buckets.shape[-1]
    bucket_ids = lsh_hash(planes, rows).long()                # (B, J, T)
    b = torch.arange(B, device=idx.device)[:, None, None]
    t = torch.arange(T, device=idx.device)[None, None, :]
    rank, count = ring_ranks(
        bucket_ids, torch.ones((B, J, J), dtype=torch.bool, device=idx.device))
    cur = state.cursor[b, t, bucket_ids, 0]                   # (B, J, T)
    buckets = state.buckets.clone()
    buckets[b, t, bucket_ids, 0, (cur + rank) % d] = \
        idx[:, :, None].expand(B, J, T).to(torch.int32)
    # Entries of one bucket write the same cursor value.
    cursor = state.cursor.clone()
    cursor[b, t, bucket_ids, 0] = ((cur + count) % d).to(torch.int32)
    return ANNState(buckets=buckets, cursor=cursor)


def ann_query(planes: torch.Tensor, state: ANNState, q: torch.Tensor,
              cfg: MemoryConfig) -> torch.Tensor:
    """q: (B, H, W) -> the slots in q's buckets, (B, H, T·d) int32,
    table-major."""
    B, H, _ = q.shape
    bucket_ids = lsh_hash(planes, q).long()                   # (B, H, T)
    b = torch.arange(B, device=q.device)[:, None, None]
    t = torch.arange(cfg.lsh_tables, device=q.device)[None, None, :]
    cands = state.buckets[b, t, bucket_ids]                   # (B,H,T,P,d)
    return cands.movedim(3, 2).reshape(B, H, -1)


def ann_candidates(planes: torch.Tensor, state: ANNState, q: torch.Tensor,
                   extra_idx: torch.Tensor, cfg: MemoryConfig) -> torch.Tensor:
    """The full candidate set of an LSH read: the bucket candidates of
    `ann_query` followed by ``extra_idx`` (B, J), the freshly written rows,
    which the index does not hold yet -> (B, H, T·d + J) int32. For P = 1
    this is the JAX package's per-partition layout."""
    _require_one_partition(index_partitions(state))
    B, H, _ = q.shape
    extra = extra_idx.to(torch.int32)[:, None, :].expand(B, H, -1)
    return torch.cat([ann_query(planes, state, q, cfg), extra], dim=-1)


def ann_build(planes: torch.Tensor, memory: torch.Tensor,
              cfg: MemoryConfig) -> ANNState:
    """Rebuild the index from a full memory: the index that inserting the
    logical rows [0, N) one at a time, in slot order, into an empty index
    would give (the JAX `ann_build`, which inserts chunks of d rows in a
    `lax.scan`). A (B, N+1, W) buffer's scratch row is not indexed.

    In closed form: in each (b, table, bucket) the slots hashing there,
    in ascending order, take ordinals r = 0, 1, ...; slot r lands at ring
    position r mod d, so the largest r of each residue stays, and the
    cursor is the count mod d. One stable sort of the bucket ids finds
    the ordinals."""
    B, rows, _ = memory.shape
    N = cfg.num_slots if rows == cfg.num_slots + 1 else rows
    state = ann_init(B, cfg, device=memory.device)
    T, nb, d = cfg.lsh_tables, 2 ** cfg.lsh_bits, cfg.lsh_bucket_size
    ids = lsh_hash(planes, memory[:, :N]).transpose(1, 2).long()  # (B, T, N)
    bucket, slot = torch.sort(ids, dim=-1, stable=True)       # slot order
    count = torch.zeros((B, T, nb), dtype=torch.int64, device=memory.device)
    count.scatter_add_(-1, ids, torch.ones_like(ids))
    start = count.cumsum(-1) - count                          # (B, T, nb)
    pos = torch.arange(N, device=memory.device).expand(B, T, N)
    r = pos - torch.gather(start, -1, bucket)                 # ordinal
    last = r + d >= torch.gather(count, -1, bucket)           # stays in ring
    b = torch.arange(B, device=memory.device)[:, None, None].expand(B, T, N)
    t = torch.arange(T, device=memory.device)[None, :, None].expand(B, T, N)
    state.buckets[b[last], t[last], bucket[last], 0, (r % d)[last]] = \
        slot[last].to(torch.int32)
    state.cursor[..., 0] = (count % d).to(torch.int32)
    return state
