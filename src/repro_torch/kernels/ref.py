"""Plain PyTorch versions of the ported kernels, under the JAX oracle names.

They are what a CPU tensor runs (`kernels/ops.py` dispatches by device),
what the CPU tests hold against `repro.kernels.ref` and the Pallas
kernels, and what `chip_smoke.py` holds each CUDA kernel against on the
card. They state the kernels' contracts exactly:

* Ties are the normal case (a zero memory gives every row similarity 0),
  and `torch.topk` promises no tie order. The top-K read sorts stably
  (value descending, then lowest index) and the LRA selection ranks a
  unique int64 key ``(value << 32) | index`` — `lax.top_k`'s rule.
* Duplicate rows of a write or an 'add' scatter accumulate in j order,
  starting from the row's old value (or zero, if erased), the same order
  as the TPU write kernel and the CUDA kernels;
  `index_put_(accumulate=True)` would sum in an unspecified order on CUDA.
  The replay of a write (erase, then 'add') therefore gives the fused
  write's floats bit for bit.
* The write and the scatter update their buffers in place and never
  touch a row that no index names (in particular not scratch row N).
"""
from __future__ import annotations

import torch

_EPS = 1e-6   # inside the rsqrt, not added to the norm
_NEG = -1e9   # the score of an invalid selection


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + _EPS)


def topk_read_ref(q: torch.Tensor, mem: torch.Tensor, k: int):
    """q: (B, H, W), mem: (B, N, W) -> (vals (B,H,K), idx (B,H,K) int32):
    the K rows of highest cosine similarity, ordered by (sim desc,
    index asc)."""
    sims = torch.einsum("bhw,bnw->bhn", _normalize(q), _normalize(mem))
    vals, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def gather_rows(mem: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mem: (B, R, W), idx: (B, ...) int with every index in [0, R) -> the
    rows idx names, (B, ..., W). The index is not checked (this runs on the
    card's main path, where a check would wait on the device): a signed
    selection is clamped by its caller first. Python's wrap-around would
    read a -1 as row R-1, the scratch row of a (B, N+1, W) buffer."""
    b = torch.arange(mem.shape[0], device=mem.device)
    b = b.view((-1,) + (1,) * (idx.dim() - 1))
    return mem[b, idx.long()]


def read_tail_rows(q: torch.Tensor, words: torch.Tensor, beta: torch.Tensor,
                   valid: torch.Tensor):
    """The read after selection, on the K gathered rows: re-rank them by
    cosine similarity times ``beta``, softmax, zero the invalid entries and
    renormalise as `addressing.finish_candidate_read` does, and take the
    weighted sum. q: (B,H,W), words: (B,H,K,W), beta: (B,H), valid:
    (B,H,K) bool -> (read (B,H,W), weights (B,H,K))."""
    sel = torch.einsum("bhw,bhkw->bhk", _normalize(q), _normalize(words))
    sel = torch.where(valid, sel * beta[..., None], _NEG)
    w = torch.where(valid, torch.softmax(sel, dim=-1), 0.0)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-6)
    read = torch.einsum("bhk,bhkw->bhw", w, words)
    return read, w


def sparse_read_tail(q: torch.Tensor, mem: torch.Tensor, beta: torch.Tensor,
                     idx: torch.Tensor):
    """`read_tail_rows` on the rows ``idx`` names. idx: (B,H,K) *signed*:
    -1 marks an invalid selection, gathered as row 0 with weight exactly 0.
    q: (B,H,W), mem: (B,N,W), beta: (B,H) -> (read (B,H,W), weights
    (B,H,K))."""
    valid = idx >= 0
    words = gather_rows(mem, idx.clamp_min(0))               # (B,H,K,W)
    return read_tail_rows(q, words, beta, valid)


def dedup(idx: torch.Tensor) -> torch.Tensor:
    """Mask repeated candidate ids with -1 along the last axis: the first
    occurrence in position order stays, every later one becomes -1 (and a
    -1 stays -1). The port of `repro/core/addressing.py::_dedup`: a stable
    sort puts equal ids in position order, and an id is a repeat when its
    sorted neighbour to the left is equal."""
    s, order = torch.sort(idx, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(s, dtype=torch.bool)
    dup_sorted[..., 1:] = s[..., 1:] == s[..., :-1]
    dup = torch.empty_like(dup_sorted).scatter_(-1, order, dup_sorted)
    return torch.where(dup, torch.full_like(idx, -1), idx)


def candidate_topk(q: torch.Tensor, mem: torch.Tensor, k: int,
                   cand_idx: torch.Tensor) -> torch.Tensor:
    """The selection of the ANN read on a *pre-deduped* signed candidate
    set cand_idx (B, H, C), -1 = invalid: re-rank the candidates by cosine
    similarity (an invalid one at -1e9, so it is kept only when fewer than
    K are valid) and keep the top K by (similarity desc, position asc).
    Returns the signed indices (B, H, K) int32."""
    cand = gather_rows(mem, cand_idx.clamp_min(0))             # (B,H,C,W)
    sims = torch.einsum("bhw,bhcw->bhc", _normalize(q), _normalize(cand))
    sims = torch.where(cand_idx < 0, _NEG, sims)
    _, pos = torch.sort(sims, dim=-1, descending=True, stable=True)
    return torch.gather(cand_idx, -1, pos[..., :k]).to(torch.int32)


def fused_read_candidates_ref(q: torch.Tensor, mem: torch.Tensor,
                              beta: torch.Tensor, k: int,
                              cand_idx: torch.Tensor):
    """The ANN read: `candidate_topk`, then `sparse_read_tail`. Returns
    (read (B,H,W), weights (B,H,K), signed indices (B,H,K) int32); an
    invalid selection has weight exactly 0."""
    idx = candidate_topk(q.detach(), mem.detach(), k, cand_idx)
    read, w = sparse_read_tail(q, mem, beta, idx)
    return read, w, idx


def lsh_hash_ref(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """x: (..., W), planes: (T, bits, W) -> bucket ids (..., T) int32: bit
    i of table t is set where the projection on plane (t, i) is > 0 (a
    zero row gives 0), packed little-endian."""
    proj = torch.einsum("...w,tbw->...tb", x, planes)
    bits = (proj > 0).to(torch.int32)
    weights = 2 ** torch.arange(planes.shape[1], dtype=torch.int32,
                                device=x.device)
    return (bits * weights).sum(-1, dtype=torch.int32)


def fused_read_ref(q: torch.Tensor, mem: torch.Tensor, beta: torch.Tensor,
                   k: int, valid_n=None):
    """The exact read: top-K over rows [0, valid_n) of the (B, N+1, W)
    buffer, then `sparse_read_tail`. Returns (read (B,H,W), weights
    (B,H,K), indices (B,H,K) int32)."""
    mv = mem if valid_n is None else mem[:, :valid_n]
    _, idx = topk_read_ref(q, mv, k)
    read, w = sparse_read_tail(q, mem, beta, idx)
    return read, w, idx


def lra_topn_ref(last_access: torch.Tensor, n: int) -> torch.Tensor:
    """last_access: (B, N) int -> (B, n) int32 indices of the n smallest
    entries, ascending by (value, index)."""
    N = last_access.shape[1]
    key = (last_access.to(torch.int64) * (1 << 32)
           + torch.arange(N, device=last_access.device))
    return torch.topk(key, n, dim=-1, largest=False).indices.to(torch.int32)


def first_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """(B, J) bool: True where idx[b, j] is the first occurrence of its
    value along j — the column that owns the row in the fused write."""
    eq = idx[:, :, None] == idx[:, None, :]                   # (B, J, J)
    J = idx.shape[-1]
    return eq.to(torch.int8).argmax(-1) == torch.arange(J, device=idx.device)


def _lane_step(step, batch: int, device) -> torch.Tensor:
    """The usage-stamp step as a (B,) int32 tensor: a () step is
    broadcast, a (B,)/(B, 1) per-lane step is flattened."""
    step = torch.as_tensor(step, dtype=torch.int32, device=device)
    if step.dim() == 0:
        return step.expand(batch)
    flat = step.reshape(-1)
    if flat.shape[0] != batch:
        raise ValueError(f"per-lane step must have one entry per batch row: "
                         f"got shape {tuple(step.shape)} for batch {batch}")
    return flat


def scatter_rows_ref(mem: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                     mode: str = "add") -> torch.Tensor:
    """mem: (B, R, W), idx: (B, J) int with every index in [0, R), rows:
    (B, J, W), in place. 'add': each target row takes its old value plus
    every column naming it, summed in j order (written once, by the first
    such column). 'set': each target row takes its last column's row.
    Rows no index names are not touched. Returns ``mem``. Raises on an
    index outside [0, R), which the CUDA kernel would skip."""
    B, J = idx.shape
    i = idx.long()
    if ((i < 0) | (i >= mem.shape[1])).any():
        raise ValueError(f"scatter_rows: an index lies outside [0, "
                         f"{mem.shape[1]})")
    b = torch.arange(B, device=mem.device)[:, None].expand(B, J)
    if mode == "add":
        eq = i[:, :, None] == i[:, None, :]                   # (B, J, J)
        acc = mem[b, i]                                       # (B, J, W)
        for j in range(J):
            acc = torch.where(eq[:, :, j, None], acc + rows[:, j:j + 1], acc)
        own = first_occurrence(i)
    elif mode == "set":
        acc = rows
        own = first_occurrence(i.flip(1)).flip(1)             # last occurrence
    else:
        raise ValueError(f"scatter_rows: unknown mode {mode!r}")
    mem[b[own], i[own]] = acc[own].to(mem.dtype)
    return mem


def write_rows(write_w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The rows the SAM write adds: w_j · a_{j // (K+1)}. write_w: (B, J),
    a: (B, H, W) -> (B, J, W)."""
    kp1 = write_w.shape[1] // a.shape[1]
    return write_w[..., None] * a.repeat_interleave(kp1, dim=1)


def sparse_write_update_ref(mem: torch.Tensor, last_access: torch.Tensor,
                            write_idx: torch.Tensor, write_w: torch.Tensor,
                            a: torch.Tensor, lra_idx: torch.Tensor, step,
                            delta: float):
    """The fused SAM write, in place on ``mem`` (B, N+1, W) and
    ``last_access`` (B, N+1):

      1. mem[b, lra_idx] = 0                      (R_t erase, eq. 6)
      2. mem[b, write_idx] += write_w · a          (A_t, eqs. 3/5; column j
                                                    writes head j // (K+1))
      3. last_access[b, i] = max(last_access, step[b]) wherever a column
                                                    with weight > δ hits i

    Steps 1 and 2 are `scatter_rows_ref` 'set' of zeros and 'add' of
    `write_rows`: each touched row takes its sum in j order. Returns (mem,
    last_access)."""
    B, H, W = a.shape
    J = write_idx.shape[1]
    scatter_rows_ref(mem, lra_idx, mem.new_zeros((B, H, W)), "set")
    scatter_rows_ref(mem, write_idx, write_rows(write_w, a), "add")
    widx = write_idx.long()
    b = torch.arange(B, device=mem.device)[:, None]
    stamp = _lane_step(step, B, mem.device)[:, None].expand(B, J)
    upd = torch.where(write_w > delta, stamp, last_access[b, widx])
    last_access.scatter_reduce_(1, widx, upd, "amax", include_self=True)
    return mem, last_access
