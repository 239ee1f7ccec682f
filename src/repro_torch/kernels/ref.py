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
* Storage dtypes: the reads take f32, bf16 or int8 rows. A bf16 row is
  upcast, an int8 row is dequantized (``float(q) · scale``, its scale
  from ``mem_scale`` (B, rows)) **before** the norm, so the ranking sees
  what the JAX oracles see (`_deq_view`). The bf16 write rounds each
  column's w·a to bf16 once and adds it into the bf16 row in j order,
  the JAX oracle's rounding; the int8 write adds a row's columns into
  its dequantized row in j order, each as one fused multiply-add, and
  re-quantizes the row once (`sparse_write_update_q_ref`). The row
  scatter casts its rows to the memory's dtype (bf16 'add' rounds after
  each add); on int8 rows (`scatter_rows_q_ref`) 'set' restores recorded
  (row, scale) pairs bit for bit and 'add' re-quantizes each row once.
* Attention (`flash_attention_ref`) is the naive masked softmax in f32
  (f64 for f64 inputs, an exact reference on the card), the oracle of the
  JAX suite's flash-attention tests, with `chunked_attention`'s sliding
  window and prefix-LM. It takes one block of query rows at a time
  against the keys the block can see, so it never holds the whole (B, H,
  S, S).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import dequantize_rows, quantize_rows

_EPS = 1e-6   # inside the rsqrt, not added to the norm
_NEG = -1e9   # the score of an invalid selection


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + _EPS)


def topk_read_ref(q: torch.Tensor, mem: torch.Tensor, k: int,
                  valid_n: int | None = None, mem_scale=None):
    """q: (B, H, W), mem: (B, rows, W) f32, bf16, or int8 with its scales
    ``mem_scale`` (B, rows) -> (vals (B,H,K), idx (B,H,K) int32): the K
    rows among [0, valid_n) (default: all) of highest cosine similarity on
    their f32 view (`_deq_view`: bf16 rows upcast, int8 rows dequantized
    before the norm, as `fused_read_ref` ranks them), ordered by (sim
    desc, index asc)."""
    mv = mem if valid_n is None else mem[:, :valid_n]
    sv = None if mem_scale is None else mem_scale[:, :mv.shape[1]]
    sims = torch.einsum("bhw,bnw->bhn", _normalize(q),
                        _normalize(_deq_view(mv, sv)))
    vals, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _deq_view(mem: torch.Tensor, mem_scale=None) -> torch.Tensor:
    """f32 view of a memory buffer: an upcast of f32/bf16 rows, or the
    dequantized rows of an int8 buffer whose scales ``mem_scale`` gives."""
    if mem_scale is None:
        return mem.to(torch.float32)
    return dequantize_rows(mem, mem_scale)


def gather_rows(mem: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mem: (B, R, W), idx: (B, ...) int with every index in [0, R) -> the
    rows idx names, (B, ..., W). The index is not checked (this runs on the
    card's main path, where a check would wait on the device): a signed
    selection is clamped by its caller first. Python's wrap-around would
    read a -1 as row R-1, the scratch row of a (B, N+1, W) buffer."""
    b = torch.arange(mem.shape[0], device=mem.device)
    b = b.view((-1,) + (1,) * (idx.dim() - 1))
    return mem[b, idx.long()]


def gather_words(mem: torch.Tensor, idx: torch.Tensor,
                 mem_scale=None) -> torch.Tensor:
    """`gather_rows` as f32 words: bf16 rows upcast, int8 rows dequantized
    against their gathered scales. ``idx`` as for `gather_rows`."""
    rows = gather_rows(mem, idx)
    if mem_scale is None:
        return rows.to(torch.float32)
    scale = gather_rows(mem_scale[..., None], idx)[..., 0]
    return dequantize_rows(rows, scale)


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
                     idx: torch.Tensor, mem_scale=None):
    """`read_tail_rows` on the rows ``idx`` names. idx: (B,H,K) *signed*:
    -1 marks an invalid selection, gathered as row 0 with weight exactly 0.
    q: (B,H,W), mem: (B,N,W) (int8 rows with ``mem_scale`` (B,N)), beta:
    (B,H) -> (read (B,H,W), weights (B,H,K))."""
    valid = idx >= 0
    words = gather_words(mem, idx.clamp_min(0), mem_scale)   # (B,H,K,W)
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
                   cand_idx: torch.Tensor, mem_scale=None) -> torch.Tensor:
    """The selection of the ANN read on a *pre-deduped* signed candidate
    set cand_idx (B, H, C), -1 = invalid: re-rank the candidates by cosine
    similarity (an invalid one at -1e9, so it is kept only when fewer than
    K are valid) and keep the top K by (similarity desc, position asc).
    int8 rows are dequantized with the scale of their clamped id. Returns
    the signed indices (B, H, K) int32."""
    cand = gather_words(mem, cand_idx.clamp_min(0), mem_scale)  # (B,H,C,W)
    sims = torch.einsum("bhw,bhcw->bhc", _normalize(q), _normalize(cand))
    sims = torch.where(cand_idx < 0, _NEG, sims)
    _, pos = torch.sort(sims, dim=-1, descending=True, stable=True)
    return torch.gather(cand_idx, -1, pos[..., :k]).to(torch.int32)


def fused_read_candidates_ref(q: torch.Tensor, mem: torch.Tensor,
                              beta: torch.Tensor, k: int,
                              cand_idx: torch.Tensor, mem_scale=None):
    """The ANN read: `candidate_topk`, then `sparse_read_tail`. Returns
    (read (B,H,W), weights (B,H,K), signed indices (B,H,K) int32); an
    invalid selection has weight exactly 0."""
    idx = candidate_topk(q.detach(), mem.detach(), k, cand_idx, mem_scale)
    read, w = sparse_read_tail(q, mem, beta, idx, mem_scale)
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
                   k: int, valid_n=None, mem_scale=None):
    """The exact read: top-K over the f32 view (`_deq_view`) of rows
    [0, valid_n) of the (B, N+1, W) buffer, then `sparse_read_tail`.
    Returns (read (B,H,W), weights (B,H,K), indices (B,H,K) int32)."""
    _, idx = topk_read_ref(q, mem, k, valid_n, mem_scale)
    read, w = sparse_read_tail(q, mem, beta, idx, mem_scale)
    return read, w, idx


def lra_topn_ref(last_access: torch.Tensor, n: int) -> torch.Tensor:
    """last_access: (B, N) int -> (B, n) int32 indices of the n smallest
    entries, ascending by (value, index)."""
    N = last_access.shape[1]
    key = (last_access.to(torch.int64) * (1 << 32)
           + torch.arange(N, device=last_access.device))
    return torch.topk(key, n, dim=-1, largest=False).indices.to(torch.int32)


def usage_argmin_ref(usage: torch.Tensor) -> torch.Tensor:
    """usage: (B, N) f32 -> (B,) int32 index of each row's minimum; the
    lowest index wins ties (PyTorch documents `argmin` so), and -0.0
    equals +0.0."""
    return torch.argmin(usage, dim=-1).to(torch.int32)


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


def _check_rows(mem: torch.Tensor, i: torch.Tensor) -> None:
    if ((i < 0) | (i >= mem.shape[1])).any():
        raise ValueError(f"scatter_rows: an index lies outside [0, "
                         f"{mem.shape[1]})")


def scatter_rows_ref(mem: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                     mode: str = "add") -> torch.Tensor:
    """mem: (B, R, W) f32 or bf16, idx: (B, J) int with every index in
    [0, R), rows: (B, J, W), in place. The rows are first cast to the
    memory's dtype. 'add': each target row takes its old value plus every
    column naming it, summed in j order (written once, by the first such
    column); on bf16 rows each add rounds to bf16, as the JAX oracle's
    bf16 scatter-add does. 'set': each target row takes its last column's
    row. Rows no index names are not touched. Returns ``mem``. Raises on
    an index outside [0, R), which the CUDA kernel would skip."""
    B, J = idx.shape
    i = idx.long()
    _check_rows(mem, i)
    rows = rows.to(mem.dtype)
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
    `write_rows`: each touched row takes its sum in j order. ``mem`` is
    f32 or bf16; for bf16 rows each column's w·a is formed in f32 and
    rounded to bf16 once, and each add rounds to bf16 —
    ``row = bf16(row + bf16(w_j · a))`` in j order, the rounding of the
    JAX oracle's bf16 scatter-add. Returns (mem, last_access)."""
    B, H, W = a.shape
    scatter_rows_ref(mem, lra_idx, mem.new_zeros((B, H, W)), "set")
    scatter_rows_ref(mem, write_idx, write_rows(write_w, a).to(mem.dtype),
                     "add")
    stamp_usage(last_access, write_idx, write_w, step, delta)
    return mem, last_access


def stamp_usage(last_access, idx, w, step, delta) -> None:
    """The usage stamp U^(2), in place: max(la, step[b]) on every row that
    an entry of idx (B, J) with weight w (B, J) > δ names (the write's
    stamp and the read's, `addressing.update_last_access`)."""
    B, J = idx.shape
    i = idx.long()
    stamp = _lane_step(step, B, last_access.device)[:, None].expand(B, J)
    upd = torch.where(w > delta, stamp, torch.gather(last_access, 1, i))
    last_access.scatter_reduce_(1, i, upd, "amax", include_self=True)


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """f32 ``x·y + z`` rounded once, as CUDA's ``__fmaf_rn``: x·y is exact
    in f64, the f64 sum is rounded to odd (TwoSum finds whether it was
    exact), and the one rounding to f32 is then correct (53 >= 24 + 2)."""
    p = x.to(torch.float64) * y.to(torch.float64)
    zd = z.to(torch.float64)
    s = p + zd
    bb = s - p
    e = (p - (s - bb)) + (zd - bb)                           # s + e exact
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((e != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def sparse_write_update_q_ref(mem: torch.Tensor, mem_scale: torch.Tensor,
                              last_access: torch.Tensor,
                              write_idx: torch.Tensor, write_w: torch.Tensor,
                              a: torch.Tensor, lra_idx: torch.Tensor, step,
                              delta: float):
    """The fused SAM write on int8 rows, in place on ``mem`` (B, N+1, W)
    int8, ``mem_scale`` (B, N+1) f32 and ``last_access``: each touched row
    is dequantized (or zero, if erased), takes every column naming it,
    w_j · a_{j // (K+1)} added in j order, each as one fused multiply-add
    (`fma_f32`), and is re-quantized **once** (`quantize_rows`); the usage
    stamp as in `sparse_write_update_ref`. That is what JAX's
    ``_kernel_q`` computes as compiled (XLA contracts its ``acc + w·a``
    into an FMA); the JAX oracle sums a row's columns with an einsum and
    then adds them to the old row, so its scales may differ by a few ulp.
    Same precondition: every lra_idx row is in write_idx. Returns (mem,
    last_access, mem_scale)."""
    B, J = write_idx.shape
    i = write_idx.long()
    b = torch.arange(B, device=mem.device)[:, None].expand(B, J)
    erased = (i[:, :, None] == lra_idx.long()[:, None, :]).any(-1)
    acc = torch.where(erased[..., None], 0.0,
                      dequantize_rows(mem[b, i], mem_scale[b, i]))
    a_col = a.repeat_interleave(J // a.shape[1], dim=1)       # (B, J, W)
    eq = i[:, :, None] == i[:, None, :]                       # (B, J, J)
    for j in range(J):
        acc = torch.where(eq[:, :, j, None],
                          fma_f32(write_w[:, j, None, None],
                                  a_col[:, j:j + 1], acc), acc)
    new_q, new_s = quantize_rows(acc)
    own = first_occurrence(i)
    mem[b[own], i[own]] = new_q[own]
    mem_scale[b[own], i[own]] = new_s[own]
    stamp_usage(last_access, write_idx, write_w, step, delta)
    return mem, last_access, mem_scale


def scatter_rows_q_ref(mem: torch.Tensor, mem_scale: torch.Tensor,
                       idx: torch.Tensor, rows: torch.Tensor,
                       rows_scale=None, mode: str = "add"):
    """`scatter_rows_ref` on int8 rows with their (B, R) f32 scales, in
    place; untouched rows keep their bits. Returns (mem, mem_scale).

    * 'set' with int8 ``rows`` and their scales ``rows_scale`` (B, J): the
      recorded (row, scale) pairs restored bit for bit (the rollback), the
      last duplicate winning;
    * 'set' with float rows: each quantized once (`quantize_rows`), the
      last duplicate winning;
    * 'add': each target row dequantized, the sum of every column naming
      it added (``old + Σ rows``, the JAX oracle's einsum of duplicates
      and then the add, in f32) and re-quantized once."""
    B, J = idx.shape
    i = idx.long()
    _check_rows(mem, i)
    b = torch.arange(B, device=mem.device)[:, None].expand(B, J)
    if mode == "set":
        if rows.dtype == torch.int8:
            if rows_scale is None:
                raise ValueError("scatter_rows: int8 'set' rows need their "
                                 "recorded scales (rows_scale)")
            q, s = rows, rows_scale.to(mem_scale.dtype)
        else:
            q, s = quantize_rows(rows)
        own = first_occurrence(i.flip(1)).flip(1)             # last occurrence
    elif mode == "add":
        eq = (i[:, :, None] == i[:, None, :]).to(torch.float32)
        new = (dequantize_rows(mem[b, i], mem_scale[b, i])
               + torch.einsum("bjk,bkw->bjw", eq, rows.to(torch.float32)))
        q, s = quantize_rows(new)
        own = first_occurrence(i)
    else:
        raise ValueError(f"scatter_rows: unknown mode {mode!r}")
    mem[b[own], i[own]] = q[own]
    mem_scale[b[own], i[own]] = s[own]
    return mem, mem_scale


ATTN_Q_BLOCK = 256   # query rows a block of `flash_attention_ref`


def attn_keys(lo: int, hi: int, S: int, window: int | None,
              prefix: int = 0) -> tuple[int, int]:
    """The keys [k_lo, k_hi) a block of query rows [lo, hi) sees: from 0,
    or from the first within the window of row lo, to the block's end; a
    prefix P reaches every row, so the keys start at 0 and end at max(hi,
    min(P, S))."""
    if prefix:
        return 0, max(hi, min(prefix, S))
    return (0 if window is None else max(0, lo - window + 1)), hi


def attn_mask(lo: int, hi: int, k_lo: int, k_hi: int, window: int | None,
              prefix: int, device):
    """(hi - lo, k_hi - k_lo) bool: query lo + i sees key k_lo + j where
    0 <= (lo + i) - (k_lo + j) and, with a window, that gap < window; or
    where k_lo + j < prefix. JAX's (causal & window) | key < prefix
    (`repro/models/attention.py:143-150`)."""
    keys = torch.arange(k_lo, k_hi, device=device)
    gap = torch.arange(lo, hi, device=device)[:, None] - keys[None, :]
    mask = gap >= 0
    if window is not None:
        mask &= gap < window
    if prefix:
        mask |= keys[None, :] < prefix
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int | None = None,
                        prefix: int = 0) -> torch.Tensor:
    """Causal GQA attention, the plain version of `csrc/flash_attention.cu`
    and of `repro/kernels/flash_attention.py`. q: (B, S, H, D), k: (B, S,
    Hkv, D), v: (B, S, Hkv, DV), any DV (MLA's v is narrower than its q·k)
    -> o (B, S, H, DV) in q's dtype. Query head h reads kv head h // (H //
    Hkv); scores q·kᵀ·D^-0.5 are masked to -1e30 where
    pos_q < pos_k or, with ``window``, pos_q - pos_k >= window, unless
    pos_k < ``prefix`` (the prefix-LM's keys, seen by every query), and
    softmaxed, all in f32 (bf16 inputs upcast; f64 inputs stay f64). The
    query rows go ATTN_Q_BLOCK at a time, each block against only the keys
    of `attn_keys`."""
    B, S, H, D = q.shape
    Hkv, DV = k.shape[2], v.shape[-1]
    ct = torch.promote_types(q.dtype, torch.float32)
    kf, vf = k.to(ct), v.to(ct)
    out = torch.empty((B, S, H, DV), dtype=q.dtype, device=q.device)
    for lo in range(0, S, ATTN_Q_BLOCK):
        hi = min(lo + ATTN_Q_BLOCK, S)
        k_lo, k_hi = attn_keys(lo, hi, S, window, prefix)
        qg = q[:, lo:hi].to(ct).reshape(B, hi - lo, Hkv, H // Hkv, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, k_lo:k_hi]) \
            * D ** -0.5
        mask = attn_mask(lo, hi, k_lo, k_hi, window, prefix, q.device)
        p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
        del s
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf[:, k_lo:k_hi])
        out[:, lo:hi] = o.reshape(B, hi - lo, H, DV).to(q.dtype)
    return out
