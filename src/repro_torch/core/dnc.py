"""The DNC and the sparse DNC (paper Supplementary D), the port of
`repro/core/dnc.py` on one device.

The DNC is the dense model of Graves et al. 2016: content addressing,
dynamic allocation and an N×N temporal link matrix read forward and
backward. Its step is written once, functionally, as in JAX: the same code
runs the forward (`DNC`, under `torch.inference_mode`) and records
autograd for training, which keeps every step's (B, N, N) link matrix.

The SDNC replaces the dense reads and writes with SAM's sparse scheme and
the link matrix with two row-sparse matrices N_t ≈ L_t and P_t ≈ L_tᵀ of
at most K_L entries a row (`SparseMat`, (B, N, K_L) columns and values,
-1 = empty). Its memory ops are the port's kernels, as in JAX: the least
recently accessed row (`lra_topn`, n = 1), the write as a 'set' of that
row and an 'add' of J = R·K + 1 rows (`scatter_rows` twice), the exact
read (`fused_read_sweep`) or, with ``MemoryConfig(ann="lsh")``, the LSH
candidates and their re-rank (`lsh_hash`, `fused_read_candidates`).
The SDNC takes f32 or bf16 rows (``mem_dtype``; bf16 rows are upcast
for the reads and the write's rows rounded to bf16, a bf16 memory's
gradient is bf16) and refuses int8 rows, as JAX does. It keeps the
scratch-row layout and updates its dense buffers **in place**: the memory, the usage table and N_t, P_t are the tensors of the
state handed to `dnc_step`. Row merges combine duplicate columns with the
paper's O(K_L²) pairwise scheme. As in the paper, the link update gets the
write weights without gradient; cotangents still flow through N_t and P_t
from step to step (a merge is linear in the old row values, and the link
reads scale rows by the previous read weights).

Orders the reference fixes, which the port follows:

* ``lax.top_k`` puts the lower index first among equal values, and ties
  are the normal case (at step 1 every previous read weight is 0): every
  top-K here is a stable descending sort (`_top`).
* A row set twice in one step keeps its last value, and only that update
  gets a gradient (``.at[rows].set``): every duplicate carries its
  winner's row (`_set_rows`), so the device's choice among them does not
  matter. An empty precedence slot (-1, clamped to row 0) comes after the
  valid ones and writes row 0's *old* P_t row back: it undoes a real
  update of row 0, as in the reference.
* The link reads use N_{t-1} and P_{t-1}: their rows are gathered before
  the linkage update overwrites them.

With ``collect_deltas=True`` a step also returns what the sparse-rollback
backward needs (`SDNCDeltas`, `core/cell.py::SDNCCell`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import addressing as addr
from repro_torch.core import ann as ann_lib
from repro_torch.core.controller import (linear, linear_init, lstm_init,
                                         lstm_step, lstm_zero_state)
from repro_torch.core.types import (MEM_DTYPES, ANNState, ControllerConfig,
                                    LSTMState, MemoryConfig, SparseRead,
                                    init_scratch_last_access,
                                    init_scratch_memory, require_live)
from repro_torch.distributed import mem_shard
from repro_torch.kernels import ref

# The open roadmap item that the SDNC on a sharded memory waits on.
MESH_ITEM = ("the SDNC on a slot-sharded memory is ROADMAP.md A11, item 4; "
             "the port runs it on one device")


@dataclasses.dataclass(frozen=True)
class DNCConfig:
    memory: MemoryConfig
    controller: ControllerConfig
    k_l: int = 8                 # sparse link entries per row (paper: 8)
    sparse: bool = False         # False = DNC, True = SDNC


class SparseMat(NamedTuple):
    """Row-sparse (N, K_L) matrix: per-row column indices (-1 = empty) and
    values."""

    cols: torch.Tensor   # (B, N, K_L) int32
    vals: torch.Tensor   # (B, N, K_L) f32


class SparseVec(NamedTuple):
    idx: torch.Tensor    # (B, K_L) int32, -1 = empty
    val: torch.Tensor    # (B, K_L) f32


class SDNCDeltas(NamedTuple):
    """What one SDNC step records for the backward (the §3.4 rollback
    extended to the link state): the rows it overwrote in the memory, N_t
    and P_t, and the selections it committed to. O(J·W + J·K_L + K_L²)
    per step, independent of N."""

    write_idx: torch.Tensor   # (B, J) int32 rows touched by the write
    old_rows: torch.Tensor    # (B, J, W) their memory rows before the write
    lra: torch.Tensor         # (B, 1) int32 the row the write erased
    cont_idx: torch.Tensor    # (B, R, K) int32 content-read selection,
    #                           signed (-1 = no valid LSH candidate)
    n_cols: torch.Tensor      # (B, J, K_L) N_t rows at write_idx before
    n_vals: torch.Tensor      # (B, J, K_L) the update
    p_cols: torch.Tensor      # (B, K_L, K_L) P_t rows at the previous
    p_vals: torch.Tensor      # (B, K_L, K_L) precedence's support


class DNCState(NamedTuple):
    """The JAX field set. The dense DNC holds (B, N, W) memory, (B, N)
    usage, (B, R, N) read and (B, N) write weights, (B, N) precedence and
    the (B, N, N) link; the SDNC the scratch-row memory and int32 usage
    table, its last read (`read`), write (`write_w` at `write_idx`), the
    sparse precedence and N_t, P_t, with (B,) zero placeholders in the
    dense fields. ``ann`` is an LSH SDNC's index."""

    memory: torch.Tensor
    usage: torch.Tensor            # DNC usage u_t / SDNC last access (int32)
    read_w: torch.Tensor           # dense (B, R, N) | sparse (B,) placeholder
    read: Optional[SparseRead]     # sparse only
    read_words: torch.Tensor       # (B, R, W)
    write_w: torch.Tensor          # dense (B, N) | sparse (B, J)
    write_idx: torch.Tensor        # sparse (B, J) int32 | dense (B,) int32
    prec: torch.Tensor             # dense (B, N) | sparse (B,) placeholder
    prec_sp: Optional[SparseVec]
    link: torch.Tensor             # dense (B, N, N) | sparse (B,) placeholder
    n_mat: Optional[SparseMat]
    p_mat: Optional[SparseMat]
    ctrl: LSTMState
    step: torch.Tensor             # () int32
    ann: Optional[ANNState] = None


# --------------------------------------------------------------------------
# Sparse-matrix helpers (O(K_L²) merges, paper Suppl. D)
# --------------------------------------------------------------------------

def _top(score: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties to the lower
    index (a stable descending sort). Returns (values, positions)."""
    vals, pos = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def _merge_rows(cols_a, vals_a, cols_b, vals_b, k_l: int):
    """Merge two (..., K) sparse rows, combining duplicate columns, and keep
    the top K_L entries by value (O(K²) pairwise combine). Returns (cols,
    vals), -1 and 0.0 in the empty slots."""
    cols = torch.cat([cols_a, cols_b], dim=-1)
    vals = torch.cat([vals_a, vals_b], dim=-1)
    valid = cols >= 0
    vals = torch.where(valid, vals, 0.0)
    eq = ((cols[..., :, None] == cols[..., None, :]) & valid[..., None, :]
          & valid[..., :, None])
    combined = torch.einsum("...jk,...k->...j", eq.to(vals.dtype), vals)
    first = eq.to(torch.int8).argmax(-1) == torch.arange(
        cols.shape[-1], device=cols.device)
    score = torch.where(valid & first, combined, -torch.inf)
    top, pos = _top(score, k_l)
    ok = torch.isfinite(top)
    return (torch.where(ok, torch.gather(cols, -1, pos), -1),
            torch.where(ok, top, 0.0))


def _sparse_vec_lookup(vec: SparseVec, query_idx: torch.Tensor) -> torch.Tensor:
    """vec[query_idx] for a sparse vector; query_idx: (B, J)."""
    eq = ((query_idx[..., :, None] == vec.idx[..., None, :])
          & (vec.idx[..., None, :] >= 0))
    return torch.einsum("bjk,bk->bj", eq.to(vec.val.dtype), vec.val)


def _set_rows(buf: torch.Tensor, idx: torch.Tensor,
              rows: torch.Tensor) -> None:
    """buf[b, idx[b, j]] = rows[b, j] in place, the last duplicate winning,
    as ``.at[b, idx].set``. Every duplicate carries its winner's row, so
    the result does not depend on which one the device writes last, and
    only the winner's row has a gradient. buf: (B, N, C), idx: (B, J),
    rows: (B, J, C)."""
    B, J = idx.shape
    i = idx.long()
    ar = torch.arange(J, device=idx.device)
    win = torch.where(i[:, :, None] == i[:, None, :], ar, -1).amax(-1)
    carry = torch.gather(rows, 1, win[..., None].expand(rows.shape))
    rows = torch.where((win == ar)[..., None], rows, carry.detach())
    b = torch.arange(B, device=idx.device)[:, None].expand(B, J)
    buf.index_put_((b, i), rows)


def _linkage_rows(n_cols, n_vals, p_cols, p_vals, prec: SparseVec, widx,
                  ww, k_l: int):
    """The sparse precedence and the N_t/P_t row updates (eqs. 11, 19, 20)
    on the old rows: N_t rows at ``widx`` (``n_cols``, ``n_vals`` (B, J,
    K_L)) and P_t rows at the previous precedence's support (``p_cols``,
    ``p_vals`` (B, K_L, K_L)); ``ww`` carries no gradient. Returns the new
    N_t rows, the new P_t rows and the new precedence, each (cols, vals)."""
    B, J = widx.shape
    # N_t rows i in widx: row_i <- (1 - w_i)·row_i + w_i·p_{t-1}.
    m = _merge_rows(n_cols, (1.0 - ww)[..., None] * n_vals,
                    prec.idx[:, None, :].expand(B, J, k_l),
                    ww[..., None] * prec.val[:, None, :], k_l)
    # P_t rows i in supp(p_{t-1}): an entry decays by (1 - w_col) where its
    # column was written, and takes the new w_j·p_i.
    eq = p_cols[..., :, None] == widx[:, None, None, :]      # (B,KL,KL,J)
    wcol = torch.einsum("bkcj,bj->bkc", eq.to(ww.dtype), ww)
    mp_cols, mp_vals = _merge_rows(
        p_cols, (1.0 - wcol) * p_vals, widx[:, None, :].expand(B, k_l, J),
        ww[:, None, :] * prec.val[..., None], k_l)
    valid_row = (prec.idx >= 0)[..., None]
    mp = (torch.where(valid_row, mp_cols, p_cols),
          torch.where(valid_row, mp_vals, p_vals))
    # Precedence: p_t = (1 - Σw) p_{t-1} + w_t, top K_L kept.
    dec = 1.0 - ww.sum(-1, keepdim=True)
    return m, mp, _merge_rows(prec.idx, dec * prec.val, widx, ww, k_l)


def _write_linkage(n_mat: SparseMat, p_mat: SparseMat, widx, p_rows, m,
                   mp) -> None:
    """Set the new N_t rows at ``widx`` and P_t rows at ``p_rows``, in
    place, the last duplicate winning."""
    _set_rows(n_mat.cols, widx, m[0])
    _set_rows(n_mat.vals, widx, m[1])
    _set_rows(p_mat.cols, p_rows, mp[0])
    _set_rows(p_mat.vals, p_rows, mp[1])


def _link_top(rows_c: torch.Tensor, rows_v: torch.Tensor, k: int):
    """f = N_t w^r restricted to sparse rows (eqs. 21/22): the gathered rows
    ``rows_c`` (B, R·K, K_L) at the previous read's indices, their values
    ``rows_v`` (B, R, K, K_L) already scaled by its weights; the top K
    entries per head. Returns (indices (B, R, K) int32, weights)."""
    B, R = rows_v.shape[:2]
    rows_c = rows_c.reshape(B, R, -1)
    score = torch.where(rows_c >= 0, rows_v.reshape(B, R, -1), -torch.inf)
    top_v, pos = _top(score, k)
    ok = torch.isfinite(top_v)
    return (torch.where(ok, torch.gather(rows_c, -1, pos), 0).to(torch.int32),
            torch.where(ok, top_v, 0.0))


def _link_read(mat: SparseMat, read: SparseRead, k: int):
    """`_link_top` of ``mat``'s rows at ``read``'s indices."""
    B, R, K = read.indices.shape
    idx = read.indices.reshape(B, -1)
    rows_v = ref.gather_rows(mat.vals, idx).reshape(B, R, K, -1)
    return _link_top(ref.gather_rows(mat.cols, idx),
                     rows_v * read.weights[..., None], k)


# --------------------------------------------------------------------------
# Parameters, state, interface
# --------------------------------------------------------------------------

def _iface_sizes(cfg: DNCConfig) -> int:
    W, R = cfg.memory.word_size, cfg.memory.num_heads
    # read keys RW, read betas R, read modes 3R, write key W, write beta 1,
    # erase W, write vec W, free gates R, alloc gate 1, write gate 1.
    return R * W + R + 3 * R + W + 1 + W + W + R + 1 + 1


def init_params(generator: torch.Generator, cfg: DNCConfig, *, device="cuda"):
    """Weights of the JAX shapes and glorot scale, drawn in order (LSTM wx,
    wh, interface, output) from ``generator``; an LSH SDNC's fixed planes
    (``lsh_planes``) are drawn after them."""
    mem, ctl = cfg.memory, cfg.controller
    R, W = mem.num_heads, mem.word_size
    params = {
        "lstm": lstm_init(generator, ctl.input_size + R * W, ctl.hidden_size,
                          device=device),
        "iface": linear_init(generator, ctl.hidden_size, _iface_sizes(cfg),
                             device=device),
        "out": linear_init(generator, ctl.hidden_size + R * W,
                           ctl.output_size, device=device),
    }
    if cfg.sparse and mem.ann == "lsh":
        params["lsh_planes"] = ann_lib.lsh_planes(generator, mem,
                                                  device=device)
    return params


def _require_sdnc_rows(mem: MemoryConfig) -> None:
    if mem.mem_dtype == "int8":
        raise ValueError(
            "SDNC does not support mem_dtype='int8': the link-matrix "
            "write scheme re-reads rows it just wrote within a step, "
            "which would compound requantization error. Use 'bfloat16' "
            "for reduced-precision SDNC memory, or SAM for int8.")


def init_state(batch: int, cfg: DNCConfig, *, device="cuda") -> DNCState:
    """A zero state in the JAX layout (`DNCState`). The SDNC takes f32 or
    bf16 rows (``mem_dtype``) on one device: int8 rows raise JAX's error,
    a `mem_shard.memory_mesh` context raises naming its roadmap item."""
    mem, ctl = cfg.memory, cfg.controller
    R, W, N, KL = mem.num_heads, mem.word_size, mem.num_slots, cfg.k_l
    J = R * mem.k + 1

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    common = dict(read_words=zeros(batch, R, W),
                  ctrl=lstm_zero_state(batch, ctl.hidden_size, device=device),
                  step=zeros(dtype=torch.int32))
    if cfg.sparse:
        _require_sdnc_rows(mem)
        if mem_shard.init_layout(N) != (N, 0):
            raise NotImplementedError(MESH_ITEM)

        def empty(*shape):
            return torch.full(shape, -1, dtype=torch.int32, device=device)

        return DNCState(
            memory=init_scratch_memory(batch, N, W,
                                       dtype=MEM_DTYPES[mem.mem_dtype],
                                       device=device),
            usage=init_scratch_last_access(batch, N, device=device),
            read_w=zeros(batch),
            read=SparseRead(indices=zeros(batch, R, mem.k, dtype=torch.int32),
                            weights=zeros(batch, R, mem.k),
                            words=zeros(batch, R, W)),
            write_w=zeros(batch, J),
            write_idx=zeros(batch, J, dtype=torch.int32),
            prec=zeros(batch),
            prec_sp=SparseVec(idx=empty(batch, KL), val=zeros(batch, KL)),
            link=zeros(batch),
            n_mat=SparseMat(cols=empty(batch, N, KL), vals=zeros(batch, N, KL)),
            p_mat=SparseMat(cols=empty(batch, N, KL), vals=zeros(batch, N, KL)),
            ann=(ann_lib.ann_init(batch, mem, device=device)
                 if mem.ann == "lsh" else None),
            **common)
    # Dense DNC: dense weightings address every row, so the memory stays
    # unpadded; the scratch-row layout is only for the sparse write.
    read_w = zeros(batch, R, N)
    read_w[:, :, 0] = 1.0
    return DNCState(memory=zeros(batch, N, W), usage=zeros(batch, N),
                    read_w=read_w, read=None, write_w=zeros(batch, N),
                    write_idx=zeros(batch, dtype=torch.int32),
                    prec=zeros(batch, N), prec_sp=None,
                    link=zeros(batch, N, N), n_mat=None, p_mat=None, **common)


def _parse_iface(cfg: DNCConfig, p: torch.Tensor):
    R, W = cfg.memory.num_heads, cfg.memory.word_size
    B = p.shape[0]
    o = 0
    rk = p[:, o:o + R * W].reshape(B, R, W).contiguous(); o += R * W
    rb = F.softplus(p[:, o:o + R]) + 1.0; o += R
    modes = torch.softmax(p[:, o:o + 3 * R].reshape(B, R, 3), -1); o += 3 * R
    wk = p[:, o:o + W].reshape(B, 1, W); o += W
    wb = F.softplus(p[:, o]) + 1.0; o += 1
    er = torch.sigmoid(p[:, o:o + W]); o += W
    wv = p[:, o:o + W].contiguous(); o += W
    free = torch.sigmoid(p[:, o:o + R]); o += R
    alloc_g = torch.sigmoid(p[:, o]); o += 1
    write_g = torch.sigmoid(p[:, o])
    return rk, rb, modes, wk, wb, er, wv, free, alloc_g, write_g


def _controller(params, cfg: DNCConfig, s: DNCState, x: torch.Tensor):
    B = x.shape[0]
    ctrl, h = lstm_step(params["lstm"], s.ctrl,
                        torch.cat([x, s.read_words.reshape(B, -1)], dim=-1))
    return ctrl, h, _parse_iface(cfg, linear(params["iface"], h))


def _output(params, h: torch.Tensor, read_words: torch.Tensor):
    return linear(params["out"],
                  torch.cat([h, read_words.reshape(h.shape[0], -1)], dim=-1))


# --------------------------------------------------------------------------
# Dense DNC
# --------------------------------------------------------------------------

def _dnc_step(params, cfg: DNCConfig, s: DNCState, x: torch.Tensor):
    B = x.shape[0]
    ctrl, h, (rk, rb, modes, wk, wb, er, wv, free, alloc_g,
              write_g) = _controller(params, cfg, s, x)

    # Usage and allocation (Graves et al. 2016 eqs. 1-3, 7-9); the free
    # list is the usage sorted ascending, ties to the lower index.
    psi = torch.prod(1.0 - free[..., None] * s.read_w, dim=1)    # retention
    usage = (s.usage + s.write_w - s.usage * s.write_w) * psi
    sorted_u, free_list = torch.sort(usage, dim=-1, stable=True)
    ones = torch.ones((B, 1), device=x.device)
    cprod = torch.cumprod(torch.cat([ones, sorted_u], -1)[:, :-1], -1)
    alloc = torch.zeros_like(usage).scatter(-1, free_list,
                                            (1.0 - sorted_u) * cprod)

    wc = addr.dense_read_weights(wk, s.memory, wb[:, None])[:, 0]  # (B, N)
    write_w = write_g[:, None] * (alloc_g[:, None] * alloc
                                  + (1 - alloc_g[:, None]) * wc)
    memory = (s.memory * (1.0 - write_w[..., None] * er[:, None, :])
              + write_w[..., None] * wv[:, None, :])

    # Temporal linkage, without gradient through the write weights (the
    # paper's implementation choice, as in JAX). The diagonal is zeroed in
    # place instead of multiplied by (1 - I), which would take another
    # (N, N) tensor.
    ww = write_w.detach()
    link = ((1.0 - ww[:, :, None] - ww[:, None, :]) * s.link
            + ww[:, :, None] * s.prec[:, None, :])
    torch.diagonal(link, dim1=-2, dim2=-1).zero_()
    prec = (1.0 - ww.sum(-1, keepdim=True)) * s.prec + ww

    fwd_w = torch.matmul(s.read_w, link.transpose(1, 2))   # Σ_j L_ij w_j
    bwd_w = torch.matmul(s.read_w, link)                   # Σ_j L_ji w_j
    cont_w = addr.dense_read_weights(rk, memory, rb)
    read_w = (modes[..., 0:1] * bwd_w + modes[..., 1:2] * cont_w
              + modes[..., 2:3] * fwd_w)
    read_words = addr.dense_read(read_w, memory)
    return DNCState(memory=memory, usage=usage, read_w=read_w, read=None,
                    read_words=read_words, write_w=write_w,
                    write_idx=s.write_idx, prec=prec, prec_sp=None, link=link,
                    n_mat=None, p_mat=None, ctrl=ctrl,
                    step=s.step + 1), _output(params, h, read_words)


# --------------------------------------------------------------------------
# Sparse DNC
# --------------------------------------------------------------------------

def _write_plan(prev: SparseRead, lra: torch.Tensor, alloc_g: torch.Tensor,
                write_g: torch.Tensor):
    """The write rows and weights (Suppl. D.1): the previous read's R·K
    rows, their weights normalised across heads, then the LRA row.
    Mirrors the reference's expression term for term (its
    ``write_g·alloc_g·0.0`` included) so the floats match bit for bit.
    Returns (widx (B, J) int32, ww (B, J))."""
    B = lra.shape[0]
    prev_w = prev.weights.reshape(B, -1)
    prev_w = prev_w / (prev_w.sum(-1, keepdim=True) + 1e-8)
    wg, ag = write_g[:, None], alloc_g[:, None]
    ww = torch.cat([wg * ag * 0.0 + wg * (1 - ag) * prev_w,
                    wg * ag * torch.ones((B, 1), device=lra.device)], dim=-1)
    return torch.cat([prev.indices.reshape(B, -1), lra], dim=-1), ww


def _combine(modes, bwd, cont_idx, cont_w, fwd, k: int):
    """The read weighting: the backward link, content and forward link
    candidates weighted by the read modes, the top K by weight (ties to
    the lower position), renormalised. Returns (indices (B, R, K) int32,
    weights)."""
    idx = torch.cat([bwd[0], cont_idx, fwd[0]], dim=-1)      # (B, R, 3K)
    wts = torch.cat([modes[..., 0:1] * bwd[1], modes[..., 1:2] * cont_w,
                     modes[..., 2:3] * fwd[1]], dim=-1)
    top_w, pos = _top(wts, k)
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-8)
    return torch.gather(idx, -1, pos), top_w


def _check_sdnc(cfg: DNCConfig, s: DNCState) -> None:
    mem = cfg.memory
    _require_sdnc_rows(mem)
    if s.memory.dtype != MEM_DTYPES[mem.mem_dtype]:
        raise ValueError(f"mem_dtype={mem.mem_dtype!r} needs a "
                         f"{MEM_DTYPES[mem.mem_dtype]} memory, got a "
                         f"{s.memory.dtype} one")
    if mem_shard.memory_layout(mem.num_slots, s.memory.shape[1]) is not None:
        raise NotImplementedError(MESH_ITEM)
    if (s.ann is not None) != (mem.ann == "lsh"):
        raise ValueError(f"ann={mem.ann!r} needs a state "
                         f"{'with' if mem.ann == 'lsh' else 'without'} an "
                         f"LSH index")
    require_live(s)


def _sdnc_step(params, cfg: DNCConfig, s: DNCState, x: torch.Tensor, *,
               collect_deltas: bool = False):
    mem = cfg.memory
    K, KL, N = mem.k, cfg.k_l, mem.num_slots
    _check_sdnc(cfg, s)
    B = x.shape[0]
    ctrl, h, (rk, rb, modes, _, _, _, wv, _, alloc_g,
              write_g) = _controller(params, cfg, s, x)

    # ---- the sparse write, SAM's mechanism (Suppl. D.1) ----
    lra = addr.least_recently_accessed(s.usage, 1, valid_n=N)   # (B, 1)
    widx, ww = _write_plan(s.read, lra, alloc_g, write_g)
    p_rows = s.prec_sp.idx.clamp_min(0)
    # The old rows the linkage update merges (and overwrites), and the
    # link reads' rows of N_{t-1} and P_{t-1}, before the update.
    old_n = (ref.gather_rows(s.n_mat.cols, widx),
             ref.gather_rows(s.n_mat.vals, widx))
    old_p = (ref.gather_rows(s.p_mat.cols, p_rows),
             ref.gather_rows(s.p_mat.vals, p_rows))
    fwd = _link_read(s.n_mat, s.read, K)
    bwd = _link_read(s.p_mat, s.read, K)
    old_rows = addr.gather_rows(s.memory, widx) if collect_deltas else None

    # Erase the LRA row, then scatter-add the write vector.
    memory = addr.scatter_set_rows(s.memory, lra,
                                   s.memory.new_zeros((B, 1, wv.shape[-1])))
    memory = addr.scatter_add_rows(memory, widx,
                                   ww[..., None] * wv[:, None, :])

    # ---- sparse temporal linkage (eqs. 17-22), without gradient in ww ----
    m, mp, prec = _linkage_rows(*old_n, *old_p, s.prec_sp, widx, ww.detach(),
                                KL)
    _write_linkage(s.n_mat, s.p_mat, widx, p_rows, m, mp)

    # ---- reads: content + the sparse forward/backward link reads ----
    if mem.ann == "lsh":
        planes = params["lsh_planes"]
        cand = ann_lib.ann_candidates(planes, s.ann, rk, widx, mem)
        cont, cont_sel = addr.select_and_read_candidates(rk, memory, rb, K,
                                                         cand)
        rows = addr.gather_rows(memory, widx).detach().to(torch.float32)
        ann_state = ann_lib.ann_insert(planes, s.ann, widx, rows, mem)
    else:
        cont = addr.sparse_read_exact(rk, memory, rb, K, valid_n=N)
        cont_sel, ann_state = cont.indices, None
    top_idx, top_w = _combine(modes, bwd, cont.indices, cont.weights, fwd, K)
    words = addr.gather_rows(memory, top_idx).to(torch.float32)
    read_words = torch.einsum("brk,brkw->brw", top_w, words)
    read = SparseRead(indices=top_idx, weights=top_w, words=read_words)

    step = s.step + 1
    usage = addr.update_last_access(s.usage, widx, ww, step, mem.delta)
    usage = addr.update_last_access(usage, top_idx.reshape(B, -1),
                                    top_w.reshape(B, -1), step, mem.delta)
    new_state = DNCState(memory=memory, usage=usage, read_w=s.read_w,
                         read=read, read_words=read_words, write_w=ww,
                         write_idx=widx, prec=s.prec,
                         prec_sp=SparseVec(*prec), link=s.link,
                         n_mat=s.n_mat, p_mat=s.p_mat, ctrl=ctrl, step=step,
                         ann=ann_state)
    y = _output(params, h, read_words)
    if collect_deltas:
        return new_state, y, SDNCDeltas(
            write_idx=widx, old_rows=old_rows, lra=lra, cont_idx=cont_sel,
            n_cols=old_n[0], n_vals=old_n[1], p_cols=old_p[0],
            p_vals=old_p[1])
    return new_state, y


def sdnc_rollback(cfg: DNCConfig, state: DNCState, prev_small,
                  deltas: SDNCDeltas) -> DNCState:
    """Undo one SDNC step in place: 'set' the recorded rows back into the
    memory (`scatter_rows`), N_t and P_t, and splice the recorded small
    leaves (read, write weights, precedence, controller) back in. A
    duplicate row carries the same old contents in every copy. The usage
    table is left stale (the backward never reads it), and so is an LSH
    index, which the replay does not need."""
    read, write_w, prec_sp, ctrl = prev_small
    addr.scatter_set_rows(state.memory, deltas.write_idx, deltas.old_rows)
    _write_linkage(state.n_mat, state.p_mat, deltas.write_idx,
                   prec_sp.idx.clamp_min(0), (deltas.n_cols, deltas.n_vals),
                   (deltas.p_cols, deltas.p_vals))
    return state._replace(read=read, read_words=read.words, write_w=write_w,
                          prec_sp=prec_sp, ctrl=ctrl, step=state.step - 1)


def dnc_step(params, cfg: DNCConfig, s: DNCState, x: torch.Tensor, *,
             collect_deltas: bool = False):
    """One step of the DNC or the SDNC. Returns (new_state, y_t[,
    deltas]); the SDNC updates ``s``'s memory, usage table, N_t and P_t in
    place, the DNC leaves ``s`` as it was."""
    if cfg.sparse:
        return _sdnc_step(params, cfg, s, x, collect_deltas=collect_deltas)
    if collect_deltas:
        raise ValueError("collect_deltas requires the sparse DNC "
                         "(DNCConfig.sparse=True); the dense DNC has no "
                         "sparse rollback contract")
    return _dnc_step(params, cfg, s, x)


def dnc_unroll(params, cfg: DNCConfig, state: DNCState, xs: torch.Tensor):
    """Run `dnc_step` over xs (T, B, D). Returns (final_state, ys (T, B,
    output_size)); records autograd when its inputs require grad."""
    ys = []
    for x in xs:
        state, y = dnc_step(params, cfg, state, x)
        ys.append(y)
    return state, torch.stack(ys)


class DNC(nn.Module):
    """The DNC or the SDNC as a module, shaped like `sam.SAM`: trainable
    weights in the JAX tree layout (`params()`; an LSH SDNC's fixed planes
    a buffer), and a `forward` that unrolls the model over a sequence
    without a graph."""

    def __init__(self, cfg: DNCConfig, params=None, *, seed: int = 0,
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
        """The weights as the nested dict that `dnc_step` takes."""
        out = {"lstm": dict(self.lstm), "iface": dict(self.iface),
               "out": dict(self.out)}
        if hasattr(self, "lsh_planes"):
            out["lsh_planes"] = self.lsh_planes
        return out

    def init_state(self, batch: int) -> DNCState:
        return init_state(batch, self.cfg, device=self.lstm["b"].device)

    def forward(self, state: DNCState, xs: torch.Tensor):
        with torch.inference_mode():
            return dnc_unroll(self.params(), self.cfg, state, xs)
