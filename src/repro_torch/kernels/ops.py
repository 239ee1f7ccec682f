"""Device dispatch of the memory ops (the single-device part of
`repro/kernels/ops.py`), and their gradients; and of the LM's causal
attention (`flash_attention`), whose backward is plain PyTorch. The ops never route a
slot-sharded memory: `distributed/mem_shard.py` calls them on a rank's
block with the block's ``valid_n``.

A CPU tensor takes the plain version in `kernels/ref.py`; a CUDA tensor
launches the hand-written kernel, which raises on anything it cannot take
(a float table for the LRA rows, an int one for DAM's argmin, a wrong
shape or dtype, a non-contiguous buffer).
There is no fallback from one to the other and no switch that swaps the
kernel out: unlike the JAX package, the kernels take any N and mask the
ragged tile themselves.

Storage dtypes: the reads, the write and the row scatter take f32, bf16
or int8 rows (int8 with ``mem_scale=``, the (B, rows) f32 per-row scales,
which the int8 write and scatter update in place and return). A bf16
memory's gradient is bf16, as JAX's cotangent of a bf16 leaf is. An int8
memory's codes get no gradient; its scales do (the straight-through
scheme of `repro/kernels/ops.py:373-425, 633-662`): the read's is the
gradient of the dequantized gather, the write's the closed-form VJP of
its scale output (`write_q_vjp`). `lsh_hash` takes f32; its callers
upcast.

When autograd records (grad enabled and an input requires grad), each op
runs inside a `torch.autograd.Function` whose backward is the closed-form
VJP of the JAX package's custom VJP (`repro/kernels/ops.py:318-425`,
`:481-506`, `:587-662`); otherwise the op runs bare. These dense
gradients are what the naive unroll (`core/unroll.py`) differentiates
through: each step's memory gradient is a (B, N+1, W) tensor (a (B, N+1)
one for int8 rows' scales). The sparse-rollback engine does not use them;
it keeps one cotangent buffer for the whole backward (`core/cell.py`).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import dequantize_rows, scale_vjp
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import check_mask_args
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_attention_kernel
from repro_torch.kernels.fused_read import fused_read_sweep
from repro_torch.kernels.fused_read_candidates import \
    fused_read_candidates as fused_read_cand_kernel
from repro_torch.kernels.lsh_hash import lsh_hash as lsh_hash_kernel
from repro_torch.kernels.scatter_rows import scatter_rows as scatter_rows_kernel
from repro_torch.kernels.sparse_write import \
    sparse_write_update as sparse_write_kernel
from repro_torch.kernels.topk_read import topk_read as topk_read_kernel
from repro_torch.kernels.usage_argmin import lra_topn as lra_topn_kernel
from repro_torch.kernels.usage_argmin import \
    usage_argmin as usage_argmin_kernel


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def lra_topn(last_access: torch.Tensor, n: int, *, valid_n: int | None = None):
    """last_access: (B, rows) int -> (B, n) int32 least-recently-accessed
    rows among [0, valid_n), most stale first (ties toward the lowest
    index)."""
    if _on_cpu(last_access):
        la = last_access if valid_n is None else last_access[:, :valid_n]
        return ref.lra_topn_ref(la, n)
    return lra_topn_kernel(last_access, n, valid_n=valid_n)


def topk_read(q: torch.Tensor, mem: torch.Tensor, k: int, *,
              valid_n: int | None = None, mem_scale=None):
    """q: (B, H, W), mem: (B, rows, W) f32, bf16, or int8 with its scales
    ``mem_scale`` (B, rows) f32 -> (vals (B, H, K) f32, idx (B, H, K)
    int32): the K rows among [0, valid_n) of highest cosine similarity on
    the rows as f32 (upcast or dequantized, as `fused_read` ranks them),
    by (similarity desc, index asc). A selection: it has no gradient and
    raises when autograd records (the caller detaches)."""
    if _records(q, mem, mem_scale):
        raise ValueError("topk_read is a selection and has no gradient: "
                         "pass detached q and mem")
    if _on_cpu(mem):
        return ref.topk_read_ref(q, mem, k, valid_n=valid_n,
                                 mem_scale=mem_scale)
    return topk_read_kernel(q.contiguous(), mem, k=k, valid_n=valid_n,
                            mem_scale=mem_scale)


def usage_argmin(usage: torch.Tensor, *, valid_n: int | None = None):
    """usage: (B, rows) f32 -> (B,) int32 index of the minimum among
    [0, valid_n) (ties toward the lowest index; -0.0 equals +0.0): DAM's
    least-used row. Not differentiable (the caller detaches)."""
    if _on_cpu(usage):
        return ref.usage_argmin_ref(usage if valid_n is None
                                    else usage[:, :valid_n])
    return usage_argmin_kernel(usage, valid_n=valid_n)


def lsh_hash(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """x: (..., W), planes: (T, bits, W) -> bucket ids (..., T) int32, the
    signs of x's projections on each table's planes, packed
    little-endian. Not differentiable (the caller detaches)."""
    if _on_cpu(x):
        return ref.lsh_hash_ref(x, planes)
    shape = x.shape
    ids = lsh_hash_kernel(x.reshape(-1, shape[-1]).contiguous(),
                          planes.contiguous())
    return ids.reshape(shape[:-1] + (planes.shape[0],))


def _flash_attention(q, k, v, window, prefix):
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, window, prefix)
    return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=window,
                                  prefix=prefix)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_block: int | None = None, window: int | None = None,
                    prefix: int = 0) -> torch.Tensor:
    """Causal GQA attention: q (B, S, H, D), k (B, S, Hkv, D), v (B, S,
    Hkv, DV), f32 or bf16 -> (B, S, H, DV) in q's dtype
    (`ref.flash_attention_ref` on the CPU, any DV; `csrc/flash_attention.cu`
    on the card, DV = D or, at D = 192, 128:
    `flash_attention.HEAD_DIM_PAIRS`); with ``window`` query i
    sees the keys j with i - j < window (`chunked_attention`'s sliding
    window), and every query sees the keys j < ``prefix`` (its
    ``prefix_len``, the prefix-LM). Differentiable in q, k and v: the
    backward (`_FlashAttention`) is plain PyTorch in blocks of ``q_block``
    query rows (default: all S), as the TPU kernel has no backward either
    (the JAX package differentiates `chunked_attention`). Raises unless
    ``window`` is None or an int >= 1 and ``prefix`` an int >= 0."""
    check_mask_args(window, prefix)
    if _records(q, k, v):
        return _FlashAttention.apply(q, k, v, q_block or q.shape[1], window,
                                     prefix)
    return _flash_attention(q, k, v, window, prefix)


class _FlashAttention(torch.autograd.Function):
    """The forward is the kernel (or its plain version); it saves q, k and
    v only. The backward recomputes the scores of one block of
    ``q_block`` query rows at a time against the keys the block sees
    (`ref.attn_keys`: from the window's first key, or 0, to the block's
    end, or to the prefix's end past it), under the forward's mask
    (`ref.attn_mask`), in f32, so it never holds the whole (B, H, S, S) at
    full width: with P = softmax(S), dV += Pᵀ·dO, dP = dO·Vᵀ, dS = P ∘
    (dP - rowsum(P ∘ dP)), dQ = dS·K·D^-0.5, dK += dSᵀ·Q·D^-0.5; a kv
    head's gradients sum over its group of query heads."""

    @staticmethod
    def forward(ctx, q, k, v, q_block, window, prefix):
        ctx.save_for_backward(q, k, v)
        ctx.q_block, ctx.window, ctx.prefix = q_block, window, prefix
        return _flash_attention(q, k, v, window, prefix)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        B, S, H, D = q.shape
        Hkv = k.shape[2]
        ct = torch.promote_types(q.dtype, torch.float32)
        scale = D ** -0.5
        kf, vf = k.to(ct), v.to(ct)
        dq = torch.empty((B, S, H, D), dtype=ct, device=q.device)
        dk = torch.zeros((B, S, Hkv, D), dtype=ct, device=q.device)
        dv = torch.zeros(v.shape, dtype=ct, device=q.device)
        for lo in range(0, S, ctx.q_block):
            hi = min(lo + ctx.q_block, S)
            k_lo, k_hi = ref.attn_keys(lo, hi, S, ctx.window, ctx.prefix)
            kb, vb = kf[:, k_lo:k_hi], vf[:, k_lo:k_hi]
            qb = q[:, lo:hi].to(ct).reshape(B, hi - lo, Hkv, H // Hkv, D)
            gb = g[:, lo:hi].to(ct).reshape(B, hi - lo, Hkv, H // Hkv, -1)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            mask = ref.attn_mask(lo, hi, k_lo, k_hi, ctx.window, ctx.prefix,
                                 q.device)
            p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
            del s
            dv[:, k_lo:k_hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, gb)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", gb, vb)
            ds = p.mul_(dp.sub_((p * dp).sum(-1, keepdim=True)))
            del dp
            dq[:, lo:hi] = torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                        kb).reshape(B, hi - lo, H, D) * scale
            dk[:, k_lo:k_hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds,
                                             qb) * scale
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


# --------------------------------------------------------------------------
# The reads: exact (a sweep of the memory) and over LSH candidates
# --------------------------------------------------------------------------

def _fused_read(q, mem, beta, k, valid_n, cand_idx, mem_scale=None):
    if cand_idx is not None:
        if _on_cpu(mem):
            return ref.fused_read_candidates_ref(q, mem, beta, k, cand_idx,
                                                 mem_scale)
        return fused_read_cand_kernel(q, mem, beta, cand_idx, k=k,
                                      mem_scale=mem_scale)
    if _on_cpu(mem):
        return ref.fused_read_ref(q, mem, beta, k, valid_n=valid_n,
                                  mem_scale=mem_scale)
    return fused_read_sweep(q, mem, beta, k=k, valid_n=valid_n,
                            mem_scale=mem_scale)


def fused_read(q: torch.Tensor, mem: torch.Tensor, beta: torch.Tensor, k: int,
               *, valid_n: int | None = None,
               cand_idx: torch.Tensor | None = None,
               mem_scale: torch.Tensor | None = None):
    """The SAM read. q: (B, H, W), mem: (B, rows, W) f32, bf16 or int8
    (then with ``mem_scale`` (B, rows) f32), beta: (B, H) -> (read
    (B, H, W) f32, weights (B, H, K), indices (B, H, K) int32), computed
    on the upcast or dequantized rows. Without ``cand_idx`` the exact read
    sweeps rows [0, valid_n). With ``cand_idx`` (B, H, C), signed and
    pre-deduped (-1 = invalid), the ANN read re-ranks those candidates only
    and returns *signed* indices. Differentiable in q, beta and mem (f32 or
    bf16 rows) or, for int8 rows, mem_scale; the selection is not."""
    if _records(q, mem, beta, mem_scale):
        return _FusedRead.apply(q, mem, beta, k, valid_n, cand_idx,
                                mem_scale)
    return _fused_read(q, mem, beta, k, valid_n, cand_idx, mem_scale)


class _FusedRead(torch.autograd.Function):
    """`_fused_read_sweep_vjp` and `_fused_read_cand_vjp` (and their int8
    variants): the backward re-derives the read's tail from the recorded
    (signed) indices. It saves the K gathered rows (and an int8 memory's
    K scales), never the memory, so later in-place writes leave it valid.
    An invalid selection (-1) gathers row 0 with weight exactly 0 and
    gives it no gradient. The rows' gradients are added into a zero
    memory gradient in the memory's dtype (bf16 rows: rounded to bf16 as
    JAX's cast transposes them); for int8 rows the codes get none and the
    scales get Σ_w g_w · code_w (`repro/kernels/ops.py:373-425`)."""

    @staticmethod
    def forward(ctx, q, mem, beta, k, valid_n, cand_idx, mem_scale):
        read, w, idx = _fused_read(q, mem, beta, k, valid_n, cand_idx,
                                   mem_scale)
        rows = idx.clamp_min(0)
        scales = (None if mem_scale is None else
                  ref.gather_rows(mem_scale[..., None], rows)[..., 0])
        ctx.save_for_backward(q, beta, idx, ref.gather_rows(mem, rows),
                              scales)
        ctx.mem_shape, ctx.mem_dtype = mem.shape, mem.dtype
        ctx.mark_non_differentiable(idx)
        return read, w, idx

    @staticmethod
    def backward(ctx, g_read, g_w, _):
        q, beta, idx, rows, scales = ctx.saved_tensors
        valid = idx >= 0
        words = (rows.to(torch.float32) if scales is None
                 else dequantize_rows(rows, scales))
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, words, beta)]
            out = ref.read_tail_rows(*leaves, valid)
            g_q, g_words, g_beta = torch.autograd.grad(out, leaves,
                                                       (g_read, g_w))
        g_mem = g_scale = None
        B, W = q.shape[0], q.shape[-1]
        flat = idx.clamp_min(0).reshape(B, -1)
        g_words = torch.where(valid[..., None], g_words, 0.0)
        if scales is not None and ctx.needs_input_grad[6]:
            g_s = (g_words * rows.to(torch.float32)).sum(-1)
            g_scale = g_words.new_zeros(ctx.mem_shape[:2])
            _scatter_rows(g_scale[..., None], flat, g_s.reshape(B, -1, 1),
                          "add")
        if scales is None and ctx.needs_input_grad[1]:
            g_mem = g_words.new_zeros(ctx.mem_shape, dtype=ctx.mem_dtype)
            _scatter_rows(g_mem, flat, g_words.reshape(B, -1, W), "add")
        return g_q, g_mem, g_beta, None, None, None, g_scale


# --------------------------------------------------------------------------
# Row scatter
# --------------------------------------------------------------------------

def _scatter_rows(mem, idx, rows, mode, mem_scale=None, rows_scale=None):
    idx = idx.contiguous()
    if mem_scale is not None:
        if _on_cpu(mem):
            return ref.scatter_rows_q_ref(mem, mem_scale, idx, rows,
                                          rows_scale, mode)[0]
        scatter_rows_kernel(mem, idx, rows.contiguous(), mode=mode,
                            mem_scale=mem_scale, rows_scale=(
                                None if rows_scale is None
                                else rows_scale.contiguous()))
        return mem
    rows = rows.to(mem.dtype).contiguous()
    if _on_cpu(mem):
        return ref.scatter_rows_ref(mem, idx, rows, mode)
    return scatter_rows_kernel(mem, idx, rows, mode=mode)


def scatter_rows(mem: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                 mode: str = "add", *, mem_scale: torch.Tensor | None = None,
                 rows_scale: torch.Tensor | None = None):
    """mem: (B, R, W) f32 or bf16, idx: (B, J) int32, rows: (B, J, W), in
    place; the rows are cast to the memory's dtype first, as JAX casts
    them. 'add' sums duplicate columns into their row in j order (bf16:
    rounded after each add); 'set' keeps the last (sequential semantics,
    j ascending). No other row is touched, so a (B, N+1, W) buffer's
    scratch row N needs no parking duty. Returns ``mem``; differentiable
    in mem and rows.

    int8 rows (``mem_scale`` (B, R) f32 given): 'set' of int8 rows with
    their recorded scales ``rows_scale`` (B, J) restores both bit for bit
    (the rollback), the only mode the card takes; on the CPU also 'set'
    of float rows and 'add', each re-quantizing a row once
    (`ref.scatter_rows_q_ref`). Returns (mem, mem_scale), in place; not
    differentiable (no path of the port records it)."""
    if mem_scale is not None:
        if _records(mem_scale, rows, rows_scale):
            raise ValueError("scatter_rows on int8 rows has no gradient in "
                             "the port: no training path records it")
        _scatter_rows(mem, idx, rows, mode, mem_scale, rows_scale)
        return mem, mem_scale
    if _records(mem, rows):
        return _ScatterRows.apply(mem, rows, idx, mode)
    return _scatter_rows(mem, idx, rows, mode)


class _ScatterRows(torch.autograd.Function):
    """`_scatter_rows_vjp`: 'add' passes the memory's gradient through and
    hands each column its target row's gradient; 'set' zeroes the
    overwritten rows and hands the gradient only to the column that
    survived (the last of each duplicate set). The rows' gradient comes
    back in their own dtype (a bf16 memory's, cast up, as the transpose of
    JAX's cast). The replay's scatters run on a memory outside the graph
    (`core/cell.py`); the naive SDNC's write records this."""

    @staticmethod
    def forward(ctx, mem, rows, idx, mode):
        _scatter_rows(mem, idx, rows, mode)
        ctx.mark_dirty(mem)
        ctx.save_for_backward(idx)
        ctx.mode, ctx.rows_dtype = mode, rows.dtype
        return mem

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        g_rows = ref.gather_rows(g, idx).to(ctx.rows_dtype)
        if ctx.mode == "add":
            return g, g_rows, None, None
        g_mem = _scatter_rows(g.clone(), idx, torch.zeros_like(g_rows), "set")
        last = ref.first_occurrence(idx.flip(1)).flip(1)
        return g_mem, g_rows * last[..., None], None, None


# --------------------------------------------------------------------------
# The fused write
# --------------------------------------------------------------------------

def write_rows_vjp(g_rows: torch.Tensor, write_w: torch.Tensor,
                   a: torch.Tensor):
    """Gradients of `ref.write_rows` (w_j · a_{j // (K+1)}) from those of
    its (B, J, W) rows: (g_w (B, J), g_a (B, H, W))."""
    B, H, W = a.shape
    kp1 = write_w.shape[1] // H
    g_w = (g_rows * a.repeat_interleave(kp1, dim=1)).sum(-1)
    g_a = (write_w.reshape(B, H, kp1, 1) * g_rows.reshape(B, H, kp1, W)).sum(2)
    return g_w, g_a


def _sparse_write(mem, last_access, write_idx, write_w, a, lra_idx, step,
                  delta, mem_scale=None):
    if not _on_cpu(mem):
        return sparse_write_kernel(mem, last_access, write_idx, write_w, a,
                                   lra_idx, step, delta=delta,
                                   mem_scale=mem_scale)
    if mem_scale is not None:
        return ref.sparse_write_update_q_ref(mem, mem_scale, last_access,
                                             write_idx, write_w, a, lra_idx,
                                             step, delta)
    return ref.sparse_write_update_ref(mem, last_access, write_idx, write_w,
                                       a, lra_idx, step, delta)


def write_q_vjp(g_scale: torch.Tensor, old_q: torch.Tensor,
                old_s: torch.Tensor, write_idx: torch.Tensor,
                lra_idx: torch.Tensor, write_w: torch.Tensor, a: torch.Tensor):
    """The int8 write's VJP, the gradient of `sparse_write_update_q_ref`'s
    scale output in closed form (`repro/kernels/ops.py:633-662`). Column
    j's new scale is max|row_j| · fl(1/127), row_j = (erased ? 0 :
    old_q_j · old_s_j) + Σ_{k names row_j} w_k · a_{k // (K+1)}.
    ``g_scale`` (B, J) is each column's cotangent
    from the scales after the write: only the column that wins its row's
    ``.at[].set`` (the last duplicate) gets one. Returns (g_old_s (B, J),
    nonzero only at the winners, g_w (B, J), g_a (B, H, W)); the new
    codes carry no gradient."""
    i = write_idx.long()
    erased = (i[:, :, None] == lra_idx.long()[:, None, :]).any(-1)
    eq = (i[:, :, None] == i[:, None, :]).to(torch.float32)   # (B, J, J)
    # The rows as the oracle sums them (its einsum, then the add), which
    # JAX's VJP differentiates; the forward's j-order FMAs may differ in a
    # last bit, which moves no gradient but at an exact tie of |row|.
    rows = (torch.where(erased[..., None], 0.0, dequantize_rows(old_q, old_s))
            + torch.einsum("bjk,bkw->bjw", eq, ref.write_rows(write_w, a)))
    g_rows = scale_vjp(rows, g_scale)                         # (B, J, W)
    g_add = torch.einsum("bjk,bjw->bkw", eq, g_rows)          # every column
    g_old_s = torch.where(erased, 0.0,
                          (g_rows * old_q.to(torch.float32)).sum(-1))
    g_w, g_a = write_rows_vjp(g_add, write_w, a)
    return g_old_s, g_w, g_a


def winners(ct: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The cotangent rows of ``ct`` (B, R, ...) at ``idx`` (B, J), each
    kept only at the last column naming its row (the one that wins a
    ``.at[].set``) and zero at the others."""
    last = ref.first_occurrence(idx.flip(1)).flip(1)
    rows = ref.gather_rows(ct, idx)
    return rows * last.view(last.shape + (1,) * (rows.dim() - 2))


def sparse_write_update(mem, last_access, write_idx, write_w, a, lra_idx,
                        step, *, delta: float, mem_scale=None):
    """The fused LRA erase + w^W a^T scatter-add + usage stamp, in place on
    ``mem`` (B, N+1, W) and ``last_access`` (B, N+1). ``mem`` holds f32 or
    bf16 rows, or int8 rows with their scales ``mem_scale`` (B, N+1) f32,
    which the write re-quantizes in place. Returns (mem, last_access), or
    (mem, last_access, mem_scale) with ``mem_scale``. Differentiable in
    mem (f32 and bf16 rows) or mem_scale (int8 rows, whose codes carry no
    gradient), write_w and a; the usage table not (the paper passes no
    gradient through U^(2))."""
    if mem_scale is not None:
        if _records(write_w, a, mem_scale):
            return _SparseWriteQ.apply(mem_scale, write_w, a, mem,
                                       last_access, write_idx, lra_idx, step,
                                       delta)
        return _sparse_write(mem, last_access, write_idx, write_w, a,
                             lra_idx, step, delta, mem_scale)
    if _records(mem, write_w, a):
        mem = _SparseWrite.apply(mem, write_w, a, last_access, write_idx,
                                 lra_idx, step, delta)
        return mem, last_access
    return _sparse_write(mem, last_access, write_idx, write_w, a, lra_idx,
                         step, delta)


class _SparseWrite(torch.autograd.Function):
    """`_sparse_write_vjp`: w_j and a_h read the output gradient at their
    target rows (before the erase zeroes it); the memory's gradient passes
    through except on the erased rows. Needs no memory residual, so the
    write runs in place and marks ``mem`` dirty. On bf16 rows the memory's
    gradient stays bf16 and the rows' is cast up."""

    @staticmethod
    def forward(ctx, mem, write_w, a, last_access, write_idx, lra_idx, step,
                delta):
        _sparse_write(mem, last_access, write_idx, write_w, a, lra_idx, step,
                      delta)
        ctx.mark_dirty(mem)
        ctx.save_for_backward(write_idx, write_w, a, lra_idx)
        return mem

    @staticmethod
    def backward(ctx, g):
        write_idx, write_w, a, lra_idx = ctx.saved_tensors
        g_w, g_a = write_rows_vjp(
            ref.gather_rows(g, write_idx).to(torch.float32), write_w, a)
        g_mem = _scatter_rows(g.clone(), lra_idx, g.new_zeros(a.shape), "set")
        return g_mem, g_w, g_a, None, None, None, None, None


class _SparseWriteQ(torch.autograd.Function):
    """`_sparse_write_q_vjp`: the int8 write, in place on the codes, the
    usage table and the scales. Only the scales' output is
    differentiable: its backward (`write_q_vjp`) hands w and a their
    gradients, zeroes the touched rows of the scales' gradient (their
    scales were overwritten) and adds back the old scales' gradient at
    the winning column of each row. It saves the touched rows' old codes
    and scales (O(J·W)), not the memory."""

    @staticmethod
    def forward(ctx, mem_scale, write_w, a, mem, last_access, write_idx,
                lra_idx, step, delta):
        old_q = ref.gather_rows(mem, write_idx)
        old_s = ref.gather_rows(mem_scale[..., None], write_idx)[..., 0]
        _sparse_write(mem, last_access, write_idx, write_w, a, lra_idx, step,
                      delta, mem_scale)
        ctx.mark_dirty(mem_scale, mem, last_access)
        ctx.mark_non_differentiable(mem, last_access)
        ctx.save_for_backward(old_q, old_s, write_idx, lra_idx, write_w, a)
        return mem, last_access, mem_scale

    @staticmethod
    def backward(ctx, _, __, g_scale):
        old_q, old_s, write_idx, lra_idx, write_w, a = ctx.saved_tensors
        g_old_s, g_w, g_a = write_q_vjp(
            winners(g_scale[..., None], write_idx)[..., 0], old_q, old_s,
            write_idx, lra_idx, write_w, a)
        # Each touched row's scale was overwritten: its gradient is the old
        # scale's, which only the winning column carries ('set', last wins).
        g_s = _scatter_rows(g_scale.clone()[..., None], write_idx,
                            g_old_s[..., None], "set")[..., 0]
        return g_s, g_w, g_a, None, None, None, None, None, None
