"""Device dispatch of the memory ops (the f32, single-device part of
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

Storage dtypes: the reads and the write take f32, bf16 or int8 rows (int8
with ``mem_scale=``, the (B, rows) f32 per-row scales, which the int8
write updates and returns). bf16 and int8 rows run forward only: when
autograd records on such a memory the op raises
(`types.DTYPE_TRAINING_ITEM`) rather than build a gradient the JAX
package computes otherwise. `lsh_hash` takes f32; its callers upcast.

When autograd records (grad enabled and an input requires grad), each op
runs inside a `torch.autograd.Function` whose backward is the closed-form
VJP of the JAX package's custom VJP (`repro/kernels/ops.py:318-364`,
`:481-506`, `:587-622`); otherwise the op runs bare. These dense
gradients are what the naive unroll (`core/unroll.py`) differentiates
through: each step's memory gradient is a (B, N+1, W) tensor. The
sparse-rollback engine does not use them; it keeps one memory cotangent
for the whole backward (`core/cell.py`).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import require_f32_rows
from repro_torch.kernels import ref
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
              valid_n: int | None = None):
    """q: (B, H, W), mem: (B, rows, W) f32 -> (vals (B, H, K) f32, idx
    (B, H, K) int32): the K rows among [0, valid_n) of highest cosine
    similarity, by (similarity desc, index asc). A selection: it has no
    gradient and raises when autograd records (the caller detaches)."""
    if _records(q, mem):
        raise ValueError("topk_read is a selection and has no gradient: "
                         "pass detached q and mem")
    if _on_cpu(mem):
        return ref.topk_read_ref(q, mem, k, valid_n=valid_n)
    return topk_read_kernel(q.contiguous(), mem, k=k, valid_n=valid_n)


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


def _flash_attention(q, k, v):
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v)
    return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_block: int | None = None) -> torch.Tensor:
    """Causal GQA attention: q (B, S, H, D), k, v (B, S, Hkv, D), f32 or
    bf16 -> (B, S, H, D) in q's dtype (`ref.flash_attention_ref` on the
    CPU, `csrc/flash_attention.cu` on the card). Differentiable in q, k
    and v: the backward (`_FlashAttention`) is plain PyTorch in blocks of
    ``q_block`` query rows (default: all S), as the TPU kernel has no
    backward either (the JAX package differentiates `chunked_attention`)."""
    if _records(q, k, v):
        return _FlashAttention.apply(q, k, v, q_block or q.shape[1])
    return _flash_attention(q, k, v)


class _FlashAttention(torch.autograd.Function):
    """The forward is the kernel (or its plain version); it saves q, k and
    v only. The backward recomputes the scores of one block of
    ``q_block`` query rows at a time against the keys up to the block's
    end, in f32, so it never holds the whole (B, H, S, S) at full width:
    with P = softmax(S), dV += Pᵀ·dO, dP = dO·Vᵀ, dS = P ∘ (dP - rowsum(P
    ∘ dP)), dQ = dS·K·D^-0.5, dK += dSᵀ·Q·D^-0.5; a kv head's gradients
    sum over its group of query heads."""

    @staticmethod
    def forward(ctx, q, k, v, q_block):
        ctx.save_for_backward(q, k, v)
        ctx.q_block = q_block
        return _flash_attention(q, k, v)

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
        dv = torch.zeros_like(dk)
        pos = torch.arange(S, device=q.device)
        for lo in range(0, S, ctx.q_block):
            hi = min(lo + ctx.q_block, S)
            qb = q[:, lo:hi].to(ct).reshape(B, hi - lo, Hkv, H // Hkv, D)
            gb = g[:, lo:hi].to(ct).reshape(qb.shape)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf[:, :hi]) * scale
            causal = pos[lo:hi, None] >= pos[None, :hi]
            p = torch.softmax(torch.where(causal, s, -1e30), dim=-1)
            del s
            dv[:, :hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, gb)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", gb, vf[:, :hi])
            ds = p.mul_(dp.sub_((p * dp).sum(-1, keepdim=True)))
            del dp
            dq[:, lo:hi] = torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                        kf[:, :hi]).reshape(
                                            B, hi - lo, H, D) * scale
            dk[:, :hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


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
    and returns *signed* indices. Differentiable in q, mem and beta on f32
    rows; the selection is not."""
    if _records(q, mem, beta, mem_scale):
        require_f32_rows(mem, mem_scale, what="autograd through fused_read")
        return _FusedRead.apply(q, mem, beta, k, valid_n, cand_idx)
    return _fused_read(q, mem, beta, k, valid_n, cand_idx, mem_scale)


class _FusedRead(torch.autograd.Function):
    """`_fused_read_sweep_vjp` and `_fused_read_cand_vjp`: the backward
    re-derives the read's tail from the recorded (signed) indices. It
    saves the K gathered rows, never the memory, so later in-place writes
    leave it valid. An invalid selection (-1) gathers row 0 with weight
    exactly 0 and gives it no gradient."""

    @staticmethod
    def forward(ctx, q, mem, beta, k, valid_n, cand_idx):
        read, w, idx = _fused_read(q, mem, beta, k, valid_n, cand_idx)
        ctx.save_for_backward(q, beta, idx,
                              ref.gather_rows(mem, idx.clamp_min(0)))
        ctx.mem_shape = mem.shape
        ctx.mark_non_differentiable(idx)
        return read, w, idx

    @staticmethod
    def backward(ctx, g_read, g_w, _):
        q, beta, idx, words = ctx.saved_tensors
        valid = idx >= 0
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, words, beta)]
            out = ref.read_tail_rows(*leaves, valid)
            g_q, g_words, g_beta = torch.autograd.grad(out, leaves,
                                                       (g_read, g_w))
        g_mem = None
        if ctx.needs_input_grad[1]:
            B, W = q.shape[0], q.shape[-1]
            g_words = torch.where(valid[..., None], g_words, 0.0)
            g_mem = g_words.new_zeros(ctx.mem_shape)
            _scatter_rows(g_mem, idx.clamp_min(0).reshape(B, -1),
                          g_words.reshape(B, -1, W), "add")
        return g_q, g_mem, g_beta, None, None, None


# --------------------------------------------------------------------------
# Row scatter
# --------------------------------------------------------------------------

def _scatter_rows(mem, idx, rows, mode):
    idx, rows = idx.contiguous(), rows.contiguous()
    if _on_cpu(mem):
        return ref.scatter_rows_ref(mem, idx, rows, mode)
    return scatter_rows_kernel(mem, idx, rows, mode=mode)


def scatter_rows(mem: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                 mode: str = "add") -> torch.Tensor:
    """mem: (B, R, W) f32, idx: (B, J) int32, rows: (B, J, W), in place.
    'add' sums duplicate columns into their row in j order; 'set' keeps
    the last (sequential semantics, j ascending). No other row is touched,
    so a (B, N+1, W) buffer's scratch row N needs no parking duty. Returns
    ``mem``; differentiable in mem and rows."""
    if _records(mem, rows):
        return _ScatterRows.apply(mem, rows, idx, mode)
    return _scatter_rows(mem, idx, rows, mode)


class _ScatterRows(torch.autograd.Function):
    """`_scatter_rows_vjp`: 'add' passes the memory's gradient through and
    hands each column its target row's gradient; 'set' zeroes the
    overwritten rows and hands the gradient only to the column that
    survived (the last of each duplicate set). No training path records
    it (the replay's scatters run on a memory outside the graph,
    `core/cell.py`); it is the port of the JAX op's VJP, held against
    `jax.vjp` in the CPU tests."""

    @staticmethod
    def forward(ctx, mem, rows, idx, mode):
        _scatter_rows(mem, idx, rows, mode)
        ctx.mark_dirty(mem)
        ctx.save_for_backward(idx)
        ctx.mode = mode
        return mem

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        g_rows = ref.gather_rows(g, idx)
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


def sparse_write_update(mem, last_access, write_idx, write_w, a, lra_idx,
                        step, *, delta: float, mem_scale=None):
    """The fused LRA erase + w^W a^T scatter-add + usage stamp, in place on
    ``mem`` (B, N+1, W) and ``last_access`` (B, N+1). ``mem`` holds f32 or
    bf16 rows, or int8 rows with their scales ``mem_scale`` (B, N+1) f32,
    which the write re-quantizes in place. Returns (mem, last_access), or
    (mem, last_access, mem_scale) with ``mem_scale``. On f32 rows the
    memory is differentiable in mem, write_w and a, the usage table not
    (the paper passes no gradient through U^(2))."""
    if _records(mem, write_w, a, mem_scale):
        require_f32_rows(mem, mem_scale,
                         what="autograd through sparse_write_update")
        mem = _SparseWrite.apply(mem, write_w, a, last_access, write_idx,
                                 lra_idx, step, delta)
        return mem, last_access
    return _sparse_write(mem, last_access, write_idx, write_w, a, lra_idx,
                         step, delta, mem_scale)


class _SparseWrite(torch.autograd.Function):
    """`_sparse_write_vjp`: w_j and a_h read the output gradient at their
    target rows (before the erase zeroes it); the memory's gradient passes
    through except on the erased rows. Needs no memory residual, so the
    write runs in place and marks ``mem`` dirty."""

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
        g_w, g_a = write_rows_vjp(ref.gather_rows(g, write_idx), write_w, a)
        g_mem = _scatter_rows(g.clone(), lra_idx, g.new_zeros(a.shape), "set")
        return g_mem, g_w, g_a, None, None, None, None, None
