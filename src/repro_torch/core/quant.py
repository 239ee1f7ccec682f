"""Per-row symmetric int8 quantization of memory rows, the port's own copy
of `repro/core/quant.py` (`SCALE_DTYPE`, `QMAX`, `quantize_rows`,
`dequantize_rows`).

``scale = max|row| / 127`` with no epsilon, so an all-zero row quantizes
to ``(q = 0, scale = 0.0)`` and dequantizes to exactly 0.0. The scale is
formed as the compiled JAX reference forms it: XLA rewrites the division
by the constant 127 into a product with its f32 reciprocal (``jax.jit`` of
`repro.core.quant.quantize_rows` gives ``max|row| · fl(1/127)``, which
differs from a true division by one ulp in about 5 % of rows), so the
port multiplies by ``fl(1/127)`` too. ``q = clip(round(row / scale),
-127, 127)`` is a true division by the scale (a product with its
reciprocal rounds differently), and ``torch.round`` rounds half to even,
as ``jnp.round`` and CUDA's ``rintf`` do. The CUDA int8 write
(`csrc/sparse_write.cu`) repeats this arithmetic.

The codes carry no gradient; the scale is differentiable through the row's
max (`scale_vjp`), the magnitude channel that int8 rows train through.
"""
from __future__ import annotations

import torch

# Scales stay f32: a narrower scale would quantize the scales too.
SCALE_DTYPE = torch.float32
QMAX = 127.0
# fl(1/127) in f32, the factor XLA's compiled ``max / 127`` multiplies by.
INV_QMAX = 1.0 / QMAX


def quantize_rows(x: torch.Tensor):
    """x: (..., W) float -> (q (..., W) int8, scale (...,) f32)."""
    xf = x.to(torch.float32)
    scale = (xf.abs().amax(-1) * INV_QMAX).to(SCALE_DTYPE)
    # A zero row divides by 1 instead of 0: q is exactly 0 either way.
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (..., W) int8, scale: (...,) -> (..., W) f32 rows ``q * scale``;
    a scale-0 row gives exactly 0.0."""
    return q.to(torch.float32) * scale.to(SCALE_DTYPE)[..., None]


def scale_vjp(x: torch.Tensor, g_scale: torch.Tensor) -> torch.Tensor:
    """The gradient of `quantize_rows`'s scale ``max|x| · fl(1/127)`` with
    respect to the rows x (..., W), given the scale's cotangent g_scale
    (...,): JAX's subgradient of ``max``, the cotangent split evenly among
    the tied maxima of |x|, times JAX's derivative of |x|, -1 below 0 and
    +1 from 0 up (so a zero row's W elements, all tied, share it)."""
    ax = x.abs()
    tied = (ax == ax.amax(-1, keepdim=True)).to(x.dtype)
    share = (g_scale * INV_QMAX)[..., None] / tied.sum(-1, keepdim=True)
    return torch.where(x >= 0, share, -share) * tied
