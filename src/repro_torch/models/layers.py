"""Common layers and the parameter declarations of the LM, the JAX
package's `models/layers.py`.

Every parameter is declared once as ``pdef(shape, init, scale)``; `stack_defs`
adds a leading stacked-layers axis and `init_from_defs` draws the weights
from a `torch.Generator`. Dtype flow follows JAX's promotion exactly, and
PyTorch's einsum takes one dtype, so it is written out: `peinsum` emits its
first operand's dtype (the JAX package's ``preferred_element_type``), and
`einsum` the promoted dtype of its operands (``jnp.einsum``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ('float32' or 'bfloat16') as a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter: ``init`` 'normal' draws N(0, 1) times ``scale`` or,
    without one, fan_in^-0.5 with fan_in = shape[0] (the leading axis: for
    a stacked parameter, the number of stacked layers, as in the JAX
    package); 'zeros' and 'ones' fill."""
    shape: tuple
    init: str = "normal"
    scale: Optional[float] = None

    def initialize(self, generator: torch.Generator, dtype, device):
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        scale = self.scale if self.scale is not None else fan_in ** -0.5
        if len(self.shape) == 1:
            return (torch.randn(self.shape, generator=generator,
                                device=device) * scale).to(dtype)
        out = torch.empty(self.shape, dtype=dtype, device=device)
        fill_normal(out, generator, scale)
        return out


# The most bytes a slice drawn at once in f32 may take (8 GiB).
DRAW_LIMIT = 8 << 30


def fill_normal(out: torch.Tensor, generator: torch.Generator, scale: float,
                limit: int = DRAW_LIMIT) -> None:
    """Fill ``out`` (2-D or more) with N(0, 1) times ``scale``, drawn in f32
    slice by slice of its leading axis and cast, so a stacked leaf never
    exists in f32 whole. A slice of more than ``limit`` bytes in f32 is
    itself filled slice by slice of its own leading axis (one layer's
    routed experts of Llama-4, (128, 5120, 8192), are 21.5 GB in f32); a
    slice within the limit is drawn whole, so the draws of a leaf whose
    slices all stay within it do not depend on the limit."""
    for i in range(out.shape[0]):
        if out.dim() > 2 and out[i].numel() * 4 > limit:
            fill_normal(out[i], generator, scale, limit)
        else:
            out[i] = torch.randn(out.shape[1:], generator=generator,
                                 device=out.device) * scale


def pdef(shape, init="normal", scale=None) -> ParamDef:
    return ParamDef(tuple(shape), init, scale)


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def stack_defs(defs, num: int):
    """Add a leading stacked-layers axis of size ``num`` to every def."""
    return _map_defs(lambda d: ParamDef((num,) + d.shape, d.init, d.scale),
                     defs)


def init_from_defs(defs, generator: torch.Generator, dtype, device):
    """Draw every leaf, in sorted key order, from ``generator``."""
    if isinstance(defs, ParamDef):
        return defs.initialize(generator, dtype, device)
    return {k: init_from_defs(defs[k], generator, dtype, device)
            for k in sorted(defs)}


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ----------------------------- layer math --------------------------------

def einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``: both operands in their promoted dtype."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(ct), b.to(ct))


def peinsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``peinsum``: computed in the operands' promoted
    dtype (f32 when an f32 activation meets a bf16 weight), emitted in the
    first operand's dtype."""
    return einsum(spec, a, b).to(a.dtype)


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, kept: `mean(-1)`, but for the decode's
    rows on the card. A decode's (B, 1, d) holds so few rows that the card
    splits each across thread blocks by their count, so a row's bits would
    depend on how many lanes the batch holds (the engine's rescale is bit
    for bit); there a row is summed as gcd(d, 64) contiguous pieces and
    then their sum, two short reductions whose order its length alone
    sets. The CPU sums a row in one thread."""
    d = x.shape[-1]
    if not x.is_cuda or x.dim() < 2 or x.shape[-2] != 1:
        return x.mean(-1, keepdim=True)
    g = math.gcd(d, 64)
    return x.unflatten(-1, (g, d // g)).sum(-1).sum(-1, keepdim=True) / d


# A decode's products on the card run at a multiple of this many rows.
LANE_ROWS = 8


def lane_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`einsum` of a decode's rows a (B, 1, ...) with a weight b, its rows
    the same bits in any batch. cuBLAS picks a product's kernel, and so
    its summation order, by the row count: at Hymba's widths the SSM's
    projections and the head (d 1600 to 32001) give a lane other bits
    among 2 lanes than among 4. On the card the lanes are padded with
    zero rows to a multiple of LANE_ROWS, so every batch of up to 8 lanes
    (in general, of one multiple of 8) runs the same kernel; the CPU sums
    a row alike at any count."""
    B = a.shape[0]
    pad = -B % LANE_ROWS
    if not a.is_cuda or not pad:
        return einsum(spec, a, b)
    a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return einsum(spec, a, b)[:B]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """f32 RMS norm scaled by **1 + scale**, in x's dtype; the mean of
    squares by `row_mean`."""
    xf = x.float()
    y = xf * torch.rsqrt(row_mean(xf.square()) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding of x (..., S, H, D) at ``positions`` (..., S): the
    two **halves** of the head dim rotate against each other (not
    interleaved pairs), in f32; returns x's dtype."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exponent)
    angles = positions[..., None].to(torch.float32) * freq
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_defs(d_in: int, d_hidden: int, gated: bool = False):
    defs = {"w1": pdef((d_in, d_hidden)), "w2": pdef((d_hidden, d_in))}
    if gated:
        defs["w3"] = pdef((d_in, d_hidden))
    return defs


def mlp_apply(params, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    """x (B, S, d) -> (B, S, d). Without ``w3`` the GELU MLP, w2 ·
    gelu(w1 · x), GELU the tanh approximation (`jax.nn.gelu`'s default).
    With ``w3`` the gated MLP of ``act``: 'silu' (llama's), w2 · (silu(w1
    · x) ∘ (w3 · x)), or 'geglu' (gemma's), w2 · (gelu(w1 · x) ∘ (w3 ·
    x)) with the same tanh GELU."""
    h = peinsum("bsd,df->bsf", x, params["w1"])
    if "w3" in params:
        if act == "silu":
            gate = F.silu(h)
        elif act == "geglu":
            gate = F.gelu(h, approximate="tanh")
        else:
            raise ValueError(f"no gated MLP of activation {act!r}: "
                             f"expected 'silu' or 'geglu'")
        h = gate * peinsum("bsd,df->bsf", x, params["w3"])
    else:
        h = F.gelu(h, approximate="tanh")
    return peinsum("bsf,fd->bsd", h, params["w2"])


def embed_defs(vocab_size: int, d_model: int):
    return {"tok": pdef((vocab_size, d_model), scale=1.0)}


def embed_apply(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["tok"].to(dtype)[tokens.long()]
