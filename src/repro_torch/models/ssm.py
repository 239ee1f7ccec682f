"""Mamba-style selective SSM head of Hymba's hybrid blocks, the JAX
package's `models/ssm.py` function for function.

A diagonal selective state space: h_t = exp(Δ_t·A)⊙h_{t-1} + Δ_t·B_t·x_t,
y_t = C_t·h_t + D·x_t, after a causal depthwise conv of the input and
gated by silu(z). The prefill runs the recurrence as JAX's
`lax.associative_scan` does (`_scan_assoc`: the same recursion, so both
sides add the same terms in the same tree), the decode as one state
update, O(1) in the length, its Σ_n h·C in `attention._tree_sum`'s fixed
order and its products through `layers.lane_einsum`, so a lane's bits do
not depend on how many lanes the batch holds.
Plain PyTorch, as JAX's is plain JAX (no Pallas kernel).

Dtypes follow JAX's: the projections, the conv and Δ run in the promoted
dtype of the stream and the weights, Δ·x is formed there before it is
cast to f32; A, exp(Δ·A), Δ·B·x and h are f32; y + x·D is taken in f32
and cast to the stream's dtype before the gate. The caller owns the
states: `ssm_apply` returns new ones."""
from __future__ import annotations

import torch

from repro_torch.models.attention import _tree_sum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum, lane_einsum, pdef


def ssm_defs(cfg: ModelConfig, d_inner: int):
    s = cfg.ssm
    d = cfg.d_model
    return {
        "in_proj": pdef((d, 2 * d_inner)),
        "conv_w": pdef((s.conv_width, d_inner), scale=0.5),
        "conv_b": pdef((d_inner,), init="zeros"),
        "x_proj": pdef((d_inner, s.dt_rank + 2 * s.state_size)),
        "dt_proj": pdef((s.dt_rank, d_inner)),
        "dt_bias": pdef((d_inner,), init="zeros"),
        "a_log": pdef((d_inner, s.state_size), init="zeros"),
        "d_skip": pdef((d_inner,), init="ones"),
        "out_proj": pdef((d_inner, d)),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x·sigmoid(x)."""
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (torch's softplus switches to
    x above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            state=None):
    """Causal depthwise conv. x (B, S, D), w (K, D), state (B, K-1, D):
    the last K-1 inputs before x (zeros without one). The K taps sum in
    Python's `sum` order, then + b, as JAX's. Returns (out, the new state:
    the last K-1 inputs, in x's dtype)."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    return out, (xp[:, -(K - 1):] if K > 1 else pad)


def _scan(a: torch.Tensor, b: torch.Tensor, need_a: bool):
    """JAX's `associative_scan` recursion along axis 1 with the combine
    (a1, b1)·(a2, b2) = (a1·a2, a2·b1 + b2): combine the pairs (0::2 with
    1::2), scan the halves, form the evens from the odds, interleave. The
    a's of the result only where ``need_a`` (an outer level reads them)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_lo, a_hi = a[:, 0:n - 1:2], a[:, 1::2]
    odd_a, odd_b = _scan(a_lo * a_hi, a_hi * b[:, 0:n - 1:2] + b[:, 1::2],
                         True)
    m = (n - 1) // 2              # the evens after the first
    a_ev, b_ev = a[:, 2::2], b[:, 2::2]
    out_b = torch.empty_like(b)
    out_b[:, :1] = b[:, :1]
    out_b[:, 1::2] = odd_b
    out_b[:, 2::2] = a_ev * odd_b[:, :m] + b_ev
    if not need_a:
        return None, out_b
    out_a = torch.empty_like(a)
    out_a[:, :1] = a[:, :1]
    out_a[:, 1::2] = odd_a
    out_a[:, 2::2] = odd_a[:, :m] * a_ev
    return out_a, out_b


def _scan_assoc(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + bx_t along axis 1 from h_{-1} = 0, through
    JAX's recursion (`_scan`)."""
    return _scan(a, bx, False)[1]


def ssm_apply(p, cfg: ModelConfig, x: torch.Tensor, *, conv_state=None,
              ssm_state=None, decode: bool = False):
    """x (B, S, d) -> (y (B, S, d), the new conv state (B, K-1, d_inner) in
    x's dtype, the new SSM state (B, d_inner, N) f32). The prefill folds a
    carried ``ssm_state`` into its first step; the decode (S = 1) is one
    state update."""
    s = cfg.ssm
    mm = lane_einsum if decode else einsum
    xin, z = mm("bsd,de->bse", x, p["in_proj"]).chunk(2, dim=-1)
    xc, conv_state = _conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = _silu(xc)

    proj = mm("bse,ef->bsf", xc, p["x_proj"])
    dt = _softplus(mm("bsr,re->bse", proj[..., :s.dt_rank], p["dt_proj"])
                   + p["dt_bias"])
    Bmat = proj[..., s.dt_rank:s.dt_rank + s.state_size]
    Cmat = proj[..., s.dt_rank + s.state_size:].float()

    A = -torch.exp(p["a_log"].float())                     # (Din, N)
    da = torch.exp(dt.float()[..., None] * A)              # (B, S, Din, N)
    dbx = (dt * xc).float()[..., None] * Bmat.float()[..., None, :]

    if decode:
        h = da[:, 0] * ssm_state + dbx[:, 0]
        ssm_state = h
        y = _tree_sum(h * Cmat[:, 0, None, :])[:, None]
    else:
        if ssm_state is not None:
            dbx[:, 0] += da[:, 0] * ssm_state
        h = _scan_assoc(da, dbx)
        del da, dbx
        ssm_state = h[:, -1].clone()
        y = torch.einsum("bsdn,bsn->bsd", h, Cmat)
        del h
    y = (y + xc.float() * p["d_skip"]).to(x.dtype)
    y = y * _silu(z)
    return mm("bse,ed->bsd", y, p["out_proj"]), conv_state, ssm_state
