"""RWKV-6 "Finch" blocks of the LM, the JAX package's `models/rwkv.py`
function for function: the time-mix (a data-dependent token-shift lerp,
a data-dependent decay and the WKV recurrence) and the squared-ReLU
channel-mix.

The WKV recurrence S_t = diag(w_t)·S_{t-1} + kᵀ_t v_t is a loop over time
on f32 r, k, v, w with the state (B, H, D, D), plain PyTorch, as JAX's
`lax.scan` is plain JAX (no Pallas kernel): a step is a few elementwise
launches and one read-out. A decode is one step, O(1) in the sequence
length; its read-out sums in a fixed order (`attention._tree_sum`) so a
lane's bits do not depend on how many lanes the batch holds (the
engine's rescale is bit for bit), the prefill's is a batched product.

Dtypes follow JAX's promotion: the projections run in the promoted dtype
of the stream and the weights (f32 after a memory group's read), the
decay and the recurrence in f32, the recurrence's output cast back to the
stream's dtype before ``ln_x`` (an RMS norm over all of d, not a
per-head group norm). The caller owns the states: `time_mix` and
`channel_mix` return new ones."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _tree_sum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum, pdef, rms_norm

# The lerp's LoRA splits, in the order of JAX's `_ddlerp`.
_MIX_ORDER = ("mu_w", "mu_k", "mu_v", "mu_r", "mu_g")


def rwkv_defs(cfg: ModelConfig):
    """One block's time-mix ``tm`` and channel-mix ``cm`` leaves. ``mix_b``
    is (5·mix_lora, 5·d) as in JAX, of which `_ddlerp` reads only the five
    diagonal (mix_lora, d) blocks (ROADMAP §C)."""
    d = cfg.d_model
    r = cfg.rwkv
    H = d // r.head_size
    mix = {name: pdef((d,), init="zeros")
           for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_x")}
    return {
        "tm": {
            **mix,
            "mix_a": pdef((d, r.mix_lora * 5)),
            "mix_b": pdef((r.mix_lora * 5, d * 5), init="zeros"),
            "wr": pdef((d, d)),
            "wk": pdef((d, d)),
            "wv": pdef((d, d)),
            "wg": pdef((d, d)),
            "wo": pdef((d, d)),
            "decay_base": pdef((d,), init="zeros"),
            "decay_a": pdef((d, r.decay_lora)),
            "decay_b": pdef((r.decay_lora, d), init="zeros"),
            "bonus": pdef((H, r.head_size), init="zeros"),
            "ln_x": pdef((d,), init="zeros"),
        },
        "cm": {
            "mu_k2": pdef((d,), init="zeros"),
            "mu_r2": pdef((d,), init="zeros"),
            "wk2": pdef((d, cfg.d_ff)),
            "wv2": pdef((cfg.d_ff, d)),
            "wr2": pdef((d, d)),
        },
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) shifted right by one position; ``last`` (B, d) fills
    position 0."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, xs: torch.Tensor):
    """The data-dependent lerp: (xw, xk, xv, xr, xg), each x + (xs - x)·μ
    with μ its ``mu_*`` plus its LoRA split through its diagonal block of
    ``mix_b``."""
    d = x.shape[-1]
    delta = xs - x
    base = x + delta * p["mu_x"]
    lora = torch.tanh(einsum("bsd,df->bsf", base, p["mix_a"]))
    ml = p["mix_a"].shape[-1] // 5
    outs = []
    for i, name in enumerate(_MIX_ORDER):
        wb = p["mix_b"][i * ml:(i + 1) * ml, i * d:(i + 1) * d]
        mu = p[name] + einsum("bsf,fd->bsd", lora[..., i * ml:(i + 1) * ml],
                              wb)
        outs.append(x + delta * mu)
    return outs


def wkv_scan(r, k, v, w, u, state, *, fixed_order: bool = False):
    """r, k, v, w (B, S, H, D) f32, w the decay in (0, 1); u (H, D) the
    bonus; state (B, H, D, Dv) f32. Each step reads out r·(S + u·kᵀv) and
    then S ← w·S + kᵀv. ``fixed_order`` sums the read-out in
    `_tree_sum`'s order (the decode's). Returns (out (B, S, H, Dv), the
    new state); ``state`` is not written."""
    ub = u[None, :, :, None]
    outs = []
    for r_t, k_t, v_t, w_t in zip(*(t.unbind(1) for t in (r, k, v, w))):
        kv = k_t.unsqueeze(-1) * v_t.unsqueeze(-2)        # (B, H, D, Dv)
        a = state + ub * kv
        if fixed_order:
            outs.append(_tree_sum((r_t.unsqueeze(-1) * a).transpose(-1, -2)))
        else:
            outs.append(torch.matmul(r_t.unsqueeze(-2), a).squeeze(-2))
        state = w_t.unsqueeze(-1) * state + kv
    return torch.stack(outs, dim=1), state


def time_mix(p, cfg: ModelConfig, x: torch.Tensor, shift_state: torch.Tensor,
             wkv_state: torch.Tensor, *, fixed_order: bool = False):
    """x (B, S, d) -> (out (B, S, d), the new shift state x[:, -1], the new
    WKV state (B, H, D, D) f32)."""
    B, S, d = x.shape
    H, D = d // cfg.rwkv.head_size, cfg.rwkv.head_size
    xs = _token_shift(x, shift_state)
    xw, xk, xv, xr, xg = _ddlerp(p, x, xs)
    r = einsum("bsd,de->bse", xr, p["wr"]).reshape(B, S, H, D)
    k = einsum("bsd,de->bse", xk, p["wk"]).reshape(B, S, H, D)
    v = einsum("bsd,de->bse", xv, p["wv"]).reshape(B, S, H, D)
    g = F.silu(einsum("bsd,de->bse", xg, p["wg"]))
    decay = p["decay_base"] + einsum(
        "bsf,fd->bsd", torch.tanh(einsum("bsd,df->bsf", xw, p["decay_a"])),
        p["decay_b"])
    w = torch.exp(-torch.exp(decay.float())).reshape(B, S, H, D)
    out, wkv_state = wkv_scan(r.float(), k.float(), v.float(), w,
                              p["bonus"], wkv_state, fixed_order=fixed_order)
    out = out.reshape(B, S, d).to(x.dtype)
    out = rms_norm(out, p["ln_x"], cfg.norm_eps) * g
    return einsum("bsd,de->bse", out, p["wo"]), x[:, -1], wkv_state


def channel_mix(p, cfg: ModelConfig, x: torch.Tensor,
                shift_state: torch.Tensor):
    """x (B, S, d) -> (sigmoid(xr·wr2) ∘ (relu(xk·wk2)²·wv2), the new shift
    state x[:, -1])."""
    xs = _token_shift(x, shift_state)
    xk = x + (xs - x) * p["mu_k2"]
    xr = x + (xs - x) * p["mu_r2"]
    k = torch.square(F.relu(einsum("bsd,df->bsf", xk, p["wk2"])))
    return (torch.sigmoid(einsum("bsd,de->bse", xr, p["wr2"]))
            * einsum("bsf,fd->bsd", k, p["wv2"])), x[:, -1]


def rwkv_state_shapes(cfg: ModelConfig, batch: int):
    """One layer's decode state: the two token-shift rows and the WKV
    state (f32, `lm.init_cache`)."""
    d = cfg.d_model
    H, D = d // cfg.rwkv.head_size, cfg.rwkv.head_size
    return {"tm_shift": (batch, d), "wkv": (batch, H, D, D),
            "cm_shift": (batch, d)}
