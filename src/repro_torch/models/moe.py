"""Mixture of experts with capacity dispatch, the JAX package's
`models/moe.py`, in plain PyTorch (JAX computes it outside any kernel).

Each token is routed to its top-k experts by the router's f32 softmax:
the k largest probabilities, ties to the lowest expert (`jax.lax.top_k`'s
order, here a stable sort), renormalised to sum to one (over their sum
plus 1e-9, as JAX: at top-1, Llama-4's, the one weight is p / (p +
1e-9)). Its (token,
choice) pairs, taken in token-major order, are ranked within their
expert by a running count, and a pair ranked at or past the capacity C
(`capacity`) is dropped. The kept pairs fill a per-expert buffer (E, C,
d), which the experts' gated MLPs (batched over E) turn into outputs;
each pair's output, weighted by its probability in the stream's dtype,
is gathered back, and a token's k outputs are summed in f32 (`jnp.sum`
upcasts bf16) and cast back. Shared experts, where the config has them,
add a dense gated MLP over every token. The router's load-balancing loss
(Switch's E · Σ_e f_e · p_e, times ``router_aux_weight``) is returned
beside the output.

JAX scatters a dropped pair's zero row onto (expert 0, slot 0) by
addition; here dropped pairs go to a slot past the buffer's end that is
then cut off, so a kept pair at (0, 0) is never touched and nothing is
accumulated. Every sum over a token's choices runs in a fixed order, so
a token's output depends on the others only through its slots (no drop
at decode: C >= 8 >= the lanes)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import pdef, peinsum


def moe_defs(cfg: ModelConfig):
    d, m = cfg.d_model, cfg.moe
    E, f = m.num_experts, m.d_expert
    defs = {"router": pdef((d, E), scale=0.02),
            "w1": pdef((E, d, f)), "w3": pdef((E, d, f)),
            "w2": pdef((E, f, d))}
    if m.shared_experts:
        ds = m.shared_experts * f
        defs["shared"] = {"w1": pdef((d, ds)), "w3": pdef((d, ds)),
                          "w2": pdef((ds, d))}
    return defs


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert has for ``tokens`` tokens: tokens·k·capacity_factor
    / E, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row of probs (T, E),
    largest first and, among equal values, the lowest index first
    (`jax.lax.top_k`'s order; `torch.topk` promises none on the card)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _sum_choices(t: torch.Tensor) -> torch.Tensor:
    """Σ over axis 1 of t (T, K, ...) in f32, choice 0 first."""
    acc = t[:, 0].float()
    for j in range(1, t.shape[1]):
        acc = acc + t[:, j].float()
    return acc


def _rank_in_expert(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each pair's rank among the pairs of its expert, in the order of
    ``flat_e`` (T·K,): JAX's running count of a one-hot (T·K, E), taken
    here as the pair's place in a stable sort by expert less its expert's
    first place, which never forms the (T·K, E) scan."""
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(flat_e.numel(), device=flat_e.device) \
        - first[flat_e[order]]
    return rank


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU for 'silu', else the tanh GELU (JAX's ``jax.nn.gelu``)."""
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor, act: str):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, the router's aux loss, a
    () f32 tensor); see the module docstring. The capacity counts all B·S
    tokens."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, K = B * S, m.num_experts, m.top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, d)

    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    top_p, top_e = top_k(probs, K)
    top_p = top_p / (_sum_choices(top_p) + 1e-9)[:, None]

    fe = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = E * (fe * probs.mean(0)).sum() * m.router_aux_weight

    flat_e = top_e.reshape(-1)                                # (T·K,)
    flat_p = top_p.reshape(-1)
    pos = _rank_in_expert(flat_e, E)
    keep = pos < C
    buf = xt.new_zeros((E, C + 1, d))             # slot C: the dropped pairs
    buf[flat_e, torch.where(keep, pos, C)] = xt.repeat_interleave(K, dim=0)
    buf = buf[:, :C]

    h = _act(peinsum("ecd,edf->ecf", buf, params["w1"]), act) \
        * peinsum("ecd,edf->ecf", buf, params["w3"])
    out_buf = peinsum("ecf,efd->ecd", h, params["w2"])

    got = out_buf[torch.where(keep, flat_e, 0), torch.where(keep, pos, 0)]
    got = torch.where(keep[:, None], got, 0.0) * flat_p[:, None].to(got.dtype)
    out = _sum_choices(got.reshape(T, K, d)).to(got.dtype).to(x.dtype)

    if m.shared_experts:
        sp = params["shared"]
        hs = _act(peinsum("td,df->tf", xt, sp["w1"]), act) \
            * peinsum("td,df->tf", xt, sp["w3"])
        out = out + peinsum("tf,fd->td", hs, sp["w2"])
    return out.reshape(B, S, d), aux
