"""AdamW (LM training) and RMSProp (the paper's optimizer for the SAM
tasks, Suppl. C), global norm clipping and the cosine schedule: the port
of `repro/optim/optimizers.py`.

Written by hand: `torch.optim.RMSprop` divides by ``sqrt(acc) + eps``,
and the JAX package by ``sqrt(acc + eps)``; `torch.optim.AdamW` decays
the weights before the step, the JAX package adds ``weight_decay · p`` to
the step. Parameters, gradients and the optimizer state are trees (nested
dicts) of tensors with the same structure. Every function returns new
tensors and changes none of its arguments, except `adamw_update_`, which
updates the parameters and the moments in place (the LM's train step: at
full width a second copy of either does not fit beside the first).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree


class AdamWState(NamedTuple):
    mu: object               # f32 first moments, the parameters' tree
    nu: object               # f32 second moments
    count: torch.Tensor      # () int32, the steps taken


def adamw_init(params) -> AdamWState:
    zeros = lambda t: pytree.tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), t)
    return AdamWState(mu=zeros(params), nu=zeros(params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=_device(params)))


def _device(tree) -> torch.device:
    return pytree.tree_leaves(tree)[0].device


def adamw_update_(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
                  eps=1e-8, weight_decay=0.1) -> AdamWState:
    """One AdamW step in place on ``params`` and the moments of ``state``,
    leaf by leaf, in the JAX package's order: the moments, their bias
    corrections 1/(1 - b^c) in f32, then p - lr·(m̂/(√v̂ + eps) + wd·p).
    ``lr`` is a float or a () tensor. Returns the state with the new
    count (the moments are the tensors of ``state``)."""
    c = state.count + 1
    cf = c.float()
    mu_scale = 1.0 / (1 - b1 ** cf)
    nu_scale = 1.0 / (1 - b2 ** cf)

    def leaf(p, g, m, v):
        g = g.float()
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        step = (m * mu_scale).div_((v * nu_scale).sqrt_().add_(eps))
        p32 = p.float()
        p.copy_(p32 - lr * step.add_(p32, alpha=weight_decay))

    # tree_map pairs the trees' leaves by key, whatever their dict order.
    pytree.tree_map(leaf, params, grads, state.mu, state.nu)
    return AdamWState(mu=state.mu, nu=state.nu, count=c)


def adamw_update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """`adamw_update_` on copies: returns (new params, new state)."""
    params = pytree.tree_map(torch.clone, params)
    state = AdamWState(mu=pytree.tree_map(torch.clone, state.mu),
                       nu=pytree.tree_map(torch.clone, state.nu),
                       count=state.count)
    state = adamw_update_(params, grads, state, lr=lr, b1=b1, b2=b2,
                          eps=eps, weight_decay=weight_decay)
    return params, state


class RMSPropState(NamedTuple):
    acc: object


def rmsprop_init(params) -> RMSPropState:
    return RMSPropState(acc=pytree.tree_map(
        lambda x: torch.zeros_like(x, dtype=torch.float32), params))


def rmsprop_update(params, grads, state: RMSPropState, *, lr, decay=0.9,
                   eps=1e-10):
    acc = pytree.tree_map(
        lambda a, g: decay * a + (1 - decay) * g.float().square(),
        state.acc, grads)
    new_params = pytree.tree_map(
        lambda p, g, a: (p.float() - lr * g.float()
                         / torch.sqrt(a + eps)).to(p.dtype),
        params, grads, acc)
    return new_params, RMSPropState(acc=acc)


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    Returns (grads, norm before clipping)."""
    sq = sum(g.float().square().sum() for g in pytree.tree_leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return pytree.tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def cosine_schedule(step: torch.Tensor, *, base_lr, warmup, total):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``, in f32. ``step`` is a () int tensor."""
    step = step.float()
    warm = base_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < warmup, warm, cos)
