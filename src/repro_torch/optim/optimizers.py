"""RMSProp (the paper's optimizer for the SAM tasks, Suppl. C) and global
norm clipping, the port of `repro/optim/optimizers.py`'s `RMSPropState`,
`rmsprop_init`, `rmsprop_update` and `clip_by_global_norm`.

Written by hand: `torch.optim.RMSprop` divides by ``sqrt(acc) + eps``,
and the JAX package by ``sqrt(acc + eps)``. Parameters, gradients and the
accumulator are trees (nested dicts) of tensors with the same structure;
every function returns new tensors and changes none of its arguments.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree


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
