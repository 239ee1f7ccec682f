"""Train, prefill and serve steps of the LM, the port of the JAX package's
`launch/steps.py`.

`make_train_step` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and its gradient by autograd
(``accum`` > 1 sums the gradients of ``accum`` equal microbatches in f32
and divides), optionally the gradients' int8 round trip
(``compress_pod_grads``), global-norm clipping, the cosine schedule at the
optimizer's count, and AdamW. The parameters and the optimizer state are
updated in place and returned, as JAX's `train` donates them to its jitted
step: at StarCoder2-7B's width a second copy would not fit beside them.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed.compression import int8_roundtrip
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as opt


def value_and_grad(params, cfg: ModelConfig, batch):
    """(loss, metrics, grads) of `lm.loss_fn`; grads in the parameters'
    tree, zero for a leaf the loss does not reach."""
    leaves, spec = pytree.tree_flatten(params)
    diff = [t.detach().requires_grad_() for t in leaves]
    loss, metrics = lm.loss_fn(pytree.tree_unflatten(diff, spec), cfg, batch)
    grads = torch.autograd.grad(loss, diff, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(diff, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            pytree.tree_unflatten(grads, spec))


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, accum: int = 1,
                    max_grad_norm: float = 1.0, warmup: int = 100,
                    total_steps: int = 10000,
                    compress_pod_grads: bool = False):
    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = value_and_grad(params, cfg, batch)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                     for k, v in batch.items()}
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=pytree.tree_leaves(params)[0].device)
            for i in range(accum):
                l_i, _, g = value_and_grad(
                    params, cfg, {k: v[i] for k, v in micro.items()})
                grads = pytree.tree_map(torch.add, grads, g)
                loss = loss + l_i
                del g
            grads = pytree.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        if compress_pod_grads:
            grads = pytree.tree_map(int8_roundtrip, grads)
        grads, gnorm = opt.clip_by_global_norm(grads, max_grad_norm)
        step_lr = opt.cosine_schedule(opt_state.count, base_lr=lr,
                                      warmup=warmup, total=total_steps)
        opt_state = opt.adamw_update_(params, grads, opt_state, lr=step_lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": step_lr, **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cfg, cache, tokens)
    return serve_step
