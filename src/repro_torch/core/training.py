"""Training harness for the paper's synthetic tasks (§4.2/§4.3: copy,
associative recall, priority sort), the port of `repro/core/training.py`
(`ModelSpec`, `build_model`, `bits_loss`, `bits_error`,
`make_task_train_step`, `train_task`) for the kinds ``sam`` (exact read),
``sam_ann`` (the LSH read) and ``sdnc`` (the sparse DNC), which train
through the sparse-rollback engine by default (`core/unroll.py`), and the
dense baselines ``dam``, ``ntm``, ``lstm`` (`core/dense.py`) and ``dnc``
(`core/dnc.py`), which train by a plain loop under autograd: RMSProp
(paper Suppl. C) on sigmoid cross-entropy over the output bits.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import dense as dense_lib
from repro_torch.core import dnc as dnc_lib
from repro_torch.core import unroll as unroll_lib
from repro_torch.core.cell import SAMCell, SDNCCell
from repro_torch.core.sam import SAMConfig
from repro_torch.core.types import ControllerConfig, MemoryConfig
from repro_torch.data.curriculum import Curriculum
from repro_torch.data.tasks import (associative_recall_task, copy_task,
                                    priority_sort_task)
from repro_torch.optim import optimizers as opt

TASKS = {"copy": copy_task, "associative_recall": associative_recall_task,
         "priority_sort": priority_sort_task}
KINDS = ("sam", "sam_ann", "sdnc", "dam", "ntm", "dnc", "lstm")
# The kinds whose rows take ``MemoryConfig.mem_dtype``.
DTYPE_KINDS = ("sam", "sam_ann", "sdnc")
# Stricter than the reference on purpose (ROADMAP §C): JAX's dense models
# build f32 rows whatever mem_dtype says; the port refuses rather than
# train other rows than the configuration names.
DENSE_DTYPE = ("the dense DAM, NTM, DNC and the LSTM keep f32 rows: the JAX "
               "models ignore mem_dtype, so the port refuses it rather than "
               "silently train f32 rows")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    kind: str                     # sam | sam_ann | sdnc | dam | ntm | dnc | lstm
    memory: MemoryConfig
    controller: ControllerConfig
    # Sparse cells (sam, sam_ann, sdnc): train through the sparse-rollback
    # engine (False -> the naive loop). The dense kinds always run the
    # plain loop.
    sparse_bptt: bool = True
    # Segment length C for the chunked engine: None -> whole-sequence
    # sparse, an int or "auto" -> chunked with O(T/C·state + C·K·W)
    # residuals (core/unroll.py).
    bptt_chunk: Optional[Union[int, str]] = None


def build_model(spec: ModelSpec, *, device="cuda"):
    """Returns (init_params(generator), init_state(batch),
    unroll(params, state, xs)). Kinds ``sam`` and ``sam_ann`` (the SAM cell
    with ``ann="lsh"``) and ``sdnc`` (the sparse DNC, exact or LSH as
    ``memory.ann`` says) train through the sparse-rollback engine behind
    `SAMCell` and `SDNCCell`; ``dam`` and ``ntm`` unroll
    `dense.dense_unroll`, ``dnc`` `dnc.dnc_unroll` and ``lstm`` the bare
    controller, whose state is the batch size, all in a plain loop. Any
    other kind raises. ``memory.mem_dtype`` holds the rows of ``sam``,
    ``sam_ann`` (f32, bf16, int8) and ``sdnc`` (f32, bf16; int8 raises,
    as in JAX) as JAX's `build_model` holds them; the dense kinds raise on
    anything but f32 (`DENSE_DTYPE`)."""
    if spec.kind not in KINDS:
        raise ValueError(f"unknown model kind {spec.kind!r}")
    if spec.memory.mem_dtype != "float32" and spec.kind not in DTYPE_KINDS:
        raise ValueError(f"build_model({spec.kind!r}) with mem_dtype="
                         f"{spec.memory.mem_dtype!r}: {DENSE_DTYPE}")
    if spec.kind in ("dam", "ntm"):
        cfg = dense_lib.DenseConfig(spec.memory, spec.controller,
                                    model=spec.kind)
        return (functools.partial(dense_lib.init_params, cfg=cfg,
                                  device=device),
                functools.partial(dense_lib.init_state, cfg=cfg,
                                  device=device),
                lambda p, s, xs: dense_lib.dense_unroll(p, cfg, s, xs))
    if spec.kind == "dnc":
        cfg = dnc_lib.DNCConfig(spec.memory, spec.controller, sparse=False)
        return (functools.partial(dnc_lib.init_params, cfg=cfg,
                                  device=device),
                functools.partial(dnc_lib.init_state, cfg=cfg, device=device),
                lambda p, s, xs: dnc_lib.dnc_unroll(p, cfg, s, xs))
    if spec.kind == "lstm":
        return (functools.partial(dense_lib.lstm_baseline_init,
                                  cfg=spec.controller, device=device),
                lambda batch: batch,
                lambda p, batch, xs: dense_lib.lstm_baseline_unroll(
                    p, spec.controller, batch, xs))
    if spec.kind == "sdnc":
        cell = SDNCCell(dnc_lib.DNCConfig(spec.memory, spec.controller,
                                          sparse=True))
    else:
        mem = dataclasses.replace(
            spec.memory, ann="lsh" if spec.kind == "sam_ann" else "exact")
        cell = SAMCell(SAMConfig(mem, spec.controller))
    if not spec.sparse_bptt:
        mode, chunk = "naive", None
    elif spec.bptt_chunk is None:
        mode, chunk = "sparse", None
    else:
        mode, chunk = "chunked", spec.bptt_chunk
    return (functools.partial(cell.init_params, device=device),
            functools.partial(cell.init_state, device=device),
            functools.partial(unroll_lib.unroll, cell, mode=mode, chunk=chunk))


def bits_loss(logits, targets, mask):
    """Sigmoid CE per output bit, masked to the answer span.

    logits/targets: (T, B, bits); mask: (T, B)."""
    ce = (logits.clamp_min(0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    return (ce.sum(-1) * mask).sum() / mask.sum().clamp_min(1.0)


def bits_error(logits, targets, mask):
    pred = (logits > 0).float()
    err = ((pred - targets).abs().sum(-1) * mask).sum()
    return err / mask.sum().clamp_min(1.0)


def make_task_train_step(spec: ModelSpec, lr: float = 1e-4, *, device="cuda"):
    """Returns (init_params, init_state, step). ``step(params, opt_state,
    inputs, targets, mask)`` takes batch-major (B, T, ...) tensors and
    returns (params, opt_state, loss, err), new trees beside the old. A
    leaf the loss does not reach (an LSH cell's fixed planes) gets a zero
    gradient, as under `jax.grad`: RMSProp leaves it as it was and decays
    its accumulator."""
    init_p, init_s, unroll = build_model(spec, device=device)

    def step(params, opt_state, inputs, targets, mask):
        xs = inputs.transpose(0, 1)                     # time-major
        ts = targets.transpose(0, 1)
        ms = mask.transpose(0, 1)
        leaves, spec_p = pytree.tree_flatten(params)
        with torch.enable_grad():
            p = pytree.tree_unflatten(
                [x.detach().requires_grad_() for x in leaves], spec_p)
            _, ys = unroll(p, init_s(inputs.shape[0]), xs)
            loss = bits_loss(ys, ts, ms)
            p_leaves = pytree.tree_leaves(p)
            grads = torch.autograd.grad(loss, p_leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(p_leaves, grads)]
        with torch.no_grad():
            err = bits_error(ys, ts, ms)
            grads, _ = opt.clip_by_global_norm(
                pytree.tree_unflatten(list(grads), spec_p), 10.0)
            params, opt_state = opt.rmsprop_update(params, grads, opt_state,
                                                   lr=lr)
        return params, opt_state, loss.detach(), err

    return init_p, init_s, step


def train_task(spec: ModelSpec, task: str, *, steps: int = 200,
               batch: int = 8, level: int = 4, max_level: int = 8,
               bits: int = 8, lr: float = 1e-4, seed: int = 0,
               curriculum: Curriculum = None, log_every: int = 25,
               verbose: bool = False, device="cuda"):
    """Train one model on one task; returns (params, the loss/error
    history). The weights and every batch are drawn from
    ``torch.Generator``s seeded with ``seed``, the curriculum's levels
    from ``numpy.random.default_rng(seed)``."""
    task_fn = TASKS[task]
    init_p, init_s, step = make_task_train_step(spec, lr, device=device)
    params = init_p(torch.Generator().manual_seed(seed))
    opt_state = opt.rmsprop_init(params)
    data = torch.Generator().manual_seed(seed + 1)
    rng = np.random.default_rng(seed)

    history = []
    t0 = time.time()
    for i in range(steps):
        lvl = curriculum.sample_level(rng) if curriculum else level
        inputs, targets, mask = task_fn(batch, lvl, max_level, bits,
                                        generator=data, device=device)
        params, opt_state, loss, err = step(params, opt_state, inputs,
                                            targets, mask)
        lf, ef = float(loss), float(err)
        history.append({"step": i, "loss": lf, "err": ef,
                        "level": int(curriculum.level) if curriculum else lvl})
        if curriculum:
            curriculum.update(ef)
        if verbose and i % log_every == 0:
            print(f"  [{spec.kind}/{task}] step {i} loss={lf:.4f} "
                  f"err={ef:.3f} ({time.time()-t0:.0f}s)")
    return params, history
