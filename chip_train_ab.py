#!/usr/bin/env python3
"""Host ms and peaks of the SAM train step and the LM train step on one
NVIDIA GPU, for comparing two checkouts of the port in one call.

    python3 chip_train_ab.py ROOT

imports the port and `chip_smoke.py`'s widths from the checkout at ROOT
and times, as `chip_smoke.py` phases 7 and 13 do:

* the `sam` train step (`core/training.py::make_task_train_step`, sparse
  mode, f32 rows, the exact read) on the copy task at the smoke's widths
  (B = 8, N = 2^20, T = 42): the step, its forward (the unroll and the
  loss) and its backward (`torch.autograd.grad`) apart, medians of 5 on
  the host clock, synchronised; the step's peak above what it holds;
* the LM train step (`launch/steps.py::make_train_step`) of
  StarCoder2-7B with memory, 8 layers, B = 4, S = 2048 (f32 weights from
  seed 0): the step and its forward and backward (`steps.value_and_grad`)
  apart, medians of 3; the step's peak above what it holds.

Run it for each checkout in turns (parent, change, change, parent).
Prints one JSON line last.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time

import torch


def timed(fn, runs, setup=None):
    """Median and all host ms of ``fn(setup())`` over ``runs`` runs."""
    times = []
    for _ in range(runs):
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def peak_of(fn):
    """Bytes ``fn()`` allocates above what is held when it starts."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def sam_step(cs, dev) -> dict:
    from torch.utils import _pytree as pytree

    from repro_torch.core import training
    from repro_torch.core.types import ControllerConfig, MemoryConfig
    from repro_torch.data.tasks import copy_task
    from repro_torch.optim import optimizers as opt

    spec = training.ModelSpec("sam", MemoryConfig(
        num_slots=cs.N, word_size=cs.W, num_heads=cs.H, k=cs.K,
        delta=cs.DELTA), ControllerConfig(input_size=cs.BITS + 2,
                                          hidden_size=cs.HIDDEN,
                                          output_size=cs.BITS))
    inputs, targets, mask = copy_task(
        cs.B, cs.MAX_LEN, cs.MAX_LEN, cs.BITS, device=dev,
        generator=torch.Generator().manual_seed(1))
    init_p, init_s, unroll = training.build_model(spec, device=dev)
    _, _, step = training.make_task_train_step(spec, cs.LR, device=dev)
    params = init_p(torch.Generator().manual_seed(0))
    opt_state = opt.rmsprop_init(params)
    xs, ts, ms = (t.transpose(0, 1) for t in (inputs, targets, mask))
    leaves, spec_p = pytree.tree_flatten(params)
    diff = [x.detach().requires_grad_() for x in leaves]
    p = pytree.tree_unflatten(diff, spec_p)
    out = {}

    def forward(s0):
        with torch.enable_grad():
            out["loss"] = training.bits_loss(unroll(p, s0, xs)[1], ts, ms)

    def setup_backward():
        s0 = init_s(cs.B)
        forward(s0)
        return s0

    state = {"p": params, "o": opt_state}

    def train(_):
        state["p"], state["o"], _, _ = step(state["p"], state["o"], inputs,
                                            targets, mask)
    train(None)                                         # warm
    step_ms, step_all = timed(train, 5)
    fwd_ms, fwd_all = timed(forward, 5, setup=lambda: init_s(cs.B))
    bwd_ms, bwd_all = timed(
        lambda _: torch.autograd.grad(out["loss"], diff, allow_unused=True),
        5, setup=setup_backward)
    out.clear()
    peak = peak_of(lambda: train(None))
    return dict(ms=step_ms, all=step_all, fwd_ms=fwd_ms, fwd_all=fwd_all,
                bwd_ms=bwd_ms, bwd_all=bwd_all, peak=peak)


def lm_step(cs, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import lm_token_batches
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import optimizers as opt

    cfg = dataclasses.replace(get_config(cs.LM_ARCH),
                              num_layers=cs.TRAIN_LAYERS)
    params = lm.init_params(cfg, seed=0, device=dev)
    b, _ = next(lm_token_batches(cfg.vocab_size, cs.TRAIN_B, cs.TRAIN_S))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
    step = steps.make_train_step(cfg, lr=cs.TRAIN_LR, warmup=cs.TRAIN_WARMUP,
                                 total_steps=cs.TRAIN_STEPS)
    state = {"p": params, "o": opt.adamw_init(params)}

    def train(_):
        state["p"], state["o"], _ = step(state["p"], state["o"], batch)
    train(None)                                         # warm
    step_ms, step_all = timed(train, 3)
    grad_ms, grad_all = timed(
        lambda _: steps.value_and_grad(state["p"], cfg, batch), 3)
    peak = peak_of(lambda: train(None))
    return dict(ms=step_ms, all=step_all, fwd_bwd_ms=grad_ms,
                fwd_bwd_all=grad_all, peak=peak)


def main() -> int:
    root = sys.argv[1]
    sys.path.insert(0, root)
    sys.path.insert(0, root + "/src")
    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_train_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    card = cs.card_line()
    res = {"root": root, "card": card, "lm": lm_step(cs, dev)}
    torch.cuda.empty_cache()
    res["sam"] = sam_step(cs, dev)
    for what, r in (("sam", res["sam"]), ("lm", res["lm"])):
        parts = ", ".join(f"{k} {v:.2f}" for k, v in r.items()
                          if k.endswith("_ms"))
        print(f"[ab] {root}: {what} train step {r['ms']:.2f} ms (of "
              f"{', '.join(f'{t:.2f}' for t in r['all'])}); {parts}; peak "
              f"{r['peak']} B; {card}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
