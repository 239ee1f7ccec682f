"""Quickstart: the paper in a minute, on the PyTorch port.

1. Build SAM with a 1024-slot external memory and train it briefly on the
   NTM copy task (sparse reads and writes, and BPTT by memory rollback).
2. Show the speed story: one forward and backward pass of SAM against the
   dense NTM at N = 4096.

The port of `examples/quickstart.py`. Runs on the card unless the CPU is
asked for:

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu] [--steps 150]
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.training import ModelSpec, build_model, train_task
from repro_torch.core.types import ControllerConfig, MemoryConfig

CTL = ControllerConfig(input_size=10, hidden_size=64, output_size=8)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fwd_bwd_ms(spec: ModelSpec, xs: torch.Tensor, *, seed: int = 0) -> float:
    """Host-clock ms of one forward and backward pass of ``(ys**2).sum()``
    over xs (T, B, D), after one untimed pass (which builds the kernels)."""
    init_p, init_s, unroll = build_model(spec, device=xs.device)
    leaves, tdef = pytree.tree_flatten(init_p(
        torch.Generator().manual_seed(seed)))
    leaves = [p.requires_grad_() for p in leaves]
    params = pytree.tree_unflatten(leaves, tdef)

    def run():
        _, ys = unroll(params, init_s(xs.shape[1]), xs)
        torch.autograd.grad((ys ** 2).sum(), leaves)

    run()
    _sync(xs.device)
    t0 = time.perf_counter()
    run()
    _sync(xs.device)
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--steps", type=int, default=150,
                        help="training steps of part 1")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: run on the card, or pass "
                             "--device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"== on {name} ==")

    print("== 1. train SAM (sparse memory, 1024 slots) on copy ==")
    mem = MemoryConfig(num_slots=1024, word_size=16, num_heads=2, k=4)
    _, hist = train_task(ModelSpec("sam", mem, CTL), "copy", steps=args.steps,
                         batch=8, level=2, max_level=4, lr=1e-3, verbose=True,
                         log_every=50, device=device)
    print(f"   loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    print("== 2. fwd+bwd cost: SAM vs dense NTM at N=4096 ==")
    xs = torch.randn((10, 4, 10),
                     generator=torch.Generator().manual_seed(0)).to(device)
    mem_big = MemoryConfig(num_slots=4096, word_size=32, num_heads=4, k=4)
    t_sam = fwd_bwd_ms(ModelSpec("sam", mem_big, CTL), xs)
    t_ntm = fwd_bwd_ms(ModelSpec("ntm", mem_big, CTL), xs)
    print(f"   SAM {t_sam:.1f} ms vs NTM {t_ntm:.1f} ms "
          f"({t_ntm / t_sam:.1f}x) per fwd+bwd at N=4096 on {name}")
    return {"device": name, "loss": (hist[0]["loss"], hist[-1]["loss"]),
            "sam_ms": t_sam, "ntm_ms": t_ntm}


if __name__ == "__main__":
    main()
