"""LM training driver of the port on one device, the JAX package's
`launch/train.py` without its mesh.

    python -m repro_torch.launch.train --reduced --steps 3 --device cpu
    python -m repro_torch.launch.train --steps 20 --batch 4 --seq 2048
    python -m repro_torch.launch.train --reduced --steps 40 --ckpt-dir ckpt

train the reduced config on the host, or the full published config on the
card (the default device). Every family the port serves trains: the
dense GQA ones (causal, sliding-window, prefix-LM), MLA and MoE
(DeepSeek-V2, Llama-4), the RWKV block (RWKV-6) and the hybrid block
(Hymba-1.5B). Weights come from ``seed``; batches from
`data.tokens.lm_token_batches`, or for a config with a frontend
(PaliGemma's vision prefix, MusicGen's audio frames) from
`launch.specs.concrete_batch` with a `torch.Generator` seeded by
``seed``, as JAX draws them from its key (the values differ: JAX's key
has no counterpart here). The step is `launch.steps.make_train_step`
(AdamW, the cosine schedule over ``--steps``). With ``--ckpt-dir`` the
steps run under `distributed.fault_tolerance.ResilientLoop`: an
asynchronous checkpoint every 20 steps and at the end, and a restart
resumes from the newest one (its batches start again from the first, as
in JAX). A mesh is ROADMAP item A11.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.data.tokens import lm_token_batches
from repro_torch.distributed.fault_tolerance import ResilientLoop
from repro_torch.launch.specs import concrete_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import optimizers as opt

DEFAULT_ARCH = "starcoder2_7b_sam"


def train(arch: str = DEFAULT_ARCH, *, steps: int = 50, batch: int = 8,
          seq: int = 256, lr: float = 3e-4, use_reduced: bool = True,
          ckpt_dir: str = None, ckpt_every: int = 20, mesh=None,
          log_every: int = 10, seed: int = 0, accum: int = 1, device="cuda",
          params=None, cfg=None):
    """Train ``arch`` (or ``cfg`` as given) for ``steps`` AdamW steps on
    synthetic batches (module docstring). ``params`` (default:
    `lm.init_params` from ``seed``, in the config's param dtype) are
    updated in place. With ``ckpt_dir`` the steps run under
    `ResilientLoop` (module docstring), a checkpoint every ``ckpt_every``,
    from the newest checkpoint there if there is one. Returns ((params, opt_state), log), log holding (step,
    metrics as floats) every ``log_every`` steps."""
    if mesh is not None:
        raise NotImplementedError("training on a mesh is not ported yet: "
                                  "ROADMAP item A11")
    if cfg is None:
        cfg = get_config(arch)
        if use_reduced:
            cfg = reduce_cfg(cfg)
    if params is None:
        params = lm.init_params(cfg, seed=seed, device=device)
    opt_state = opt.adamw_init(params)
    step_fn = make_train_step(cfg, lr=lr, accum=accum, total_steps=steps)
    if cfg.frontend is None:
        batches = ({k: torch.as_tensor(v).to(device) for k, v in b.items()}
                   for b, _ in lm_token_batches(cfg.vocab_size, batch, seq))
    else:
        def frontend_batches():
            gen = torch.Generator().manual_seed(seed)
            while True:
                yield concrete_batch(cfg, batch, seq, generator=gen,
                                     device=device)
        batches = frontend_batches()

    def wrapped(state, b):
        params, opt_state, metrics = step_fn(*state, b)
        return (params, opt_state), metrics

    state = (params, opt_state)
    if ckpt_dir:
        loop = ResilientLoop(wrapped, ckpt_dir, ckpt_every=ckpt_every)
        state, start = loop.restore_or(state)
        try:
            state, log = loop.run(state, batches, start, steps,
                                  log_every=log_every)
        finally:
            loop.close()
        return state, [(i, {k: float(v) for k, v in m.items()})
                       for i, m in log]
    log = []
    t0 = time.time()
    for i in range(steps):
        state, metrics = wrapped(state, next(batches))
        if i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            log.append((i, m))
            print(f"step {i:5d} loss={m['loss']:.4f} "
                  f"lr={m['lr']:.2e} ({time.time() - t0:.1f}s)")
    return state, log


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=DEFAULT_ARCH)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (default: the published one)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here and resume from here "
                         "(ResilientLoop)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, use_reduced=args.reduced, ckpt_dir=args.ckpt_dir,
          accum=args.accum, device=args.device)


if __name__ == "__main__":
    main()
