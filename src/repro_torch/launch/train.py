"""LM training driver of the port on one device, the JAX package's
`launch/train.py` without its mesh and its checkpointed loop.

    python -m repro_torch.launch.train --reduced --steps 3 --device cpu
    python -m repro_torch.launch.train --steps 20 --batch 4 --seq 2048

train the reduced config on the host, or the full published config on the
card (the default device). Weights come from ``--seed``, batches from
`data.tokens.lm_token_batches`; the step is `launch.steps.make_train_step`
(AdamW, the cosine schedule over ``--steps``). A mesh is ROADMAP item A11;
a checkpoint directory (`ResilientLoop`, `AsyncCheckpointer`) is A10b.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.data.tokens import lm_token_batches
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import optimizers as opt

DEFAULT_ARCH = "starcoder2_7b_sam"


def train(arch: str = DEFAULT_ARCH, *, steps: int = 50, batch: int = 8,
          seq: int = 256, lr: float = 3e-4, use_reduced: bool = True,
          ckpt_dir: str = None, mesh=None, log_every: int = 10,
          seed: int = 0, accum: int = 1, device="cuda", params=None):
    """Train ``arch`` for ``steps`` AdamW steps on synthetic token batches.
    ``params`` (default: `lm.init_params` from ``seed``, in the config's
    param dtype) are updated in place. Returns ((params, opt_state), log),
    log holding (step, metrics as floats) every ``log_every`` steps."""
    if mesh is not None:
        raise NotImplementedError("training on a mesh is not ported yet: "
                                  "ROADMAP item A11")
    if ckpt_dir is not None:
        raise NotImplementedError("checkpointed training (ResilientLoop, "
                                  "AsyncCheckpointer) is not ported yet: "
                                  "ROADMAP item A10b")
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    if params is None:
        params = lm.init_params(cfg, seed=seed, device=device)
    opt_state = opt.adamw_init(params)
    step_fn = make_train_step(cfg, lr=lr, accum=accum, total_steps=steps)
    batches = lm_token_batches(cfg.vocab_size, batch, seq)
    log = []
    t0 = time.time()
    for i in range(steps):
        b, _ = next(batches)
        b = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        if i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            log.append((i, m))
            print(f"step {i:5d} loss={m['loss']:.4f} "
                  f"lr={m['lr']:.2e} ({time.time() - t0:.1f}s)")
    return (params, opt_state), log


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, use_reduced=args.reduced, accum=args.accum,
          device=args.device)


if __name__ == "__main__":
    main()
