"""Train a ~100M-parameter SAM-augmented LM with checkpoint/restart fault
tolerance, the port of the JAX package's `examples/train_lm_100m.py`.

The config is a StarCoder2-family backbone scaled to ~100M parameters with
the paper's memory layer after every 4th layer (65,536 slots in the full
config; ``--slots`` defaults to 1024, as in JAX). The steps run under
`ResilientLoop` (`launch.train.train` with a checkpoint directory), a
checkpoint every 50 steps: a rerun resumes from the newest one.

    python -m repro_torch.examples.train_lm_100m --steps 300 --slots 65536
    python -m repro_torch.examples.train_lm_100m --steps 3 --device cpu

train on the card (the default device) or on the host.
"""
import argparse
import dataclasses

from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.models.config import MemoryLayerConfig


def config_100m(slots: int):
    base = get_config("starcoder2_7b")
    return dataclasses.replace(
        base, name="samlm_100m", num_layers=8, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32768,
        q_block=128, kv_block=128, loss_chunk=128, remat=False,
        memory=MemoryLayerConfig(num_slots=slots, word_size=64, num_heads=2,
                                 k=4, every_n_layers=4, segment=128))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--ckpt-dir", default="samlm_100m_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = config_100m(args.slots)
    (params, _), log = train(cfg=cfg, steps=args.steps, batch=args.batch,
                             seq=args.seq, lr=3e-4, ckpt_dir=args.ckpt_dir,
                             ckpt_every=50, device=args.device)
    n_params = sum(p.numel() for p in pytree.tree_leaves(params))
    print(f"model: {cfg.name} ({n_params / 1e6:.0f}M params, memory "
          f"{cfg.memory.num_slots}x{cfg.memory.word_size} every "
          f"{cfg.memory.every_n_layers} layers)")
    for s, m in log:
        print(f"step {s:4d} loss={m['loss']:.4f}")


if __name__ == "__main__":
    main()
