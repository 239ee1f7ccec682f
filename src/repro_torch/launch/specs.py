"""Concrete batches of the LM, the port's counterpart of the JAX
package's `launch/specs.py::concrete_batch` (the shape specs of its
dry-run cells are not ported: they lower XLA programs)."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def concrete_batch(cfg: ModelConfig, batch_size: int, seq_len: int, *,
                   generator: torch.Generator, device="cuda"):
    """A batch of ``batch_size`` sequences of ``seq_len`` positions with
    JAX's keys, shapes, dtypes and distributions:

    - an audio config: ``frame_embeds`` (B, S, d) f32 drawn N(0, 1), and
      ``targets`` (B, S) int32 uniform in [0, vocab);
    - a vision config: ``patch_embeds`` (B, frontend_len, d) f32 drawn
      N(0, 1), and ``tokens`` and ``targets`` (B, S - frontend_len) int32
      uniform in [0, vocab); it raises when ``seq_len`` <= frontend_len;
    - any other config: ``tokens`` and ``targets`` (B, S) int32.

    The values are drawn from ``generator`` (on its own device) and moved
    to ``device``. They are not JAX's: JAX draws them with a JAX key, which
    has no counterpart here, so a run of the port sees other frontend
    batches than a run of JAX from the same seed. Tests feed both sides
    one numpy batch."""
    gdev = generator.device
    B, V = batch_size, cfg.vocab_size

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=gdev).to(device)

    def ints(shape):
        return torch.randint(0, V, shape, generator=generator,
                             dtype=torch.int32, device=gdev).to(device)

    if cfg.frontend == "audio":
        return {"frame_embeds": normal((B, seq_len, cfg.d_model)),
                "targets": ints((B, seq_len))}
    batch = {}
    s_text = seq_len
    if cfg.frontend == "vision":
        s_text = seq_len - cfg.frontend_len
        if s_text <= 0:
            raise ValueError(f"{cfg.name}: seq_len={seq_len} leaves no "
                             f"text after the {cfg.frontend_len} patch "
                             f"embeddings")
        batch["patch_embeds"] = normal((B, cfg.frontend_len, cfg.d_model))
    batch["tokens"] = ints((B, s_text))
    batch["targets"] = ints((B, s_text))
    return batch
