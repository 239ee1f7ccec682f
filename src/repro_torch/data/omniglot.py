"""Omniglot-style one-shot classification episodes (paper §4.5), the
layout of the JAX package's `data/omniglot.py`: a synthetic character
set in which each class is a random prototype vector and an example of it
the prototype plus normal noise. At each step the model sees (example,
label of the previous example) and must emit the label of the current
example; each class appears ``presentations`` times in a shuffled order.

The reference's docstring promises "rotation-like orthogonal jitter" as
well, but its code adds the normal noise only (and never uses the key it
splits off for the jitter); the port does what the code does.

The draws come from ``generator`` (a `torch.Generator`: the prototypes,
then a permutation a row, then the noise), or are given by the caller
(``protos`` (B, C, dim), ``ids`` (B, T) and ``noise_draws`` (B, T, dim),
as numpy arrays or tensors), so that two implementations can be fed the
same numbers."""
from __future__ import annotations

import numpy as np
import torch


def _given(x, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype)


def omniglot_episode(batch: int, num_classes: int, presentations: int = 10,
                     dim: int = 32, noise: float = 0.3, *,
                     generator: torch.Generator | None = None, protos=None,
                     ids=None, noise_draws=None, device="cuda"):
    """Returns batch-major (inputs (B, T, dim + num_classes) f32, the class
    ids (B, T) int64, mask (B, T) f32 of ones), T = num_classes ·
    presentations. Example t is ``protos[b, ids[b, t]] + noise ·
    noise_draws[b, t]``; its last ``num_classes`` channels hold the
    one-hot id of step t - 1 (zeros at t = 0)."""
    T = num_classes * presentations
    protos = torch.randn((batch, num_classes, dim), generator=generator) \
        if protos is None else _given(protos, torch.float32)
    if ids is None:
        tiled = torch.arange(num_classes).repeat(presentations)
        ids = torch.stack([tiled[torch.randperm(T, generator=generator)]
                           for _ in range(batch)])
    else:
        ids = _given(ids, torch.int64)
    noise_draws = torch.randn((batch, T, dim), generator=generator) \
        if noise_draws is None else _given(noise_draws, torch.float32)
    ex = torch.gather(protos, 1, ids[..., None].expand(batch, T, dim))
    ex = ex + noise * noise_draws
    labels = torch.nn.functional.one_hot(ids, num_classes).float()
    prev = torch.cat([torch.zeros_like(labels[:, :1]), labels[:, :-1]], 1)
    inputs = torch.cat([ex, prev], dim=-1)
    mask = torch.ones((batch, T))
    return inputs.to(device), ids.to(device), mask.to(device)
