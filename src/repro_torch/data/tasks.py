"""The copy task (paper §4.2, NTM conventions), with the layout of
`repro/data/tasks.py::copy_task`: binary vectors of width ``bits`` plus a
start flag (channel ``bits``) and a delimiter flag (channel ``bits+1``);
targets and mask cover the answer span only."""
from __future__ import annotations

import numpy as np
import torch


def copy_task(batch: int, length: int, max_len: int, bits: int = 8, *,
              generator: torch.Generator | None = None, seq=None,
              device="cuda"):
    """Copy a length-``length`` sequence after the delimiter. Padded time
    T = 2·max_len + 2, input width bits + 2. The bits come from ``seq``
    ((batch, max_len, bits) 0/1, numpy or torch) when given, else from
    fair coin flips drawn with ``generator``. Returns (inputs (B, T,
    bits+2), targets (B, T, bits), mask (B, T)), batch-major like the JAX
    task; `sam_unroll` takes time-major inputs (``inputs.transpose(0, 1)``)."""
    T = 2 * max_len + 2
    if seq is None:
        seq = torch.bernoulli(torch.full((batch, max_len, bits), 0.5),
                              generator=generator)
    else:
        seq = torch.tensor(np.asarray(seq, dtype=np.float32))
    seq = seq * (torch.arange(max_len) < length)[None, :, None]
    inputs = torch.zeros((batch, T, bits + 2))
    inputs[:, 0, bits] = 1.0                                   # start flag
    inputs[:, 1:1 + max_len, :bits] = seq
    inputs[:, length + 1, bits + 1] += 1.0                     # delimiter
    targets = torch.zeros((batch, T, bits))
    targets[:, length + 2:2 * length + 2] = seq[:, :length]
    t = torch.arange(T)
    mask = ((t >= length + 2) & (t < 2 * length + 2)).float()
    mask = mask.expand(batch, T).clone()
    return inputs.to(device), targets.to(device), mask.to(device)
