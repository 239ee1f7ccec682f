"""int8 round trip of gradients, the part of `repro/distributed/
compression.py` that the train step runs (``compress_pod_grads=True``):
`quantize_int8`, `dequantize_int8` and `int8_roundtrip`.

A tensor is flattened, padded to a multiple of `BLOCK` and quantized per
block of 256 values with `core.quant.quantize_rows` (one block = one
"row"), so the scale is formed as the compiled JAX quantizer forms it:
max|block| · fl(1/127). The round trip is the lossy channel an int8
all-reduce across pods would add; the port runs on one device and has no
such collective.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quant import dequantize_rows, quantize_rows

BLOCK = 256


def quantize_int8(x: torch.Tensor):
    """Per-block symmetric int8 quantization -> (q (n_blocks, BLOCK) int8,
    scales (n_blocks, 1) f32)."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    q, scale = quantize_rows(flat.reshape(-1, BLOCK))
    return q, scale[:, None]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape):
    out = dequantize_rows(q, scale.reshape(-1)).reshape(-1)
    return out[:math.prod(shape)].reshape(shape)


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize, then dequantize, in x's dtype. Scalars and integer tensors
    pass through untouched."""
    if x.dim() == 0 or not x.is_floating_point():
        return x
    q, scale = quantize_int8(x)
    return dequantize_int8(q, scale, x.shape).to(x.dtype)
