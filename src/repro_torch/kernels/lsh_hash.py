"""Wrapper of the LSH signature kernel (`csrc/lsh_hash.cu`), the port of
`repro/kernels/lsh_hash.py::lsh_hash`.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.lsh_hash_ref`. ``lsh_hash.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_BITS = 30


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lsh_hash: {msg}")


def lsh_hash(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """x: (R, W) f32, planes: (T, bits, W) f32, both contiguous on one CUDA
    device, W a multiple of 4, bits <= 30 -> bucket ids (R, T) int32, bit
    i of table t set where x · planes[t, i] > 0 (f32 FMAs, w ascending).
    Matches `ref.lsh_hash_ref` except where a projection lies within
    rounding of 0."""
    _require(x.is_cuda, "x must be a CUDA tensor")
    _require(planes.device == x.device, "x and planes must be on one device")
    for name, t in (("x", x), ("planes", planes)):
        _require(t.dtype == torch.float32,
                 f"{name} must be float32, got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _require(x.dim() == 2 and planes.dim() == 3,
             f"x must be (R, W) and planes (T, bits, W), got "
             f"{tuple(x.shape)} and {tuple(planes.shape)}")
    R, W = x.shape
    T, bits, Wp = planes.shape
    _require(Wp == W, f"planes have width {Wp}, x has {W}")
    _require(W % 4 == 0, f"word size W={W} must be a multiple of 4")
    _require(1 <= bits <= MAX_BITS, f"bits={bits} outside [1, {MAX_BITS}]")
    _require(R < 2 ** 31, f"R={R} rows do not fit an int32")
    out = torch.empty((R, T), dtype=torch.int32, device=x.device)
    if R == 0:
        return out
    fn = _build.function("lsh_hash", "lsh_hash_launch",
                         [_P, _P, _I, _I, _I, _I, _P, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), planes.data_ptr(), R, W, T, bits,
                 out.data_ptr(), stream)
    _build.check("lsh_hash", err)
    lsh_hash.launches += 1
    return out


lsh_hash.launches = 0
