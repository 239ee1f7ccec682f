"""Wrapper of the LRA selection kernel (`csrc/lra_topn.cu`), the port of
`repro/kernels/usage_argmin.py::lra_topn`.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.lra_topn_ref`. ``lra_topn.launches`` counts the
launches (the kernel's two passes count as one).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lra_topn: {msg}")


def lra_topn(last_access: torch.Tensor, n: int, *,
             valid_n: int | None = None) -> torch.Tensor:
    """last_access: (B, rows) int32 CUDA tensor -> (B, n) int32 indices of
    the n smallest entries among [0, valid_n) (default: all), ascending by
    (value, index). Matches `ref.lra_topn_ref`. A float table raises."""
    _require(last_access.is_cuda, "last_access must be a CUDA tensor")
    _require(last_access.dtype == torch.int32,
             f"last_access must be int32, got {last_access.dtype}")
    _require(last_access.dim() == 2 and last_access.is_contiguous(),
             "last_access must be a contiguous (B, rows) table")
    B, rows = last_access.shape
    nv = rows if valid_n is None else valid_n
    _require(1 <= n <= 8, f"n={n} outside [1, 8]")
    _require(n <= nv <= rows, f"valid_n={nv} outside [{n}, {rows}]")
    fn = _build.function("lra_topn", "lra_topn_launch",
                         [_P, _L, _I, _I, _I, _P, _P, _P])
    ncand = _build.function("lra_topn", "lra_topn_candidates",
                            [_I, _I])(nv, n)
    dev = last_access.device
    cand = torch.empty((B, ncand), dtype=torch.int64, device=dev)
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(last_access.data_ptr(), rows, B, nv, n, cand.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("lra_topn", err)
    lra_topn.launches += 1
    return out


lra_topn.launches = 0
