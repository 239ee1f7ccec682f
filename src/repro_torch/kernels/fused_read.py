"""Wrapper of the exact-read kernel (`csrc/fused_read.cu`), the port of
`repro/kernels/fused_read.py::fused_read_sweep`.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.fused_read_ref`. ``fused_read_sweep.launches`` counts
the launches (the kernel's two passes count as one).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_read_sweep: {msg}")


def fused_read_sweep(q: torch.Tensor, mem: torch.Tensor, beta: torch.Tensor,
                     *, k: int, valid_n: int | None = None):
    """q: (B, H, W) f32 with W a multiple of 4, mem: (B, rows, W) f32 of
    which rows [0, valid_n) are swept (default: all), beta: (B, H) f32 ->
    (read (B, H, W) f32, weights (B, H, K) f32, indices (B, H, K) int32),
    indices ordered by (similarity desc, index asc). Matches
    `ref.fused_read_ref`."""
    _require(q.is_cuda, "q must be a CUDA tensor")
    _require(mem.device == q.device and beta.device == q.device,
             "q, mem and beta must be on one device")
    for name, t in (("q", q), ("mem", mem), ("beta", beta)):
        _require(t.dtype == torch.float32, f"{name} must be float32")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(q.dim() == 3 and mem.dim() == 3, "q and mem must be 3-D")
    B, H, W = q.shape
    rows = mem.shape[1]
    n = rows if valid_n is None else valid_n
    _require(mem.shape[0] == B and mem.shape[2] == W,
             f"mem {tuple(mem.shape)} does not match q {tuple(q.shape)}")
    _require(tuple(beta.shape) == (B, H), f"beta must be {(B, H)}")
    _require(1 <= k <= 8 and 1 <= H <= 8, "needs 1 <= k <= 8 and H <= 8")
    _require(W % 4 == 0, f"word size W={W} must be a multiple of 4")
    _require(k <= n <= rows, f"valid_n={n} outside [{k}, {rows}]")
    fn = _build.function("fused_read", "fused_read_launch",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _L, _P, _P, _P,
                          _P, _P, _P])
    ncand = _build.function("fused_read", "fused_read_num_candidates",
                            [_I, _I])(n, k)
    dev = q.device
    cand_v = torch.empty((B, H, ncand), dtype=torch.float32, device=dev)
    cand_i = torch.empty((B, H, ncand), dtype=torch.int32, device=dev)
    read = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    w = torch.empty((B, H, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, H, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), mem.data_ptr(), beta.data_ptr(), B, H, k, W,
                 n, rows * W, cand_v.data_ptr(), cand_i.data_ptr(),
                 read.data_ptr(), w.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_read_sweep", err)
    fused_read_sweep.launches += 1
    return read, w, idx


fused_read_sweep.launches = 0
