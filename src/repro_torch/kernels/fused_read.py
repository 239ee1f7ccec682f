"""Wrapper of the exact-read kernel (`csrc/fused_read.cu`), the port of
`repro/kernels/fused_read.py::fused_read_sweep` on f32, bf16 and int8
rows.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.fused_read_ref`. ``fused_read_sweep.launches`` counts
the launches (the kernel's two passes count as one), and
``fused_read_sweep.launches_by_dtype`` counts them per row dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def check_rows(require, mem: torch.Tensor, mem_scale, W: int) -> int:
    """Check a memory's storage (f32, bf16, or int8 with (B, rows) f32
    scales, contiguous, 16-byte aligned, W a multiple of the values per
    16-byte load) with ``require(cond, msg)``; return the storage code."""
    require(mem.dtype in _build.ROW_CODE, f"mem must be float32, bfloat16 "
                                          f"or int8, got {mem.dtype}")
    per = 16 // mem.element_size()
    require(W % per == 0, f"word size W={W} must be a multiple of {per} "
                          f"for {mem.dtype} rows (one 16-byte load)")
    require(mem.is_contiguous(), "mem must be contiguous")
    require(mem.data_ptr() % 16 == 0, "mem must be 16-byte aligned")
    if mem.dtype == torch.int8:
        require(mem_scale is not None, "int8 rows need their mem_scale")
        require(mem_scale.device == mem.device
                and mem_scale.dtype == torch.float32
                and tuple(mem_scale.shape) == tuple(mem.shape[:2])
                and mem_scale.is_contiguous(),
                f"mem_scale must be a contiguous float32 tensor of shape "
                f"{tuple(mem.shape[:2])} on {mem.device}")
    else:
        require(mem_scale is None, f"{mem.dtype} rows take no mem_scale")
    return _build.ROW_CODE[mem.dtype]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_read_sweep: {msg}")


def fused_read_sweep(q: torch.Tensor, mem: torch.Tensor, beta: torch.Tensor,
                     *, k: int, valid_n: int | None = None,
                     mem_scale: torch.Tensor | None = None):
    """q: (B, H, W) f32, mem: (B, rows, W) f32, bf16, or int8 with its
    per-row scales ``mem_scale`` (B, rows) f32, of which rows [0, valid_n)
    are swept (default: all), beta: (B, H) f32 -> (read (B, H, W) f32,
    weights (B, H, K) f32, indices (B, H, K) int32), indices ordered by
    (similarity desc, index asc), all on the rows as f32 (upcast or
    dequantized). W must be a multiple of 4 (f32), 8 (bf16) or 16 (int8).
    Matches `ref.fused_read_ref`."""
    _require(q.is_cuda, "q must be a CUDA tensor")
    _require(mem.device == q.device and beta.device == q.device,
             "q, mem and beta must be on one device")
    for name, t in (("q", q), ("beta", beta)):
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
    code = check_rows(_require, mem, mem_scale, W)
    _require(k <= n <= rows, f"valid_n={n} outside [{k}, {rows}]")
    fn = _build.function("fused_read", "fused_read_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _P, _P,
                          _P, _P, _P, _P])
    ncand = _build.function("fused_read", "fused_read_num_candidates",
                            [_I, _I])(n, k)
    dev = q.device
    cand_v = torch.empty((B, H, ncand), dtype=torch.float32, device=dev)
    cand_i = torch.empty((B, H, ncand), dtype=torch.int32, device=dev)
    read = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    w = torch.empty((B, H, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, H, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), mem.data_ptr(),
                 None if mem_scale is None else mem_scale.data_ptr(),
                 beta.data_ptr(), B, H, k, W, n, rows, code,
                 cand_v.data_ptr(), cand_i.data_ptr(), read.data_ptr(),
                 w.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_read_sweep", err)
    fused_read_sweep.launches += 1
    fused_read_sweep.launches_by_dtype[str(mem.dtype)[6:]] += 1
    return read, w, idx


fused_read_sweep.launches = 0
fused_read_sweep.launches_by_dtype = {"float32": 0, "bfloat16": 0, "int8": 0}
