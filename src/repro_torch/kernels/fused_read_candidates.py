"""Wrapper of the ANN read kernel (`csrc/fused_read_candidates.cu`), the
port of `repro/kernels/fused_read.py::fused_read_candidates` on f32, bf16
and int8 rows.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.fused_read_candidates_ref`.
``fused_read_candidates.launches`` counts the launches, and
``fused_read_candidates.launches_by_dtype`` counts them per row dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_read import check_rows

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_read_candidates: {msg}")


def fused_read_candidates(q: torch.Tensor, mem: torch.Tensor,
                          beta: torch.Tensor, cand_idx: torch.Tensor, *,
                          k: int, mem_scale: torch.Tensor | None = None):
    """q: (B, H, W) f32, mem: (B, rows, W) f32, bf16, or int8 with its
    per-row scales ``mem_scale`` (B, rows) f32, beta: (B, H) f32,
    cand_idx: (B, H, C) int32 signed and pre-deduped, every id in
    [-1, rows), C >= k -> (read (B, H, W) f32, weights (B, H, K) f32,
    signed indices (B, H, K) int32), the K best candidates by (similarity
    desc, position asc) on the rows as f32 (upcast or dequantized), an
    invalid one (-1) scored -1e9 and weighted exactly 0. W must be a
    multiple of 4 (f32), 8 (bf16) or 16 (int8). Matches
    `ref.fused_read_candidates_ref`."""
    _require(q.is_cuda, "q must be a CUDA tensor")
    for name, t, dtype in (("q", q, torch.float32),
                           ("beta", beta, torch.float32),
                           ("cand_idx", cand_idx, torch.int32)):
        _require(t.device == q.device, f"{name} is not on {q.device}")
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(mem.device == q.device, f"mem is not on {q.device}")
    _require(q.dim() == 3 and mem.dim() == 3 and cand_idx.dim() == 3,
             "q, mem and cand_idx must be 3-D")
    B, H, W = q.shape
    rows, C = mem.shape[1], cand_idx.shape[2]
    _require(mem.shape[0] == B and mem.shape[2] == W,
             f"mem {tuple(mem.shape)} does not match q {tuple(q.shape)}")
    _require(tuple(beta.shape) == (B, H), f"beta must be {(B, H)}")
    _require(tuple(cand_idx.shape[:2]) == (B, H),
             f"cand_idx must be ({B}, {H}, C), got {tuple(cand_idx.shape)}")
    _require(1 <= k <= 8, f"k={k} outside [1, 8]")
    _require(C >= k, f"{C} candidates for k={k}: needs C >= k")
    code = check_rows(_require, mem, mem_scale, W)
    fn = _build.function("fused_read_candidates",
                         "fused_read_candidates_launch",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _P,
                          _P, _P, _P])
    dev = q.device
    read = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    w = torch.empty((B, H, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, H, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), mem.data_ptr(),
                 None if mem_scale is None else mem_scale.data_ptr(),
                 beta.data_ptr(), cand_idx.data_ptr(), B, H, C, k, W, rows,
                 code, read.data_ptr(), w.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_read_candidates", err)
    fused_read_candidates.launches += 1
    fused_read_candidates.launches_by_dtype[str(mem.dtype)[6:]] += 1
    return read, w, idx


fused_read_candidates.launches = 0
fused_read_candidates.launches_by_dtype = {"float32": 0, "bfloat16": 0,
                                           "int8": 0}
