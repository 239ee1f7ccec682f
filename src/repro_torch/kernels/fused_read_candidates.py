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
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_read import check_rows

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# csrc/fused_read_candidates.cu's limits: rows a tile stages, threads a
# block, 16-byte loads a thread keeps in flight, the largest K, and the
# shared memory a block may use.
MAX_TILE, MAX_THREADS, LOADS, MAX_K, MAX_SMEM = 256, 512, 8, 8, 232448


@dataclass(frozen=True)
class CandPlan:
    """How the candidate read cuts its work (csrc/fused_read_candidates.cu):
    a block per (b, h) of ``threads`` threads stages ``tile`` candidate
    rows at a time in ``smem`` bytes of shared memory; when ``tile`` < C
    the K chosen rows are read from device memory again for the sum."""
    tile: int
    threads: int
    smem: int


def cand_smem(C: int, W: int, k: int, tile: int, threads: int) -> int:
    """The kernel's shared memory (csrc `smem_bytes`): the tile (tile rows
    of W + 4 floats), q, the ids, and 8-byte keys: each warp's k best of
    each tile, and the k selected."""
    lists = -(-C // tile) * (threads // 32) * k
    return 4 * (tile * (W + 4) + W + C) + 8 * (lists + k)


@functools.lru_cache(maxsize=256)
def cand_plan(C: int, W: int, per: int, k: int) -> CandPlan:
    """The plan for C candidates of W values, ``per`` values a 16-byte
    load (4 f32, 8 bf16, 16 int8), top ``k``: a tile of min(C, MAX_TILE)
    rows, fewer if they would not fit in MAX_SMEM, and enough threads to
    score a row each and keep every load of a tile in flight at LOADS a
    thread, up to MAX_THREADS."""
    def threads_for(tile):
        loads = tile * (W // per)
        return min(MAX_THREADS,
                   -(-max(tile, -(-loads // LOADS)) // 32) * 32)

    tile = min(C, MAX_TILE)
    while tile > 1 and cand_smem(C, W, k, tile,
                                 threads_for(tile)) > MAX_SMEM:
        tile -= 1
    threads = threads_for(tile)
    _require(cand_smem(C, W, k, tile, threads) <= MAX_SMEM,
             f"C={C} candidates of W={W} do not fit in shared memory")
    return CandPlan(tile=tile, threads=threads,
                    smem=cand_smem(C, W, k, tile, threads))


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
    _require(1 <= k <= MAX_K, f"k={k} outside [1, {MAX_K}]")
    _require(C >= k, f"{C} candidates for k={k}: needs C >= k")
    code = check_rows(_require, mem, mem_scale, W)
    plan = cand_plan(C, W, 16 // mem.element_size(), k)
    fn = _build.function("fused_read_candidates",
                         "fused_read_candidates_launch",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I,
                          _I, _P, _P, _P, _P])
    dev = q.device
    read = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    w = torch.empty((B, H, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, H, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), mem.data_ptr(),
                 None if mem_scale is None else mem_scale.data_ptr(),
                 beta.data_ptr(), cand_idx.data_ptr(), B, H, C, k, W, rows,
                 code, plan.tile, plan.threads, read.data_ptr(),
                 w.data_ptr(), idx.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_read_candidates", err)
    fused_read_candidates.launches += 1
    fused_read_candidates.launches_by_dtype[str(mem.dtype)[6:]] += 1
    return read, w, idx


fused_read_candidates.launches = 0
fused_read_candidates.launches_by_dtype = {"float32": 0, "bfloat16": 0,
                                           "int8": 0}
