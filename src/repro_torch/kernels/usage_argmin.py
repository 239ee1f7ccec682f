"""Wrappers of the least-used selection kernels (`csrc/usage_argmin.cu`),
the ports of `repro/kernels/usage_argmin.py::lra_topn` (SAM's LRA rows)
and `::usage_argmin` (DAM's least-used row).

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain versions, `ref.lra_topn_ref` and `ref.usage_argmin_ref`. Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# csrc/usage_argmin.cu's blocks: threads, and the int4 or float4 loads a
# thread issues a round (lra_topn's rounds are of one vector, walked in
# groups of four); both sweeps size their grid to BLOCKS_PER_SM blocks an
# SM (their launch bounds).
TOPN_THREADS, ARGMIN_THREADS, ARGMIN_VEC = 256, 512, 16
BLOCKS_PER_SM = 4
TOPN_MAX_N = 8

def _check_table(name: str, table: torch.Tensor, dtype: torch.dtype,
                 valid_n: int | None, least: int) -> tuple[int, int, int]:
    """Raise unless ``table`` is a contiguous (B, rows) CUDA tensor of
    ``dtype`` with ``least`` <= valid_n <= rows. Returns (B, rows,
    valid_n)."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")

    require(table.is_cuda, "the table must be a CUDA tensor")
    require(table.dtype == dtype, f"the table must be {dtype}, got "
                                  f"{table.dtype}")
    require(table.dim() == 2 and table.is_contiguous(),
            "the table must be a contiguous (B, rows) tensor")
    B, rows = table.shape
    nv = rows if valid_n is None else valid_n
    require(least <= nv <= rows, f"valid_n={nv} outside [{least}, {rows}]")
    return B, rows, nv


@dataclass(frozen=True)
class GridPlan:
    """How a sweep kernel of csrc/usage_argmin.cu cuts a row: after a
    scalar head of up to 3 entries (to the row's first 16-byte boundary),
    block c sweeps the row's 16-byte vectors [c·per, (c+1)·per), ``blocks``
    blocks a row, and the last one also the scalar tail after the last
    whole vector. ``slots`` is the most blocks a row takes at this B for
    any valid_n: what `lra_topn`'s scratch holds."""
    per: int
    blocks: int
    slots: int


@functools.lru_cache(maxsize=256)
def grid_plan(B: int, valid_n: int, sms: int, round_vecs: int) -> GridPlan:
    """The grid of a sweep of [0, valid_n) of B rows on a card of ``sms``
    SMs: one wave (BLOCKS_PER_SM blocks an SM), a row's share of it, each
    block a whole number of rounds of ``round_vecs`` vectors (`lra_topn`:
    TOPN_THREADS; `usage_argmin`: ARGMIN_THREADS·ARGMIN_VEC). A row starting
    off a 16-byte boundary has fewer vectors than valid_n // 4, never
    more, so the plan covers every row."""
    slots = max(1, BLOCKS_PER_SM * sms // B)
    nvec = valid_n // 4
    per = -(-max(1, -(-nvec // slots)) // round_vecs) * round_vecs
    return GridPlan(per=per, blocks=max(1, -(-nvec // per)), slots=slots)


# The lra_topn kernel's scratch, one per (device, stream) and batch: B
# tickets (zero), which each launch leaves as it found them, then
# slots·TOPN_MAX_N int64 keys a row; launches on one stream run in order.
_TOPN_SCRATCH: dict[tuple[int, int, int], torch.Tensor] = {}


def _topn_launch_args(dev: torch.device, stream: int, B: int, valid_n: int):
    """(plan, scratch) of an `lra_topn` launch on ``dev``."""
    plan = grid_plan(B, valid_n, _build.sm_count(dev), TOPN_THREADS)
    key = (dev.index, stream, B)
    if key not in _TOPN_SCRATCH:
        _TOPN_SCRATCH[key] = torch.zeros((B + B * plan.slots * TOPN_MAX_N,),
                                         dtype=torch.int64, device=dev)
    return plan, _TOPN_SCRATCH[key]


def lra_topn(last_access: torch.Tensor, n: int, *,
             valid_n: int | None = None) -> torch.Tensor:
    """last_access: (B, rows) int32 CUDA tensor -> (B, n) int32 indices of
    the n smallest entries among [0, valid_n) (default: all), ascending by
    (value, index). Matches `ref.lra_topn_ref`. A float table raises."""
    if not 1 <= n <= TOPN_MAX_N:
        raise ValueError(f"lra_topn: n={n} outside [1, {TOPN_MAX_N}]")
    B, rows, nv = _check_table("lra_topn", last_access, torch.int32, valid_n,
                               n)
    fn = _build.function("usage_argmin", "lra_topn_launch",
                         [_P, _L, _I, _I, _I, _I, _I, _P, _P, _P])
    dev = last_access.device
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan, scratch = _topn_launch_args(dev, stream, B, nv)
        err = fn(last_access.data_ptr(), rows, B, nv, n, plan.per,
                 plan.blocks, scratch.data_ptr(), out.data_ptr(), stream)
    _build.check("lra_topn", err)
    lra_topn.launches += 1
    return out


lra_topn.launches = 0


# The argmin kernel's merge words, one set per (device, stream) and batch:
# B row minima (all ones) and B tickets (zero), which each launch leaves as
# it found them; launches on one stream run in order.
_STATE: dict[tuple[int, int, int], torch.Tensor] = {}


def _state(dev: torch.device, stream: int, B: int) -> torch.Tensor:
    key = (dev.index, stream, B)
    if key not in _STATE:
        _STATE[key] = torch.cat([
            torch.full((B,), -1, dtype=torch.int64, device=dev),
            torch.zeros((B,), dtype=torch.int64, device=dev)])
    return _STATE[key]


def usage_argmin(usage: torch.Tensor, *,
                 valid_n: int | None = None) -> torch.Tensor:
    """usage: (B, rows) f32 CUDA tensor -> (B,) int32 index of the minimum
    among [0, valid_n) (default: all): the lowest index wins ties, and
    -0.0 equals +0.0. Matches `ref.usage_argmin_ref`. Any other dtype
    raises (an int table has `lra_topn`). A NaN is not handled: DAM's
    usage, a sum of softmax weights, is finite, and the hot path carries
    no check."""
    B, rows, nv = _check_table("usage_argmin", usage, torch.float32, valid_n,
                               1)
    fn = _build.function("usage_argmin", "usage_argmin_launch",
                         [_P, _L, _I, _I, _I, _I, _P, _P, _P])
    dev = usage.device
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    plan = grid_plan(B, nv, _build.sm_count(dev),
                      ARGMIN_THREADS * ARGMIN_VEC)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(usage.data_ptr(), rows, B, nv, plan.per, plan.blocks,
                 _state(dev, stream, B).data_ptr(), out.data_ptr(), stream)
    _build.check("usage_argmin", err)
    usage_argmin.launches += 1
    return out


usage_argmin.launches = 0
