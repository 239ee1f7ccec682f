"""Wrapper of the LSH signature kernel (`csrc/lsh_hash.cu`), the port of
`repro/kernels/lsh_hash.py::lsh_hash`.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.lsh_hash_ref`. ``lsh_hash.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
MAX_BITS = 30
# csrc/lsh_hash.cu's shapes and limits: rows a warp's pass takes, warps a
# block, stages a warp's ring, the shared memory a block may use; and the
# streamed plan's tile of rows a warp, its stages and warps, and its
# persistent blocks an SM.
PASS_ROWS, MAX_WARPS, MAX_STAGES, MAX_SMEM = 8, 8, 4, 232448
STREAM_TILE, STREAM_STAGES, STREAM_WARPS, BLOCKS_PER_SM = 32, 3, 8, 2


@dataclass(frozen=True)
class HashPlan:
    """How the hash cuts its rows (csrc/lsh_hash.cu): blocks of ``warps``
    warps, each warp taking tiles of ``tile`` rows (a multiple of 8)
    through its own ring of up to ``stages`` stages. ``streamed``: at most
    BLOCKS_PER_SM persistent blocks an SM; otherwise a one-warp block a
    tile, one dependent trip."""
    streamed: bool
    tile: int
    stages: int
    warps: int

    def blocks(self, R: int, sms: int) -> int:
        """The grid for R rows on a card of ``sms`` SMs: no more warps than
        tiles (the kernel's precondition)."""
        tiles = -(-R // self.tile)
        if not self.streamed:
            return -(-tiles // self.warps)
        return max(1, min(tiles // self.warps, BLOCKS_PER_SM * sms))

    def smem(self, R: int, W: int, sms: int) -> int:
        """The kernel's shared memory (csrc `smem_bytes`): a ring a warp of
        as many stages as a warp has tiles, at most ``stages``, of
        ``tile`` rows of W floats, and an 8-byte mbarrier a stage."""
        tiles = -(-R // self.tile)
        mine = -(-tiles // (self.blocks(R, sms) * self.warps))
        return self.warps * min(self.stages, mine) * (4 * self.tile * W + 8)


def streams(R: int, sms: int) -> bool:
    """Whether R rows take the streamed plan: when they give each warp of
    its BLOCKS_PER_SM blocks an SM two full tiles at least. Below that
    (the step's hashes, R = B·H and B·J) a block per 8-row tile spreads
    the rows over the most SMs."""
    return R >= 2 * STREAM_TILE * STREAM_WARPS * BLOCKS_PER_SM * sms


@functools.lru_cache(maxsize=64)
def hash_plan(streamed: bool, W: int) -> HashPlan:
    """The plan of a regime at width W. The planes sit in registers, so
    T·bits does not enter it. Small R: a one-warp block per 8-row tile,
    one stage. Streamed: STREAM_WARPS warps of STREAM_TILE-row tiles and
    STREAM_STAGES stages, cut (stages down to 2, then the tile down to 8
    rows, then warps) while the block's rings would not fit in MAX_SMEM."""
    if not streamed:
        _require(4 * PASS_ROWS * W + 8 <= MAX_SMEM,
                 f"rows of W={W} do not fit in shared memory")
        return HashPlan(False, PASS_ROWS, 1, 1)
    tile, stages, warps = STREAM_TILE, STREAM_STAGES, STREAM_WARPS
    while warps * stages * (4 * tile * W + 8) > MAX_SMEM:
        if stages > 2:
            stages -= 1
        elif tile > PASS_ROWS:
            tile //= 2
        elif warps > 1:
            warps //= 2
        else:
            raise ValueError(f"lsh_hash: rows of W={W} do not fit in "
                             f"shared memory")
    return HashPlan(True, tile, stages, warps)


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
    sms = _build.sm_count(x.device)
    plan = hash_plan(streams(R, sms), W)
    fn = _build.function("lsh_hash", "lsh_hash_launch",
                         [_P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _P])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), planes.data_ptr(), R, W, T, bits,
                 out.data_ptr(), plan.tile, plan.stages, plan.warps,
                 plan.blocks(R, sms), stream)
    _build.check("lsh_hash", err)
    lsh_hash.launches += 1
    return out


lsh_hash.launches = 0
