"""Wrapper of the exact-read kernel (`csrc/fused_read.cu`), the port of
`repro/kernels/fused_read.py::fused_read_sweep` on f32, bf16 and int8
rows, and the grid plan that it and `topk_read` share.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.fused_read_ref`. ``fused_read_sweep.launches`` counts
the launches, and ``fused_read_sweep.launches_by_dtype`` counts them per
row dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# csrc/fused_read.cu's constants: warps a block, stages a warp's ring, the
# most rows a lane takes a round, and the shared memory a block may use.
WARPS, STAGES, MAX_BT, MAX_SMEM = 8, 3, 4, 232448
STAGE_BYTES = 4096      # a stage: rows and int8 scales, at least one round
SM_SMEM = 233472        # shared memory an SM has; 1 KB of it per block
_FIELDS = ("chunk_rows", "chunks", "tile_rows", "lanes", "bt", "piece",
           "phi_shift", "stage_bytes", "smem_bytes")


class _Plan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in _FIELDS]


@dataclass(frozen=True)
class SweepPlan:
    """How the sweep kernel cuts its work (csrc/fused_read.cu, `Plan`).

    A row's 16-byte pieces (8-byte for int8 rows at H > 4), `pieces` of
    them, go to ``lanes`` lanes (`pieces` rounded up to a power of two);
    a lane takes ``bt`` rows a round, so a warp scores 32·bt/lanes rows a
    round and a stage holds ``tile_rows`` of them. A block of `WARPS`
    warps sweeps ``chunk_rows`` rows of one batch row; ``chunks`` blocks
    cover [0, valid_n) of each. ``lanes``, ``bt``, ``piece`` and
    ``phi_shift`` depend on the row's width, dtype and H alone, so a
    row's score does too; the chunks depend on B, valid_n and the SM
    count."""
    chunk_rows: int
    chunks: int
    tile_rows: int
    lanes: int
    bt: int
    piece: int
    phi_shift: int
    stage_bytes: int
    smem_bytes: int
    k: int

    @property
    def candidates(self) -> int:
        """(value, index) pairs per (b, h) that the blocks write."""
        return self.chunks * self.k

    def struct(self) -> _Plan:
        return _Plan(*(getattr(self, name) for name in _FIELDS))


def smem_bytes(stage_bytes: int, H: int, K: int, W: int) -> int:
    """A block's shared memory (csrc/fused_read.cu, `smem_bytes`)."""
    return (WARPS * STAGES * stage_bytes + WARPS * STAGES * 8
            + WARPS * H * K * 8 + H * W * 4 + WARPS * 3 * 8 * 4 + 16)


def bank_ways(row_bytes: int, piece: int, lanes: int, bt: int,
              phi_shift: int) -> int:
    """The most lanes of one shared-memory wavefront (128 bytes: 8 lanes
    of 16-byte loads, 16 of 8-byte) whose loads of a round fall on the
    same banks: 1 is conflict-free. Lane j of group g loads piece j of row
    g·bt + (s ^ jh ^ phi) at slot s (csrc/fused_read.cu)."""
    cc, pieces, per = lanes // bt, row_bytes // piece, 128 // piece
    worst = 1
    for s in range(bt):
        for first in range(0, 32, per):
            banks: dict[int, set] = {}
            for lane in range(first, first + per):
                g, j = divmod(lane, lanes)
                if j >= pieces:
                    continue
                row = g * bt + (s ^ (j // cc) ^ ((g >> phi_shift) & (bt - 1)))
                addr = row * row_bytes + j * piece
                banks.setdefault(addr // piece % per, set()).add(addr)
            worst = max(worst, max(map(len, banks.values()), default=1))
    return worst


@functools.lru_cache(maxsize=256)
def sweep_plan(B: int, valid_n: int, W: int, itemsize: int, H: int, K: int,
               sms: int) -> SweepPlan:
    """The grid plan of a sweep of rows [0, valid_n) of B batch rows of W
    values of ``itemsize`` bytes (4 f32, 2 bf16, 1 int8 with a 4-byte
    scale a row) for H heads and K picks, on a card of ``sms`` SMs: one
    wave of resident blocks (two an SM where they fit), each a whole
    number of the block's steps of WARPS·tile_rows rows."""
    scaled = itemsize == 1
    row_bytes = W * itemsize
    piece = 8 if scaled and H > 4 else 16
    pieces = row_bytes // piece
    if row_bytes % piece or not 1 <= pieces <= 32:
        raise ValueError(f"a row of {row_bytes} bytes is not 1 to 32 pieces "
                         f"of {piece} bytes (the sweep's widest row)")
    lanes = 1 << (pieces - 1).bit_length()
    bt = min(lanes, MAX_BT)
    round_rows = 32 * bt // lanes
    stage_row = row_bytes + 4 * scaled
    tile_rows = round_rows * max(1, STAGE_BYTES // (round_rows * stage_row))
    stage = tile_rows * stage_row
    smem = smem_bytes(stage, H, K, W)
    per_sm = max(1, min(2 if H <= 4 else 1, SM_SMEM // (smem + 1024)))
    step = WARPS * tile_rows
    steps = math.ceil(valid_n / step)
    chunks = min(steps, max(1, math.ceil(sms * per_sm / B)))
    per_chunk = math.ceil(steps / chunks)
    chunks = math.ceil(steps / per_chunk)
    phi_shift = min(range(6), key=lambda sh: bank_ways(row_bytes, piece,
                                                      lanes, bt, sh))
    return SweepPlan(chunk_rows=per_chunk * step, chunks=chunks,
                     tile_rows=tile_rows, lanes=lanes, bt=bt, piece=piece,
                     phi_shift=phi_shift, stage_bytes=stage,
                     smem_bytes=smem, k=K)


# B words of zero per (device, stream, B): the tickets by which the last
# block of a batch row finds itself, which each launch leaves as it found
# them; launches on one stream run in order.
_TICKETS: dict[tuple[int, int, int], torch.Tensor] = {}


def launch_scratch(dev: torch.device, stream: int, B: int, H: int, n: int,
                   W: int, itemsize: int, k: int):
    """(plan, cand_v, cand_i, tickets) of a sweep launch on ``dev``."""
    plan = sweep_plan(B, n, W, itemsize, H, k, _build.sm_count(dev))
    key = (dev.index, stream, B)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((B,), dtype=torch.int32, device=dev)
    cand_v = torch.empty((B, H, plan.candidates), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((B, H, plan.candidates), dtype=torch.int32,
                         device=dev)
    return plan, cand_v, cand_i, _TICKETS[key]


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
    dequantized). W must be a multiple of 4 (f32), 8 (bf16) or 16 (int8),
    and a row at most 512 bytes (256 for int8 rows at H > 4). Matches
    `ref.fused_read_ref`."""
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
                          _P, _P, _P, _P, _P, _P])
    dev = q.device
    read = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    w = torch.empty((B, H, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, H, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan, cand_v, cand_i, tickets = launch_scratch(
            dev, stream, B, H, n, W, mem.element_size(), k)
        err = fn(q.data_ptr(), mem.data_ptr(),
                 None if mem_scale is None else mem_scale.data_ptr(),
                 beta.data_ptr(), B, H, k, W, n, rows, code,
                 ctypes.byref(plan.struct()), cand_v.data_ptr(),
                 cand_i.data_ptr(), tickets.data_ptr(), read.data_ptr(),
                 w.data_ptr(), idx.data_ptr(), stream)
    _build.check("fused_read_sweep", err)
    fused_read_sweep.launches += 1
    fused_read_sweep.launches_by_dtype[str(mem.dtype)[6:]] += 1
    return read, w, idx


fused_read_sweep.launches = 0
fused_read_sweep.launches_by_dtype = {"float32": 0, "bfloat16": 0, "int8": 0}
