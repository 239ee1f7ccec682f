"""Wrapper of the fused write kernels (`csrc/sparse_write.cu`), the port
of `repro/kernels/sparse_write.py::sparse_write_update`: `_kernel` on f32
or bf16 rows and `_kernel_q` on int8 rows with their per-row scales.

The memory, the usage table and the scales are updated **in place**, as
the Pallas kernels update them through ``input_output_aliases``
(`repro/kernels/sparse_write.py:207,226`). CUDA tensors only: the caller
(`kernels/ops.py`) sends CPU tensors to the plain versions,
`ref.sparse_write_update_ref` and `ref.sparse_write_update_q_ref`.
``sparse_write_update.launches`` counts the launches, and
``sparse_write_update.launches_by_dtype`` counts them per row dtype.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _lane_step

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# csrc/sparse_write.cu's limits of the f32/bf16 write: columns a block
# stages, floats of a a block stages, threads a block; and the plan's
# aims: at most PIECES pieces a block, slices no narrower than MIN_WORDS.
MAX_COLUMNS, MAX_A_WORDS, MAX_THREADS = 1024, 4096, 1024
PIECES, MIN_WORDS = 256, 32
# The int8 write's: threads a block, elements a thread stages a round in
# its first trip, the shared memory a block may use.
MAX_Q_THREADS, Q_STAGE, MAX_SMEM = 512, 4, 232448


@dataclass(frozen=True)
class WritePlan:
    """How the f32/bf16 write cuts its work (csrc/sparse_write.cu): a
    block per (slice of ``words`` words of W, batch row), ``slices`` of
    them a batch row, ``threads`` a block, each thread on pieces of
    ``vec`` values of a column's row in the slice (up to 4 at once)."""
    words: int
    slices: int
    threads: int
    vec: int


@functools.lru_cache(maxsize=256)
def write_plan(J: int, W: int, H: int, vec: int) -> WritePlan:
    """The write's plan for J columns of W words, H heads of a, pieces of
    ``vec`` values (a 16-byte vector where W and the buffers allow it, else
    1). W is cut into slices (halved, kept a multiple of vec) while a
    block would hold more than PIECES pieces and a slice stays at least
    MIN_WORDS wide, or while the slice of a is more than MAX_A_WORDS
    floats; a block has a thread a piece, up to MAX_THREADS."""
    _require(J <= MAX_COLUMNS, f"{J} columns, more than {MAX_COLUMNS}")
    _require(W % vec == 0, f"W={W} is not a multiple of vec={vec}")
    words = W
    while True:
        half = -(-words // (2 * vec)) * vec      # half, a multiple of vec
        wide = J * (words // vec) > PIECES and half >= MIN_WORDS
        if half >= words or not (wide or H * words > MAX_A_WORDS):
            break
        words = half
    _require(H * words <= MAX_A_WORDS,
             f"H={H} heads of a take {H * words} floats a slice, more than "
             f"{MAX_A_WORDS}")
    pieces = J * (words // vec)
    threads = min(MAX_THREADS, -(-pieces // 32) * 32)
    return WritePlan(words=words, slices=-(-W // words), threads=threads,
                     vec=vec)


@dataclass(frozen=True)
class QPlan:
    """How the int8 write cuts its work (csrc/sparse_write.cu): a block of
    ``threads`` per batch row, each thread on one piece of ``vec`` codes
    (16, or 1 where W or the memory is not 16-byte aligned) a round, in
    ``smem`` bytes of shared memory, which hold all of a when
    ``stage_a``."""
    threads: int
    vec: int
    stage_a: bool
    smem: int


def q_smem(J: int, W: int, H: int, stage_a: bool) -> int:
    """The int8 write's shared memory (csrc `q_smem`): six words a column,
    the H LRA rows and the step, and all of a (H·W floats) if staged."""
    return 4 * ((H * W if stage_a else 0) + 6 * J + H + 1)


@functools.lru_cache(maxsize=256)
def q_plan(J: int, W: int, H: int, vec: int) -> QPlan:
    """The int8 write's plan for J columns of W codes, H heads of a: a
    staged in shared memory where it fits beside the columns (else the
    sums read it from device memory); a thread a piece (J·W/vec of them),
    and at least enough threads for a staged a to go in one round of
    Q_STAGE loads a thread, in whole warps, up to MAX_Q_THREADS (more
    pieces go in rounds)."""
    _require(W % vec == 0, f"W={W} is not a multiple of vec={vec}")
    stage_a = q_smem(J, W, H, True) <= MAX_SMEM
    smem = q_smem(J, W, H, stage_a)
    _require(smem <= MAX_SMEM,
             f"J={J} columns take {smem} bytes of shared memory, more than "
             f"{MAX_SMEM}")
    need = max(J * (W // vec), -(-H * W // Q_STAGE) if stage_a else 0)
    threads = min(MAX_Q_THREADS, -(-need // 32) * 32)
    return QPlan(threads=threads, vec=vec, stage_a=stage_a, smem=smem)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_write_update: {msg}")


def sparse_write_update(mem: torch.Tensor, last_access: torch.Tensor,
                        write_idx: torch.Tensor, write_w: torch.Tensor,
                        a: torch.Tensor, lra_idx: torch.Tensor, step, *,
                        delta: float, mem_scale: torch.Tensor | None = None):
    """Erase the ``lra_idx`` rows, add w_j · a_{j // (K+1)} into each
    ``write_idx`` row, and stamp max(la, step[b]) where w_j > δ — in place.

    mem: (B, N+1, W) f32; bf16 (each column's w·a rounded to bf16 once and
    each add rounded to bf16); or int8 with its per-row scales
    ``mem_scale`` (B, N+1) f32 (each touched row is dequantized, zero if
    erased, takes its columns' w·a in j order as fused multiply-adds and
    is re-quantized once: ``scale = max|row|·fl(1/127)``,
    ``q = rint(row / scale)`` clipped to ±127). last_access: (B, N+1)
    int32 (row N is write scratch and is never touched); write_idx: (B, J)
    int32, J = H·(K+1); write_w: (B, J) f32; a: (B, H, W) f32; lra_idx:
    (B, H) int32; step: () or (B,)/(B, 1) int. Every index lies in
    [0, N), and every lra_idx row also appears in write_idx (SAM's write
    plan guarantees both). Returns (mem, last_access), or (mem,
    last_access, mem_scale) on int8 rows. Matches
    `ref.sparse_write_update_ref` / `ref.sparse_write_update_q_ref` bit
    for bit."""
    _require(mem.is_cuda, "mem must be a CUDA tensor")
    _require(mem.dtype in _build.ROW_CODE,
             f"mem must be float32, bfloat16 or int8, got {mem.dtype}")
    int8 = mem.dtype == torch.int8
    _require(int8 == (mem_scale is not None),
             "int8 rows need their mem_scale" if int8
             else f"{mem.dtype} rows take no mem_scale")
    B, rows, W = mem.shape
    N, H, J = rows - 1, a.shape[1], write_idx.shape[1]
    # A () step is read by every batch row in place (stride 0): no copy,
    # so the write is one launch.
    step = _lane_step(step, B, mem.device)
    shapes = {"last_access": (last_access, torch.int32, (B, rows)),
              "write_idx": (write_idx, torch.int32, (B, J)),
              "write_w": (write_w, torch.float32, (B, J)),
              "a": (a, torch.float32, (B, H, W)),
              "lra_idx": (lra_idx, torch.int32, (B, H))}
    if int8:
        shapes["mem_scale"] = (mem_scale, torch.float32, (B, rows))
    _require(mem.is_contiguous(), "mem must be contiguous")
    for name, (t, dtype, shape) in shapes.items():
        _require(t.device == mem.device, f"{name} is not on {mem.device}")
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(tuple(t.shape) == shape,
                 f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(J % H == 0, f"J={J} is not a multiple of H={H}")
    per = 16 // mem.element_size()
    if int8:
        aligned = W % per == 0 and mem.data_ptr() % 16 == 0
        qplan = q_plan(J, W, H, per if aligned else 1)
    else:
        aligned = (W % per == 0 and mem.data_ptr() % 16 == 0
                   and a.data_ptr() % 16 == 0)
        plan = write_plan(J, W, H, per if aligned else 1)
    stream = torch.cuda.current_stream(mem.device).cuda_stream
    with torch.cuda.device(mem.device):
        if int8:
            fn = _build.function("sparse_write", "sparse_write_q_launch",
                                 [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _F, _I, _I, _P])
            err = fn(mem.data_ptr(), mem_scale.data_ptr(),
                     last_access.data_ptr(), write_idx.data_ptr(),
                     write_w.data_ptr(), a.data_ptr(), lra_idx.data_ptr(),
                     step.data_ptr(), step.stride(0), B, N, W, J, H, delta,
                     qplan.vec, qplan.threads, stream)
        else:
            fn = _build.function("sparse_write", "sparse_write_launch",
                                 [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _F, _I, _I, _I, _I, _P])
            err = fn(mem.data_ptr(), last_access.data_ptr(),
                     write_idx.data_ptr(), write_w.data_ptr(), a.data_ptr(),
                     lra_idx.data_ptr(), step.data_ptr(), step.stride(0), B,
                     N, W, J, H, delta, _build.ROW_CODE[mem.dtype],
                     plan.words, plan.threads, plan.vec, stream)
    _build.check("sparse_write_update", err)
    sparse_write_update.launches += 1
    sparse_write_update.launches_by_dtype[str(mem.dtype)[6:]] += 1
    return (mem, last_access, mem_scale) if int8 else (mem, last_access)


sparse_write_update.launches = 0
sparse_write_update.launches_by_dtype = {"float32": 0, "bfloat16": 0,
                                         "int8": 0}
