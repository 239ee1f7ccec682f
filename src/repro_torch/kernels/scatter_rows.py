"""Wrapper of the row-scatter kernel (`csrc/scatter_rows.cu`), the port of
`repro/kernels/scatter_rows.py::scatter_rows` on f32 and bf16 rows, and of
the int8 (row, scale) restore that the JAX package runs through its
oracle (`repro/kernels/ref.py::scatter_rows_q_ref`, 'set' of int8 rows).

The buffer is updated **in place**, as the Pallas kernel updates it through
``input_output_aliases`` (`repro/kernels/scatter_rows.py:104`). CUDA
tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the plain
versions, `ref.scatter_rows_ref` and `ref.scatter_rows_q_ref`.
``scatter_rows.launches`` counts the launches, and
``scatter_rows.launches_by_dtype`` counts them per row dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
MODES = ("add", "set")
MAX_COLUMNS = 4096      # csrc/scatter_rows.cu: a block's indices in 48 KB
# The launcher of each row dtype; int8 rows take 'set' only.
_LAUNCH = {torch.float32: "scatter_rows_launch",
           torch.bfloat16: "scatter_rows_bf16_launch"}
# The open roadmap item that an int8 'add' on the card waits on: the LM
# memory layer on int8 rows is the first path that would need it.
INT8_ADD_ITEM = ("scatter_rows 'add' of int8 rows on the card is ROADMAP.md "
                 "A9c (the LM memory layer's int8 rows); the card restores "
                 "recorded (row, scale) pairs ('set') only")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"scatter_rows: {msg}")


def scatter_rows(mem: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *,
                 mode: str, mem_scale: torch.Tensor | None = None,
                 rows_scale: torch.Tensor | None = None) -> torch.Tensor:
    """mem: (B, R, W) f32 or bf16, idx: (B, J) int32 with every index in
    [0, R) and J <= `MAX_COLUMNS`, rows: (B, J, W) in mem's dtype. 'add'
    adds each column's row into its target, a target's columns summed in
    j order from its old value (bf16: rounded after each add); 'set'
    writes each target from its last column. With ``mem_scale`` (B, R)
    f32, mem holds int8 rows and only 'set' is taken: rows are int8 codes
    and ``rows_scale`` (B, J) f32 their scales, restored together. In
    place; returns ``mem``. Matches `ref.scatter_rows_ref` /
    `ref.scatter_rows_q_ref` bit for bit."""
    _require(mode in MODES, f"mode must be one of {MODES}, got {mode!r}")
    _require(mem.is_cuda, "mem must be a CUDA tensor")
    _require(mem.dim() == 3, f"mem must be (B, R, W), got {tuple(mem.shape)}")
    B, R, W = mem.shape
    _require(idx.dim() == 2 and idx.shape[0] == B,
             f"idx must be (B={B}, J), got {tuple(idx.shape)}")
    J = idx.shape[1]
    _require(J <= MAX_COLUMNS, f"idx has {J} columns, more than "
                               f"{MAX_COLUMNS}")
    int8 = mem_scale is not None
    if int8:
        if mode == "add":
            raise NotImplementedError(INT8_ADD_ITEM)
        _require(rows_scale is not None,
                 "int8 'set' rows need their recorded scales (rows_scale)")
        dtype = torch.int8
    else:
        _require(mem.dtype in _LAUNCH, f"mem must be float32 or bfloat16 "
                 f"(int8 with mem_scale), got {mem.dtype}")
        dtype = mem.dtype
    shapes = {"mem": (mem, dtype, (B, R, W)),
              "idx": (idx, torch.int32, (B, J)),
              "rows": (rows, dtype, (B, J, W))}
    if int8:
        shapes.update(mem_scale=(mem_scale, torch.float32, (B, R)),
                      rows_scale=(rows_scale, torch.float32, (B, J)))
    for name, (t, want, shape) in shapes.items():
        _require(t.device == mem.device, f"{name} is not on {mem.device}")
        _require(t.dtype == want, f"{name} must be {want}, got {t.dtype}")
        _require(tuple(t.shape) == shape,
                 f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    if J == 0:
        return mem
    with torch.cuda.device(mem.device):
        stream = torch.cuda.current_stream(mem.device).cuda_stream
        if int8:
            fn = _build.function("scatter_rows", "scatter_rows_q_launch",
                                 [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
            err = fn(mem.data_ptr(), mem_scale.data_ptr(), idx.data_ptr(),
                     rows.data_ptr(), rows_scale.data_ptr(), B, R, J, W,
                     stream)
        else:
            fn = _build.function("scatter_rows", _LAUNCH[dtype],
                                 [_P, _P, _P, _I, _I, _I, _I, _I, _P])
            err = fn(mem.data_ptr(), idx.data_ptr(), rows.data_ptr(), B, R,
                     J, W, int(mode == "add"), stream)
    _build.check("scatter_rows", err)
    scatter_rows.launches += 1
    scatter_rows.launches_by_dtype[str(dtype)[6:]] += 1
    return mem


scatter_rows.launches = 0
scatter_rows.launches_by_dtype = {"float32": 0, "bfloat16": 0, "int8": 0}
