"""Wrapper of the row-scatter kernel (`csrc/scatter_rows.cu`), the port of
`repro/kernels/scatter_rows.py::scatter_rows` (f32 rows).

The buffer is updated **in place**, as the Pallas kernel updates it through
``input_output_aliases`` (`repro/kernels/scatter_rows.py:104`). CUDA
tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the plain
version, `ref.scatter_rows_ref`. ``scatter_rows.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
MODES = ("add", "set")
MAX_COLUMNS = 4096      # csrc/scatter_rows.cu: a block's indices in 48 KB


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"scatter_rows: {msg}")


def scatter_rows(mem: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor, *,
                 mode: str) -> torch.Tensor:
    """mem: (B, R, W) f32, idx: (B, J) int32 with every index in [0, R)
    and J <= `MAX_COLUMNS`, rows: (B, J, W) f32. 'add' adds each column's
    row into its target, a target's columns summed in j order from its old
    value; 'set' writes each target from its last column. In place; returns ``mem``. Matches
    `ref.scatter_rows_ref` bit for bit."""
    _require(mode in MODES, f"mode must be one of {MODES}, got {mode!r}")
    _require(mem.is_cuda, "mem must be a CUDA tensor")
    _require(mem.dim() == 3, f"mem must be (B, R, W), got {tuple(mem.shape)}")
    B, R, W = mem.shape
    _require(idx.dim() == 2 and idx.shape[0] == B,
             f"idx must be (B={B}, J), got {tuple(idx.shape)}")
    J = idx.shape[1]
    _require(J <= MAX_COLUMNS, f"idx has {J} columns, more than "
                               f"{MAX_COLUMNS}")
    shapes = {"mem": (mem, torch.float32, (B, R, W)),
              "idx": (idx, torch.int32, (B, J)),
              "rows": (rows, torch.float32, (B, J, W))}
    for name, (t, dtype, shape) in shapes.items():
        _require(t.device == mem.device, f"{name} is not on {mem.device}")
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(tuple(t.shape) == shape,
                 f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    if J == 0:
        return mem
    fn = _build.function("scatter_rows", "scatter_rows_launch",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(mem.device):
        err = fn(mem.data_ptr(), idx.data_ptr(), rows.data_ptr(), B, R, J, W,
                 int(mode == "add"),
                 torch.cuda.current_stream(mem.device).cuda_stream)
    _build.check("scatter_rows", err)
    scatter_rows.launches += 1
    return mem


scatter_rows.launches = 0
