"""Wrapper of the fused write kernel (`csrc/sparse_write.cu`), the port of
`repro/kernels/sparse_write.py::sparse_write_update` (f32 rows).

The memory and the usage table are updated **in place**, as the Pallas
kernel updates them through ``input_output_aliases``
(`repro/kernels/sparse_write.py:207,226`). CUDA tensors only: the caller
(`kernels/ops.py`) sends CPU tensors to the plain version,
`ref.sparse_write_update_ref`. ``sparse_write_update.launches`` counts
the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _lane_step

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_write_update: {msg}")


def sparse_write_update(mem: torch.Tensor, last_access: torch.Tensor,
                        write_idx: torch.Tensor, write_w: torch.Tensor,
                        a: torch.Tensor, lra_idx: torch.Tensor, step, *,
                        delta: float):
    """Erase the ``lra_idx`` rows, add w_j · a_{j // (K+1)} into each
    ``write_idx`` row, and stamp max(la, step[b]) where w_j > δ — in place.

    mem: (B, N+1, W) f32; last_access: (B, N+1) int32 (row N is write
    scratch and is never touched); write_idx: (B, J) int32, J = H·(K+1);
    write_w: (B, J) f32; a: (B, H, W) f32; lra_idx: (B, H) int32; step:
    () or (B,)/(B, 1) int. Every index lies in [0, N), and every lra_idx
    row also appears in write_idx (SAM's write plan guarantees both).
    Returns (mem, last_access). Matches `ref.sparse_write_update_ref`."""
    _require(mem.is_cuda, "mem must be a CUDA tensor")
    B, rows, W = mem.shape
    H = a.shape[1]
    J = write_idx.shape[1]
    step = _lane_step(step, B, mem.device).contiguous()
    shapes = {"mem": (mem, torch.float32, (B, rows, W)),
              "last_access": (last_access, torch.int32, (B, rows)),
              "write_idx": (write_idx, torch.int32, (B, J)),
              "write_w": (write_w, torch.float32, (B, J)),
              "a": (a, torch.float32, (B, H, W)),
              "lra_idx": (lra_idx, torch.int32, (B, H))}
    for name, (t, dtype, shape) in shapes.items():
        _require(t.device == mem.device, f"{name} is not on {mem.device}")
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(tuple(t.shape) == shape,
                 f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(J % H == 0, f"J={J} is not a multiple of H={H}")
    fn = _build.function("sparse_write", "sparse_write_launch",
                         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                          _P])
    with torch.cuda.device(mem.device):
        err = fn(mem.data_ptr(), last_access.data_ptr(), write_idx.data_ptr(),
                 write_w.data_ptr(), a.data_ptr(), lra_idx.data_ptr(),
                 step.data_ptr(), B, rows - 1, W, J, H, delta,
                 torch.cuda.current_stream(mem.device).cuda_stream)
    _build.check("sparse_write_update", err)
    sparse_write_update.launches += 1
    return mem, last_access


sparse_write_update.launches = 0
