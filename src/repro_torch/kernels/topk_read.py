"""Wrapper of the cosine top-K kernel (`topk_read_launch` in
`csrc/fused_read.cu`), the port of `repro/kernels/topk_read.py::topk_read`:
the read of the slot-sharded memory (`distributed/mem_shard.py`) sweeps a
rank's block with it. It is the exact read's sweep with the softmax tail
compiled out, on the same row storage types (f32, bf16, and int8 with
their per-row scales), so a block's rows score as they do in
`fused_read_sweep`: a row's score depends on the row, q and H alone, never
on where the row lies.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.topk_read_ref`. ``topk_read.launches`` counts the
launches, and ``topk_read.launches_by_dtype`` counts them per row dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_read import check_rows, launch_scratch

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"topk_read: {msg}")


def topk_read(q: torch.Tensor, mem: torch.Tensor, *, k: int,
              valid_n: int | None = None,
              mem_scale: torch.Tensor | None = None):
    """q: (B, H, W) f32, mem: (B, rows, W) f32, bf16, or int8 with its
    per-row scales ``mem_scale`` (B, rows) f32, of which rows [0, valid_n)
    are swept (default: all) -> (vals (B, H, K) f32, idx (B, H, K) int32):
    the K rows of highest cosine similarity on the rows as f32 (upcast or
    dequantized), ordered by (similarity desc, index asc). W must be a
    multiple of 4 (f32), 8 (bf16) or 16 (int8), and a row at most 512
    bytes (256 for int8 rows at H > 4), as for `fused_read_sweep`. Matches
    `ref.topk_read_ref`; the indices are `fused_read_sweep`'s on the same
    inputs."""
    _require(q.is_cuda, "q must be a CUDA tensor")
    _require(mem.device == q.device, "q and mem must be on one device")
    _require(q.dtype == torch.float32 and q.is_contiguous(),
             "q must be a contiguous float32 tensor")
    _require(q.dim() == 3 and mem.dim() == 3, "q and mem must be 3-D")
    B, H, W = q.shape
    rows = mem.shape[1]
    n = rows if valid_n is None else valid_n
    _require(mem.shape[0] == B and mem.shape[2] == W,
             f"mem {tuple(mem.shape)} does not match q {tuple(q.shape)}")
    _require(1 <= k <= 8 and 1 <= H <= 8, "needs 1 <= k <= 8 and H <= 8")
    code = check_rows(_require, mem, mem_scale, W)
    _require(k <= n <= rows, f"valid_n={n} outside [{k}, {rows}]")
    fn = _build.function("fused_read", "topk_read_launch",
                         [_P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _P, _P, _P,
                          _P, _P, _P, _P])
    dev = q.device
    vals = torch.empty((B, H, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, H, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan, cand_v, cand_i, tickets = launch_scratch(
            dev, stream, B, H, n, W, mem.element_size(), k)
        err = fn(q.data_ptr(), mem.data_ptr(),
                 None if mem_scale is None else mem_scale.data_ptr(), B, H,
                 k, W, n, rows, code, ctypes.byref(plan.struct()),
                 cand_v.data_ptr(), cand_i.data_ptr(), tickets.data_ptr(),
                 vals.data_ptr(), idx.data_ptr(), stream)
    _build.check("topk_read", err)
    topk_read.launches += 1
    topk_read.launches_by_dtype[str(mem.dtype)[6:]] += 1
    return vals, idx


topk_read.launches = 0
topk_read.launches_by_dtype = {"float32": 0, "bfloat16": 0, "int8": 0}
