"""Wrapper of the causal GQA attention kernel (`csrc/flash_attention.cu`),
the port of `repro/kernels/flash_attention.py::flash_attention`, with the
sliding window, the prefix-LM and a v narrower than q and k (MLA's) of
`repro/models/attention.py::chunked_attention`.

CUDA tensors only: the caller (`kernels/ops.py`) sends CPU tensors to the
plain version, `ref.flash_attention_ref`. ``flash_attention.launches``
counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The (q·k, v) head dims built: (D, D), and DeepSeek-V2 MLA's (nope 128 +
# rope 64, v 128).
HEAD_DIM_PAIRS = tuple((d, d) for d in (16, 32, 64, 120, 128, 256)) + (
    (192, 128),)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def check_mask_args(window, prefix) -> None:
    """Raise unless ``window`` is None or an int >= 1 and ``prefix`` an
    int >= 0 (the mask's arguments, on any device)."""
    _require(window is None or (isinstance(window, int)
                                and not isinstance(window, bool)
                                and window >= 1),
             f"window must be None or a positive int, got {window!r}")
    _require(isinstance(prefix, int) and not isinstance(prefix, bool)
             and prefix >= 0,
             f"prefix must be a non-negative int, got {prefix!r}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int | None = None,
                    prefix: int = 0) -> torch.Tensor:
    """q, k: (B, S, H, DQK), (B, S, Hkv, DQK), v: (B, S, Hkv, DV) CUDA
    tensors of one dtype, f32 or bf16, contiguous -> o (B, S, H, DV) in
    q's dtype: causal attention with scores q·kᵀ·DQK^-0.5 in f32, query
    head h reading kv head h // (H // Hkv); with ``window`` (>= 1) query i
    sees only the keys j with i - j < window; every query also sees the
    keys j < ``prefix`` (an int >= 0; one past S shows all S). (DQK, DV)
    is one of HEAD_DIM_PAIRS: (D, D) with D 16, 32, 64, 120, 128 or 256,
    or (192, 128); any S. Matches `ref.flash_attention_ref`."""
    check_mask_args(window, prefix)
    _require(q.is_cuda, "q must be a CUDA tensor")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"q must be float32 or bfloat16, got {q.dtype}")
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "q, k and v must be 4-D: (B, S, H, D) and (B, S, Hkv, D)")
    B, S, H, D = q.shape
    Hkv, DV = k.shape[2], v.shape[-1]
    _require(Hkv >= 1 and H % Hkv == 0,
             f"the kv heads ({Hkv}) must divide the query heads ({H})")
    _require((D, DV) in HEAD_DIM_PAIRS,
             f"head dims (q·k {D}, v {DV}) not in {HEAD_DIM_PAIRS}")
    _require(B * H <= 65535, f"B·H = {B * H} exceeds the grid's 65535")
    for name, t, width in (("k", k, D), ("v", v, DV)):
        _require(tuple(t.shape) == (B, S, Hkv, width),
                 f"{name} must be {(B, S, Hkv, width)}, got "
                 f"{tuple(t.shape)}")
        _require(t.device == q.device and t.dtype == q.dtype,
                 f"{name} must be {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((B, S, H, DV), dtype=q.dtype, device=q.device)
    fn = _build.function("flash_attention", "flash_attention_launch",
                         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _F, _P])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, Hkv, D, DV, _build.ROW_CODE[q.dtype], window or 0,
                 min(prefix, S), D ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
