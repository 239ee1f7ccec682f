"""Device dispatch of the memory ops (the forward, f32, single-device part
of `repro/kernels/ops.py`).

A CPU tensor takes the plain version in `kernels/ref.py`; a CUDA tensor
launches the hand-written kernel, which raises on anything it cannot take
(a float usage table, a wrong shape or dtype, a non-contiguous buffer).
There is no fallback from one to the other and no switch that swaps the
kernel out: unlike the JAX package, the kernels take any N and mask the
ragged tile themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_read import fused_read_sweep
from repro_torch.kernels.sparse_write import \
    sparse_write_update as sparse_write_kernel
from repro_torch.kernels.usage_argmin import lra_topn as lra_topn_kernel


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def lra_topn(last_access: torch.Tensor, n: int, *, valid_n: int | None = None):
    """last_access: (B, rows) int -> (B, n) int32 least-recently-accessed
    rows among [0, valid_n), most stale first (ties toward the lowest
    index)."""
    if _on_cpu(last_access):
        la = last_access if valid_n is None else last_access[:, :valid_n]
        return ref.lra_topn_ref(la, n)
    return lra_topn_kernel(last_access, n, valid_n=valid_n)


def fused_read(q: torch.Tensor, mem: torch.Tensor, beta: torch.Tensor, k: int,
               *, valid_n: int | None = None):
    """The exact read. q: (B, H, W), mem: (B, rows, W), beta: (B, H) ->
    (read (B, H, W), weights (B, H, K), indices (B, H, K) int32), sweeping
    rows [0, valid_n)."""
    if _on_cpu(mem):
        return ref.fused_read_ref(q, mem, beta, k, valid_n=valid_n)
    return fused_read_sweep(q, mem, beta, k=k, valid_n=valid_n)


def sparse_write_update(mem, last_access, write_idx, write_w, a, lra_idx,
                        step, *, delta: float):
    """The fused LRA erase + w^W a^T scatter-add + usage stamp, in place on
    ``mem`` (B, N+1, W) and ``last_access`` (B, N+1). Returns both."""
    if _on_cpu(mem):
        return ref.sparse_write_update_ref(mem, last_access, write_idx,
                                           write_w, a, lra_idx, step, delta)
    return sparse_write_kernel(mem, last_access, write_idx, write_w, a,
                               lra_idx, step, delta=delta)
