"""Carry a JAX SAM's weights and state across to the port.

Both sides share names and layout: weights are the tree
``{"lstm": {wx, wh, b}, "iface": {w, b}, "out": {w, b}}`` with matrices
kept (in, out), so ``x @ w`` holds on both sides, and the state is the
scratch-row `SAMState`. The functions take numpy leaves (or anything
`numpy.asarray` reads) and import nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import LSTMState, SAMState, SparseRead
from repro_torch.optim.optimizers import RMSPropState

_PARAM_GROUPS = {"lstm": ("wx", "wh", "b"), "iface": ("w", "b"),
                 "out": ("w", "b")}


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype)).to(device)


def params_from_jax(tree, *, device="cuda"):
    """JAX `sam.init_params` tree -> the port's parameter dict, leaf for
    leaf in the same (in, out) orientation. Raises on leaves outside the
    exact-read cell (an LSH model's ``lsh_planes``)."""
    if set(tree) != set(_PARAM_GROUPS):
        raise ValueError(f"expected groups {sorted(_PARAM_GROUPS)}, got "
                         f"{sorted(tree)}")
    out = {}
    for group, names in _PARAM_GROUPS.items():
        if set(tree[group]) != set(names):
            raise ValueError(f"{group}: expected {names}, got "
                             f"{sorted(tree[group])}")
        out[group] = {n: _tensor(tree[group][n], np.float32, device)
                      for n in names}
    return out


def state_from_jax(state, *, device="cuda") -> SAMState:
    """JAX `SAMState` (f32 rows, exact read, scratch-row layout) -> the
    port's `SAMState`, field for field."""
    if state.ann is not None or getattr(state, "mem_scale", None) is not None:
        raise ValueError("only exact-read, f32-row states convert")
    read = SparseRead(indices=_tensor(state.read.indices, np.int32, device),
                      weights=_tensor(state.read.weights, np.float32, device),
                      words=_tensor(state.read.words, np.float32, device))
    ctrl = LSTMState(h=_tensor(state.ctrl.h, np.float32, device),
                     c=_tensor(state.ctrl.c, np.float32, device))
    return SAMState(memory=_tensor(state.memory, np.float32, device),
                    last_access=_tensor(state.last_access, np.int32, device),
                    read=read, ctrl=ctrl,
                    step=_tensor(state.step, np.int32, device))


def opt_state_from_jax(state, *, device="cuda") -> RMSPropState:
    """JAX `optimizers.RMSPropState` (its ``acc`` tree in the parameters'
    layout) -> the port's `RMSPropState`, leaf for leaf."""
    return RMSPropState(acc=params_from_jax(state.acc, device=device))
