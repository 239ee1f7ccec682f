"""LSTM controller (paper §3.3 — one layer, 100 hidden units). Weights
are kept (in, out), so ``x @ w`` holds as in the JAX package."""
from __future__ import annotations

import torch

from repro_torch.core.types import LSTMState, glorot


def lstm_init(generator: torch.Generator, input_size: int, hidden_size: int,
              *, device="cuda"):
    return {
        "wx": glorot(generator, (input_size, 4 * hidden_size), device=device),
        "wh": glorot(generator, (hidden_size, 4 * hidden_size), device=device),
        "b": torch.zeros(4 * hidden_size, device=device),
    }


def lstm_zero_state(batch: int, hidden_size: int, *, device="cuda") -> LSTMState:
    return LSTMState(h=torch.zeros((batch, hidden_size), device=device),
                     c=torch.zeros((batch, hidden_size), device=device))


def lstm_step(params, state: LSTMState, x: torch.Tensor):
    gates = x @ params["wx"] + state.h @ params["wh"] + params["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    # +1.0 forget-gate bias, as in the JAX controller.
    c = torch.sigmoid(f + 1.0) * state.c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return LSTMState(h=h, c=c), h


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
                device="cuda"):
    return {"w": glorot(generator, (in_dim, out_dim), device=device),
            "b": torch.zeros(out_dim, device=device)}


def linear(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]
