"""Dense baselines, the port of `repro/core/dense.py`: DAM (the dense
approximation to SAM, §3.2), the NTM and the plain LSTM.

DAM uses the discounted usage U^(1) and SAM's write rule (eq. 5), with
dense read weights: the paper's control for "does sparsity hurt
learning". Its least-used row is `ops.usage_argmin`, the port's kernel on
the card. The NTM is Graves et al. 2014's head, content plus location
addressing (interpolate, shift, sharpen). The LSTM baseline has no memory.

The dense models keep the plain (B, N, W) memory, with no scratch row
(`types.DenseState`). A step is written once, functionally, as in JAX:
every step makes a new memory, so the same code runs the forward (`Dense`,
under `torch.inference_mode`) and records autograd for training, which
keeps each step's activations (`activation_bytes`); the JAX package trains
these kinds by a plain scan under `jax.grad` too.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core import addressing as addr
from repro_torch.core.controller import (linear, linear_init, lstm_init,
                                         lstm_step, lstm_zero_state)
from repro_torch.core.types import (ControllerConfig, DenseState,
                                    MemoryConfig)
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    memory: MemoryConfig
    controller: ControllerConfig
    model: str = "dam"            # "dam" | "ntm"
    shift_range: int = 1          # NTM: allowed shifts [-s..s]

    def __post_init__(self):
        if self.model not in ("dam", "ntm"):
            raise ValueError(f"model={self.model!r}: expected 'dam' or 'ntm'")


def _iface_size(cfg: DenseConfig) -> int:
    H, W = cfg.memory.num_heads, cfg.memory.word_size
    if cfg.model == "dam":
        # Per head: query W, beta 1, write word W, alpha 1, gamma 1.
        return H * (2 * W + 3)
    # NTM per head: query W, beta 1, gate 1, shifts 2s+1, sharpen 1,
    # erase W, add W.
    return H * (3 * W + 3 + (2 * cfg.shift_range + 1))


def init_params(generator: torch.Generator, cfg: DenseConfig, *,
                device="cuda"):
    """Weights of the JAX shapes and glorot scale, drawn in order (LSTM
    wx, wh, interface, output) from ``generator``."""
    mem, ctl = cfg.memory, cfg.controller
    H, W = mem.num_heads, mem.word_size
    return {
        "lstm": lstm_init(generator, ctl.input_size + H * W, ctl.hidden_size,
                          device=device),
        "iface": linear_init(generator, ctl.hidden_size, _iface_size(cfg),
                             device=device),
        "out": linear_init(generator, ctl.hidden_size + H * W,
                           ctl.output_size, device=device),
    }


def init_state(batch: int, cfg: DenseConfig, *, device="cuda") -> DenseState:
    """The JAX initial state: every memory cell 1e-6, the usage table
    arange(N)·1e-6 in f32 (the stagger that orders the first allocations),
    all read and write weight on row 0, a zero read and controller."""
    mem, ctl = cfg.memory, cfg.controller
    H, W, N = mem.num_heads, mem.word_size, mem.num_slots
    w0 = torch.zeros((batch, H, N), device=device)
    w0[:, :, 0] = 1.0
    usage = torch.arange(N, dtype=torch.float32, device=device) * 1e-6
    return DenseState(
        memory=torch.full((batch, N, W), 1e-6, device=device),
        usage=usage.expand(batch, N).contiguous(),
        read_w=w0, read_words=torch.zeros((batch, H, W), device=device),
        write_w=w0.clone(),
        ctrl=lstm_zero_state(batch, ctl.hidden_size, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _controller(params, s: DenseState, x: torch.Tensor):
    B = x.shape[0]
    return lstm_step(params["lstm"], s.ctrl,
                     torch.cat([x, s.read_words.reshape(B, -1)], dim=-1))


def _output(params, h: torch.Tensor, read_words: torch.Tensor):
    return linear(params["out"],
                  torch.cat([h, read_words.reshape(h.shape[0], -1)], dim=-1))


def _dam_step(params, cfg: DenseConfig, s: DenseState, x: torch.Tensor):
    mem = cfg.memory
    H, W, N = mem.num_heads, mem.word_size, mem.num_slots
    ctrl, h = _controller(params, s, x)
    p = linear(params["iface"], h).reshape(x.shape[0], H, 2 * W + 3)
    q, a = p[..., :W], p[..., W:2 * W]
    beta = F.softplus(p[..., 2 * W]) + 1.0
    alpha = torch.sigmoid(p[..., 2 * W + 1])
    gamma = torch.sigmoid(p[..., 2 * W + 2])

    # The least-used row from the discounted usage U^(1), as a dense one-hot.
    lra = ops.usage_argmin(s.usage.detach())                  # (B,)
    i_u = F.one_hot(lra.long(), N).to(s.memory.dtype)[:, None, :]   # (B,1,N)
    write_w = alpha[..., None] * (gamma[..., None] * s.read_w
                                  + (1 - gamma[..., None]) * i_u)
    # Erase the least-used row, then the dense outer-product add (eq. 3).
    erase = 1.0 - i_u[:, 0, :, None]                          # (B,N,1)
    memory = s.memory * erase + addr.outer_rows(write_w, a)

    read_w = addr.dense_read_weights(q, memory, beta)         # (B,H,N)
    read_words = addr.dense_read(read_w, memory)
    usage = addr.dam_usage_update(s.usage, read_w, write_w, mem.usage_discount)
    return DenseState(memory=memory, usage=usage, read_w=read_w,
                      read_words=read_words, write_w=write_w, ctrl=ctrl,
                      step=s.step + 1), _output(params, h, read_words)


def _ntm_step(params, cfg: DenseConfig, s: DenseState, x: torch.Tensor):
    mem = cfg.memory
    H, W = mem.num_heads, mem.word_size
    r = cfg.shift_range
    S = 2 * r + 1
    ctrl, h = _controller(params, s, x)
    p = linear(params["iface"], h).reshape(x.shape[0], H, 3 * W + 3 + S)
    q, p = p[..., :W], p[..., W:]
    beta = F.softplus(p[..., 0]) + 1.0
    gate = torch.sigmoid(p[..., 1])
    shift = torch.softmax(p[..., 2:2 + S], dim=-1)
    sharpen = F.softplus(p[..., 2 + S]) + 1.0
    erase = torch.sigmoid(p[..., 3 + S:3 + S + W])
    add = p[..., 3 + S + W:]

    wc = addr.dense_read_weights(q, s.memory, beta)           # content
    wg = gate[..., None] * wc + (1 - gate[..., None]) * s.write_w
    # Circular convolution with the shift kernel: shift j moves the
    # weighting by j - r rows (JAX's wg[:, :, (n - (j - r)) % N]).
    w_sh = sum(shift[..., j, None] * torch.roll(wg, j - r, dims=-1)
               for j in range(S))
    w = w_sh ** sharpen[..., None]
    w = w / (w.sum(-1, keepdim=True) + 1e-8)

    # Write: erase then add (eq. 3), the heads' erasures multiplied.
    keep = torch.prod(1.0 - torch.einsum("bhn,bhw->bhnw", w, erase), dim=1)
    memory = s.memory * keep + addr.outer_rows(w, add)

    read_w = addr.dense_read_weights(q, memory, beta)
    read_words = addr.dense_read(read_w, memory)
    return DenseState(memory=memory, usage=s.usage, read_w=read_w,
                      read_words=read_words, write_w=w, ctrl=ctrl,
                      step=s.step + 1), _output(params, h, read_words)


def dense_step(params, cfg: DenseConfig, s: DenseState, x: torch.Tensor):
    """One step of DAM or the NTM. Returns (new_state, y_t); the state
    passed in is left as it was."""
    if cfg.model == "dam":
        return _dam_step(params, cfg, s, x)
    return _ntm_step(params, cfg, s, x)


def dense_unroll(params, cfg: DenseConfig, state: DenseState,
                 xs: torch.Tensor):
    """Run `dense_step` over xs (T, B, D). Returns (final_state, ys (T, B,
    output_size)); records autograd when its inputs require grad."""
    ys = []
    for x in xs:
        state, y = dense_step(params, cfg, state, x)
        ys.append(y)
    return state, torch.stack(ys)


def activation_bytes(cfg: DenseConfig, batch: int) -> int:
    """Bytes of the tensors that autograd keeps for one `dense_step` (f32),
    the new memory among them. Per batch row and memory row: DAM keeps 2
    rows of W floats (the new memory and its normalized copy), 5 of H and
    3 single floats; the NTM keeps H + 4 rows of W (the heads' erase
    factors (B, H, N, W), their product, the new memory, the normalized old
    and new memory), 12 of H and 2 single floats. Per chunk of the
    products over N (`addressing.row_chunks`), one (H, W) copy of the
    query or the write word for each product that broadcasts it: 2 for
    DAM, 3 for the NTM. Beside them, a bound on the controller's and the
    interface's small tensors. Exact in N where `addressing.READ_ROWS`
    divides N, an upper bound elsewhere. A T-step unroll under autograd
    keeps T times this beside the initial state. Held against the tensors
    autograd saves in `tests/test_torch_dense.py`."""
    mem, ctl = cfg.memory, cfg.controller
    H, W, N = mem.num_heads, mem.word_size, mem.num_slots
    if cfg.model == "dam":
        per_row, broadcasts = 2 * W + 5 * H + 3, 2
    else:
        per_row, broadcasts = (H + 4) * W + 12 * H + 2, 3
    small = (ctl.input_size + 2 * H * W + 7 * ctl.hidden_size
             + 3 * _iface_size(cfg))
    return 4 * batch * (N * per_row + broadcasts * addr.row_chunks(N) * H * W
                        + small)


# ----------------------------- LSTM baseline -----------------------------

def lstm_baseline_init(generator: torch.Generator, cfg: ControllerConfig, *,
                       device="cuda"):
    return {"lstm": lstm_init(generator, cfg.input_size, cfg.hidden_size,
                              device=device),
            "out": linear_init(generator, cfg.hidden_size, cfg.output_size,
                               device=device)}


def lstm_baseline_unroll(params, cfg: ControllerConfig, batch: int,
                         xs: torch.Tensor):
    """The controller alone over xs (T, B, D), on xs's device. Returns
    (final LSTMState, ys (T, B, output_size))."""
    s = lstm_zero_state(batch, cfg.hidden_size, device=xs.device)
    ys = []
    for x in xs:
        s, h = lstm_step(params["lstm"], s, x)
        ys.append(linear(params["out"], h))
    return s, torch.stack(ys)


class Dense(nn.Module):
    """DAM or the NTM as a module, shaped like `sam.SAM`: trainable
    weights in the JAX tree layout (`params()`), and a `forward` that
    unrolls the model over a sequence without a graph."""

    def __init__(self, cfg: DenseConfig, params=None, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(torch.Generator().manual_seed(seed), cfg,
                                 device=device)

        def group(tree):
            return nn.ParameterDict({k: nn.Parameter(v)
                                     for k, v in tree.items()})

        self.lstm = group(params["lstm"])
        self.iface = group(params["iface"])
        self.out = group(params["out"])

    def params(self):
        """The weights as the nested dict that `dense_step` takes."""
        return {"lstm": dict(self.lstm), "iface": dict(self.iface),
                "out": dict(self.out)}

    def init_state(self, batch: int) -> DenseState:
        return init_state(batch, self.cfg, device=self.lstm["b"].device)

    def forward(self, state: DenseState, xs: torch.Tensor):
        with torch.inference_mode():
            return dense_unroll(self.params(), self.cfg, state, xs)
