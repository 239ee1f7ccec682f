"""The sparse-rollback BPTT engine (paper §3.4, Suppl. Fig. 5), the port of
`repro/core/unroll.py` for one device.

Three modes, as in the JAX package:

  * ``naive`` — a plain loop of `cell.step` under autograd: every step's
    read and write record a dense (B, N+1, W) memory gradient. The
    in-process oracle, at small N only;
  * ``sparse`` — the forward records O(K·W) per step (`StepDeltas` plus
    the previous read and controller state); the backward rolls the
    memory back row by row and replays each step with its recorded
    selections;
  * ``chunked`` — the forward keeps a dense copy of the state at the start
    of each C-step segment and nothing else; the backward recomputes each
    segment from its copy (running the forward kernels again), then rolls
    it back as the sparse mode does. A T % C tail is a shorter last
    segment, so the accounting is that of the JAX engine:
    ceil(T/C)·state + C·res.

The memory is updated **in place**: the returned state's ``memory`` and
``last_access`` are the tensors of ``state0``. The sparse and chunked
backwards leave the memory as it was before the unroll, bit for bit (the
usage table is left stale: the backward never reads it), and need the
memory to hold the unroll's final memory when they start. After such a
backward, neither ``state0`` nor the returned state is a valid state any
more (the memory is M₀, the usage table that of step T): the backward
flags the memory (`types.mark_rolled_back`) and a later step from either
raises. Gradients reach the parameters,
xs and the float leaves of ``state0``; the memory's gradient is one dense
cotangent buffer that the whole backward updates in place (`core/cell.py`),
and the backward launches no O(N) kernel outside the chunked recompute.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.types import (mark_rolled_back, require_f32_rows,
                                    tree_bytes)


def _split(tree):
    """(the tensor leaves of ``tree``, a template `_join` rebuilds it from)."""
    leaves, spec = pytree.tree_flatten(tree)
    is_tensor = [isinstance(t, torch.Tensor) for t in leaves]
    return ([t for t, m in zip(leaves, is_tensor) if m],
            (spec, is_tensor, [None if m else t
                               for t, m in zip(leaves, is_tensor)]))


def _join(tensors, template):
    spec, is_tensor, rest = template
    it = iter(tensors)
    return pytree.tree_unflatten(
        [next(it) if m else t for m, t in zip(is_tensor, rest)], spec)


def _small_floats(state) -> list:
    """The float leaves of a state other than its memory, in order."""
    return [t for t in _split(state._replace(memory=None))[0]
            if t.is_floating_point()]


def _with_small_floats(state, floats):
    tensors, template = _split(state._replace(memory=None))
    it = iter(floats)
    tensors = [next(it) if t.is_floating_point() else t for t in tensors]
    return _join(tensors, template)._replace(memory=state.memory)


def unroll_naive(cell, params, state, xs):
    """Plain loop through `cell.step` — the O(T·state) residual baseline.
    Returns (stateT, ys (T, B, out))."""
    ys = []
    for x in xs:
        state, y = cell.step(params, state, x)
        ys.append(y)
    return state, torch.stack(ys)


@torch.no_grad()
def _collect(cell, params, state, xs):
    """Forward that also records each step's rollback residuals:
    (residual_state(s_{t-1}), deltas_t)."""
    ys, res = [], []
    for x in xs:
        prev_small = cell.residual_state(state)
        state, y, deltas = cell.step(params, state, x, collect_deltas=True)
        ys.append(y)
        res.append((prev_small, deltas))
    return state, torch.stack(ys), res


def _segment_bwd(cell, params, state, res, xs, cts, ct_ys, mem_ct, g_params,
                 g_xs):
    """Roll one segment back, step by step from its end. ``params`` require
    grad; each step adds its gradients into the ``g_params`` leaves and
    writes ``g_xs[t]``, and updates ``mem_ct`` in place. ``cts`` are the
    cotangents of the end state's small float leaves. Returns (the
    segment's start state, the cotangents of its small float leaves)."""
    p_leaves = pytree.tree_leaves(params)
    for t in reversed(range(len(xs))):
        prev_small, deltas = res[t]
        state = cell.rollback(state, prev_small, deltas)
        with torch.enable_grad():
            diff = [leaf.detach().requires_grad_()
                    for leaf in _small_floats(state)]
            x = xs[t].detach().requires_grad_()
            ns, y = cell.replay_step(params, _with_small_floats(state, diff),
                                     x, deltas, mem_ct)
            inputs = [*p_leaves, *diff, x]
            grads = torch.autograd.grad([*_small_floats(ns), y], inputs,
                                        [*cts, ct_ys[t]], allow_unused=True)
        # The replay wrote this step's rows again: roll them back once more.
        state = cell.rollback(state, prev_small, deltas)
        grads = [torch.zeros_like(i) if g is None else g
                 for i, g in zip(inputs, grads)]
        for acc, g in zip(g_params, grads):
            acc.add_(g)
        cts = grads[len(p_leaves):-1]
        g_xs[t] = grads[-1]
    return state, cts


class _RollbackUnroll(torch.autograd.Function):
    """The sparse (``chunk=None``) and chunked unrolls as one autograd node.
    Inputs: the cell, the chunk, the parameter and state templates, xs,
    then the parameters' and the state's tensor leaves. Outputs: ys, then
    the final state's tensor leaves, of which the memory and the usage
    table are the input tensors, updated in place."""

    @staticmethod
    def forward(ctx, cell, chunk, p_template, s_template, xs, *leaves):
        n_p = len(p_template[1])
        params = _join(leaves[:n_p], p_template)
        state = _join(leaves[n_p:], s_template)
        T = xs.shape[0]
        if chunk is None:
            state, ys, ctx.res = _collect(cell, params, state, xs)
            ctx.bounds = [0, T]
        else:
            ctx.bounds = list(range(0, T, chunk)) + [T]
            ctx.checkpoints, ys = [], []
            for lo, hi in zip(ctx.bounds, ctx.bounds[1:]):
                # The memory and the usage table are updated in place, so
                # they are copied; an LSH index is new each step
                # (`ann.ann_insert`), so the reference holds the segment
                # start's index.
                ctx.checkpoints.append(state._replace(
                    memory=state.memory.clone(),
                    last_access=state.last_access.clone()))
                for x in xs[lo:hi]:
                    state, y = cell.step(params, state, x)
                    ys.append(y)
            ys = torch.stack(ys)
        out, ctx.out_template = _split(state)
        ctx.cell, ctx.chunk, ctx.s_template = cell, chunk, s_template
        ctx.params, ctx.xs, ctx.ys_shape = params, xs, ys.shape
        ctx.mark_dirty(state.memory, state.last_access)
        # The caller's memory tensor, to flag once the backward rolls it
        # back (a saved output unpacks as another tensor object).
        ctx.memory_ref = weakref.ref(state.memory)
        ctx.mark_non_differentiable(*[t for t in out
                                      if not t.is_floating_point()])
        # Saved as outputs: backward raises if the memory changed since.
        ctx.save_for_backward(*out)
        ctx.set_materialize_grads(False)
        return (ys, *out)

    @staticmethod
    def backward(ctx, g_ys, *g_out):
        cell, xs = ctx.cell, ctx.xs
        outs = ctx.saved_tensors
        state = _join(outs, ctx.out_template)
        flat_p, p_spec = pytree.tree_flatten(ctx.params)
        params = pytree.tree_unflatten(
            [p.detach().requires_grad_() for p in flat_p], p_spec)
        g_params = [torch.zeros_like(p) for p in flat_p]
        grad_of = {id(t): g for t, g in zip(outs, g_out)}
        g_mem = grad_of[id(state.memory)]
        # The one dense memory cotangent of the whole backward.
        mem_ct = (torch.zeros_like(state.memory) if g_mem is None
                  else g_mem.clone())
        cts = [torch.zeros_like(t) if grad_of[id(t)] is None else grad_of[id(t)]
               for t in _small_floats(state)]
        if g_ys is None:
            g_ys = xs.new_zeros(ctx.ys_shape)
        g_xs = torch.zeros_like(xs)
        bounds = ctx.bounds
        for s in reversed(range(len(bounds) - 1)):
            lo, hi = bounds[s], bounds[s + 1]
            if ctx.chunk is None:
                res = ctx.res
            else:
                start = ctx.checkpoints[s]
                state.memory.copy_(start.memory)
                state.last_access.copy_(start.last_access)
                state, _, res = _collect(
                    cell, params, start._replace(
                        memory=state.memory, last_access=state.last_access),
                    xs[lo:hi])
            state, cts = _segment_bwd(cell, params, state, res, xs[lo:hi],
                                      cts, g_ys[lo:hi], mem_ct, g_params,
                                      g_xs[lo:hi])
        ctx.res = ctx.checkpoints = None
        memory = ctx.memory_ref()
        if memory is not None:
            mark_rolled_back(memory)
        g_s0, _ = _split(_with_small_floats(state._replace(memory=mem_ct),
                                            cts))
        return (None, None, None, None, g_xs, *g_params,
                *[g if g.is_floating_point() else None for g in g_s0])


def _rollback_unroll(cell, chunk, params, state0, xs):
    p_leaves, p_template = _split(params)
    s_leaves, s_template = _split(state0)
    ys, *out = _RollbackUnroll.apply(cell, chunk, p_template, s_template, xs,
                                     *p_leaves, *s_leaves)
    return _join(out, s_template), ys


def suggest_chunk(cell, params, state0, xs) -> int:
    """C* ≈ √(T · state_bytes / residual_bytes_per_step) — the minimizer of
    the chunked engine's residual footprint T/C·state + C·res."""
    T = xs.shape[0]
    sb = tree_bytes(state0)
    rb = cell.step_residual_bytes(state0)
    return max(1, min(int(round(math.sqrt(max(T, 1) * sb / max(rb, 1)))), T))


def unroll(cell, params, state0, xs, *, mode: str = "sparse", chunk=None):
    """Unroll a cell over xs (T, B, ...) -> (stateT, ys).

    mode:
      * "naive"   — plain loop under autograd, O(T·state) residuals;
      * "sparse"  — whole-sequence sparse rollback, O(T·K·W) residuals;
      * "chunked" — boundary checkpoints + per-segment recompute,
                    O(T/C·state + C·K·W) residuals. `chunk` is the segment
                    length C (None/"auto" → the √-rule `suggest_chunk`).

    The memory is updated in place. After the backward of a "sparse" or
    "chunked" unroll it holds ``state0``'s memory again while the usage
    table keeps step T's: the returned state (and ``state0``) can be read
    but not stepped from; `sam_step` raises (module docstring). A bf16 or
    int8 memory raises: those rows run forward only
    (`types.DTYPE_TRAINING_ITEM`).
    """
    require_f32_rows(state0.memory, getattr(state0, "mem_scale", None),
                     what=f"unroll(mode={mode!r})")
    if mode == "naive":
        return unroll_naive(cell, params, state0, xs)
    if mode == "sparse":
        return _rollback_unroll(cell, None, params, state0, xs)
    if mode != "chunked":
        raise ValueError(f"unknown unroll mode {mode!r}")
    T = xs.shape[0]
    C = (suggest_chunk(cell, params, state0, xs)
         if chunk in (None, "auto") else int(chunk))
    return _rollback_unroll(cell, max(1, min(C, T)), params, state0, xs)


def residual_accounting(cell, params, state0, xs, *, mode: str,
                        chunk=None) -> dict:
    """Analytic peak-residual bytes of one unroll mode, as the JAX engine
    counts them (`repro/core/unroll.py::residual_accounting`):

      * naive:   T · state
      * sparse:  state + T · res
      * chunked: ceil(T/C) · state + C · res

    The port's sparse mode keeps no copy of the final state (the memory is
    rolled back in place), and its backward adds one dense memory
    cotangent, which this count leaves out as the JAX one does."""
    T = xs.shape[0]
    sb = tree_bytes(state0)
    rb = cell.step_residual_bytes(state0)
    if mode == "naive":
        total, C = T * sb, None
    elif mode == "sparse":
        total, C = sb + T * rb, None
    elif mode == "chunked":
        C = (suggest_chunk(cell, params, state0, xs)
             if chunk in (None, "auto") else int(chunk))
        C = max(1, min(C, T))
        total = -(-T // C) * sb + C * rb
    else:
        raise ValueError(f"unknown unroll mode {mode!r}")
    return {"mode": mode, "T": T, "chunk": C, "state_bytes": sb,
            "res_step_bytes": rb, "residual_bytes": int(total)}
