"""The sparse-rollback BPTT engine (paper §3.4, Suppl. Fig. 5), the port of
`repro/core/unroll.py`, on one device or, inside
`mem_shard.memory_mesh`, on each rank's block of a slot-sharded SAM
memory: the cell's ops take their sharded counterparts, the dense buffers
and their cotangents are the rank's blocks, and the chunked mode's
checkpoints copy the block, never the whole memory.

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

A cell's dense buffers are updated **in place** (``cell.dense_buffers``:
SAM's memory and usage table, the SDNC's memory, usage table and N_t,
P_t): the returned state holds the tensors of ``state0``. The sparse and
chunked backwards leave them as they were before the unroll, bit for bit
(the usage table is left stale: the backward never reads it), and need
them to hold the unroll's final buffers when they start. After such a
backward, neither ``state0`` nor the returned state is a valid state any
more (the memory is M₀, the usage table that of step T): the backward
flags the memory (`types.mark_rolled_back`) and a later step from either
raises. Unrolls may be chained over one state (the LM threads one memory
through its memory groups): the next unroll updates the same buffers in
place, and as autograd runs the backwards in reverse order each finds the
buffers as its forward left them and leaves them as its forward found
them; a backward whose later unrolls have not run theirs raises. The
flag is set on the caller's tensor; a backward works on its own aliases
of the buffers. A chunked one copies a checkpoint's buffers back into
them before it recomputes a segment, but for the usage table
(``cell.stale_buffers``), which it recomputes on the checkpoint's own
copy, so that the live usage table stays step T's there too.

To go on stepping after such a backward (the streaming trainer carries the
state across chunks), `roll_forward` brings the final state back. Each
backward keeps a redo log: before it rolls step t back, it records the
rows that the rollback overwrites, which are the rows step t left
(`cell.redo_deltas`: the deltas with those rows in place of the old ones),
and it drops step t's residuals once it has them, so the log takes their
place and the backward's peak stays as it was. O(K·W) per step, like the
residuals; no O(N) buffer is copied. `roll_forward` 'sets' the logged
rows again in forward order through the cell's own `rollback` (one
`scatter_rows` 'set' a step on the card), the logs of chained unrolls in
forward order. The usage table is step T's and the small leaves of the
returned state were never changed, so the state is then the forward's
final state, bit for bit.
Gradients reach the parameters, xs and the float leaves of
``state0``: every small one (the float leaves outside the dense buffers)
is differentiated again at each replayed step, and each buffer of
``cell.cotangent_buffers`` has one dense cotangent, in the buffer's dtype,
that the whole backward updates in place (`core/cell.py`): a bf16
memory's is bf16, and an int8 memory's codes have none, its scales
(a dense buffer of the cell) one. The chunked mode's checkpoints copy
every dense buffer, the scales included. The backward launches no O(N)
kernel outside the chunked recompute.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.types import (mark_rolled_back, mark_rolled_forward,
                                    tree_bytes)
from repro_torch.distributed import mem_shard


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


def _get(state, path: str):
    """The leaf of ``state`` at a dotted field path ("n_mat.vals")."""
    for name in path.split("."):
        state = getattr(state, name)
    return state


def _put(state, path: str, value):
    """``state`` with the leaf at a dotted field path replaced."""
    head, _, rest = path.partition(".")
    return state._replace(**{head: _put(getattr(state, head), rest, value)
                             if rest else value})


def _put_all(state, paths, values):
    for path, value in zip(paths, values):
        state = _put(state, path, value)
    return state


def _buffers(cell, state) -> list:
    return [_get(state, p) for p in cell.dense_buffers]


def _bare(cell, state):
    """``state`` without its dense buffers (None in their place)."""
    return _put_all(state, cell.dense_buffers,
                    [None] * len(cell.dense_buffers))


def _small_floats(cell, state) -> list:
    """The float leaves of a state outside the cell's dense buffers, in
    order."""
    return [t for t in _split(_bare(cell, state))[0] if t.is_floating_point()]


def _with_small_floats(cell, state, floats):
    tensors, template = _split(_bare(cell, state))
    it = iter(floats)
    tensors = [next(it) if t.is_floating_point() else t for t in tensors]
    return _put_all(_join(tensors, template), cell.dense_buffers,
                    _buffers(cell, state))


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


def _segment_bwd(cell, params, state, res, xs, cts, ct_ys, buf_cts, g_params,
                 g_xs, log):
    """Roll one segment back, step by step from its end. ``params`` require
    grad; each step adds its gradients into the ``g_params`` leaves and
    writes ``g_xs[t]``, and updates the buffers' cotangents ``buf_cts`` in
    place. ``cts`` are the cotangents of the end state's small float
    leaves. Each step appends its redo record to ``log`` (the latest step
    first) and drops its residuals from ``res``. Returns (the segment's
    start state, the cotangents of its small float leaves)."""
    p_leaves = pytree.tree_leaves(params)
    for t in reversed(range(len(xs))):
        prev_small, deltas = res[t]
        res[t] = None
        log.append((prev_small, cell.redo_deltas(state, prev_small, deltas)))
        state = cell.rollback(state, prev_small, deltas)
        with torch.enable_grad():
            diff = [leaf.detach().requires_grad_()
                    for leaf in _small_floats(cell, state)]
            x = xs[t].detach().requires_grad_()
            ns, y = cell.replay_step(params,
                                     _with_small_floats(cell, state, diff),
                                     x, deltas, buf_cts)
            inputs = [*p_leaves, *diff, x]
            grads = torch.autograd.grad([*_small_floats(cell, ns), y], inputs,
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
    the final state's tensor leaves, of which the cell's dense buffers
    are the input tensors, updated in place."""

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
                # The dense buffers are updated in place, so they are
                # copied; an LSH index is new each step (`ann.ann_insert`),
                # so the reference holds the segment start's index.
                ctx.checkpoints.append(_put_all(
                    state, cell.dense_buffers,
                    [b.clone() for b in _buffers(cell, state)]))
                for x in xs[lo:hi]:
                    state, y = cell.step(params, state, x)
                    ys.append(y)
            ys = torch.stack(ys)
        out, ctx.out_template = _split(state)
        ctx.cell, ctx.chunk, ctx.s_template = cell, chunk, s_template
        # The slot-sharded memory's context, which the backward activates
        # (on the card autograd runs it on a thread of its own).
        ctx.mesh = mem_shard.current()
        ctx.params, ctx.xs, ctx.ys_shape = params, xs, ys.shape
        ctx.mark_dirty(*_buffers(cell, state))
        # The caller's memory tensor, to flag once the backward rolls it
        # back (an alias unpacks as another tensor object), and this
        # unroll's place among those over it whose backward is pending.
        ctx.memory_ref = weakref.ref(state.memory)
        ctx.token = object()
        state.memory.__dict__.setdefault("pending_unrolls", []).append(
            ctx.token)
        ctx.mark_non_differentiable(*[t for t in out
                                      if not t.is_floating_point()])
        # Kept as detached aliases, not saved: a later unroll over the same
        # buffers (the next memory group of an LM) changes them in place,
        # which autograd would refuse in a saved tensor. Its backward must
        # run first, to leave them as this forward left them.
        ctx.outs = [t.detach() for t in out]
        ctx.set_materialize_grads(False)
        return (ys, *out)

    @staticmethod
    def backward(ctx, g_ys, *g_out):
        with mem_shard.activated(ctx.mesh):
            return _RollbackUnroll._backward(ctx, g_ys, *g_out)

    @staticmethod
    def _backward(ctx, g_ys, *g_out):
        cell, xs = ctx.cell, ctx.xs
        memory = ctx.memory_ref()
        pending = getattr(memory, "pending_unrolls", [ctx.token])
        if not pending or pending[-1] is not ctx.token:
            raise RuntimeError(
                "a later unroll changed this unroll's memory in place and "
                "its backward has not run: the buffers do not hold this "
                "unroll's final state")
        pending.pop()
        outs = ctx.outs
        state = _join(outs, ctx.out_template)
        flat_p, p_spec = pytree.tree_flatten(ctx.params)
        params = pytree.tree_unflatten(
            [p.detach().requires_grad_() for p in flat_p], p_spec)
        g_params = [torch.zeros_like(p) for p in flat_p]
        # The incoming cotangents by place among the state's tensor leaves
        # (not by tensor: a state may hold one tensor twice, as the SDNC's
        # read.words and read_words), zeros where none came.
        place = _join(range(len(outs)), ctx.out_template)
        bufs = {_get(place, p): p for p in cell.dense_buffers}

        # The one dense cotangent of each such buffer, for the whole
        # backward, and those of the small floats (`_small_floats` order).
        buf_cts = tuple(
            torch.zeros_like(outs[i]) if g_out[i] is None else g_out[i].clone()
            for i in (_get(place, p) for p in cell.cotangent_buffers))
        cts = [torch.zeros_like(t) if g_out[i] is None else g_out[i]
               for i, t in enumerate(outs)
               if t.is_floating_point() and i not in bufs]
        if g_ys is None:
            g_ys = xs.new_zeros(ctx.ys_shape)
        g_xs = torch.zeros_like(xs)
        bounds = ctx.bounds
        live = _buffers(cell, state)
        log = []
        for s in reversed(range(len(bounds) - 1)):
            lo, hi = bounds[s], bounds[s + 1]
            if ctx.chunk is None:
                res = ctx.res
            else:
                # The live buffers get the checkpoint's contents back, but
                # for the usage table, recomputed on the checkpoint's copy:
                # the live one keeps step T's.
                start, ctx.checkpoints[s] = ctx.checkpoints[s], None
                bufs = [b0 if p in cell.stale_buffers else b.copy_(b0)
                        for p, b, b0 in zip(cell.dense_buffers, live,
                                            _buffers(cell, start))]
                state, _, res = _collect(
                    cell, params, _put_all(start, cell.dense_buffers, bufs),
                    xs[lo:hi])
            state, cts = _segment_bwd(cell, params, state, res, xs[lo:hi],
                                      cts, g_ys[lo:hi], buf_cts, g_params,
                                      g_xs[lo:hi], log)
        ctx.res = ctx.checkpoints = ctx.outs = None
        if memory is not None:
            mark_rolled_back(memory)
            # The backwards of chained unrolls run latest first: each log
            # goes in front, so the list is in forward order.
            memory.__dict__.setdefault("redo_logs", []).insert(
                0, (cell, log[::-1]))
        # The gradient of state0: the small floats' and the cotangent
        # buffers', None for the other (integer) buffers.
        grads = _put_all(_with_small_floats(cell, state, cts),
                         cell.cotangent_buffers, buf_cts)
        g_s0, _ = _split(grads)
        return (None, None, None, None, g_xs, *g_params,
                *[g if g.is_floating_point() else None for g in g_s0])


def roll_forward(state):
    """Bring back the final state of the sparse or chunked unrolls whose
    backwards rolled ``state``'s buffers back (module docstring): 'set' the
    rows each backward logged, in forward order, in place, and clear the
    memory's rolled-back flag. ``state`` is a state an unroll returned (or
    any state holding its buffers); it is returned, live again. A state
    that no backward rolled back is returned as it is. Raises while an
    unroll over these buffers still waits for its backward: the buffers
    then hold that unroll's final state, not a rolled-back one."""
    memory = getattr(state, "memory", None)
    if not isinstance(memory, torch.Tensor):
        return state
    if memory.__dict__.get("pending_unrolls"):
        raise RuntimeError("roll_forward: an unroll over this memory has "
                           "not run its backward yet")
    with torch.no_grad():
        for cell, log in memory.__dict__.pop("redo_logs", []):
            for prev_small, redo in log:
                cell.rollback(state, prev_small, redo)
    mark_rolled_forward(memory)
    return state


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

    The cell's dense buffers are updated in place. After the backward of a
    "sparse" or "chunked" unroll they hold ``state0``'s again while the
    usage table keeps step T's: the returned state (and ``state0``) can
    be read but not stepped from (the cell's step raises) until
    `roll_forward` brings the final state back (module docstring). The
    memory may hold f32, bf16 or int8 rows: its cotangent is then f32,
    bf16, or (int8) that of its scales, the codes carrying none
    (`cell.cotangent_buffers`).
    """
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

    The port's sparse mode keeps no copy of the final state (the buffers
    are rolled back in place), and its backward adds one dense cotangent
    per `cotangent_buffers` entry, which this count leaves out as the JAX
    one does."""
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
