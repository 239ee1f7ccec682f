"""Training with the PyTorch port on the CPU, against the JAX package.

B = 2, N = 128, W = 8, H = 2, K = 4, hidden 16, T = 7 (a T % C tail for
C = 3). The same numpy inputs go to both sides; weights, state and optimizer
state come from the JAX side through `repro_torch.convert`. The JAX side
runs under the ``ref`` and the ``pallas-interpret`` backends.

* The three closed-form gradients of `repro_torch.kernels.ops` (the fused
  read, the row scatter, the fused write) against `jax.vjp` of the matching
  `repro.kernels.ops` op.
* The port's naive, sparse and chunked unrolls (C = 1, 3, T and "auto")
  against `jax.grad` of the JAX `unroll` in naive and in sparse mode, for a
  loss that reads the outputs, the final memory and the final controller
  state; gradients reach the parameters, xs, the initial memory and the
  initial small state. The rollback leaves the memory as it found it. The
  same for the LSH cell (kind ``sam_ann``: 2 tables of 3 bits, buckets of
  8, the index built from the initial memory), whose fixed planes get a
  zero gradient.
* `residual_accounting` against JAX's.
* Three `make_task_train_step` steps from the same weights, optimizer state
  and batches, for ``sam`` and ``sam_ann`` (planes unchanged bit for bit);
  `rmsprop_update` and `clip_by_global_norm`.

Tolerances. Forward floats (outputs, losses) within 1e-5. Gradients within
GRAD_ATOL = GRAD_RTOL = 1e-5 — tighter than the JAX suite's own bar between
its sparse and naive modes, atol 2e-4 / rtol 1e-3 (`tests/test_unroll.py`).
Parameters after RMSProp steps within 1e-5.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import addressing as jaddr
from repro.core import ann as jann
from repro.core import unroll as junroll
from repro.core.cell import SAMCell as JaxSAMCell
from repro.core.sam import SAMConfig as JaxSAMConfig
from repro.core.training import ModelSpec as JaxModelSpec
from repro.core.training import make_task_train_step as jax_train_step
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import LSTMState as JaxLSTMState
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.data.curriculum import Curriculum as JaxCurriculum
from repro.kernels import ops as jops
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.core import addressing as addr
from repro_torch.core import training, unroll
from repro_torch.core.cell import SAMCell
from repro_torch.core.sam import SAM, SAMConfig
from repro_torch.core.types import (ControllerConfig, LSTMState,
                                    MemoryConfig)
from repro_torch.data.curriculum import Curriculum
from repro_torch.data.tasks import copy_task
from repro_torch.kernels import ops
from repro_torch.optim import optimizers as opt

TOL = 1e-5
GRAD_ATOL = GRAD_RTOL = 1e-5
B, N, W, H, K, HIDDEN, BITS, T = 2, 128, 8, 2, 4, 16, 4, 7
J = H * (K + 1)
BACKENDS = ["ref", "pallas-interpret"]


def _close(a, b, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


# The LSH index of the ``sam_ann`` cases: small, so buckets fill and wrap.
LSH = dict(lsh_tables=2, lsh_bits=3, lsh_bucket_size=8)


def _jax_cfg(backend, ann="exact"):
    return JaxSAMConfig(
        JaxMemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K,
                        backend=backend, ann=ann, **LSH),
        JaxControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                            output_size=BITS))


def _port_cfg(ann="exact"):
    return SAMConfig(MemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K,
                                  ann=ann, **LSH),
                     ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                                      output_size=BITS))


CFG = _port_cfg()


# --------------------------------------------------------------------------
# The autograd Functions against the JAX custom VJPs
# --------------------------------------------------------------------------

def _op_inputs(seed=0):
    rng = np.random.default_rng(seed)
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    la = rng.integers(-50, 50, (B, N + 1)).astype(np.int32)
    widx = rng.integers(0, N, (B, H, K + 1)).astype(np.int32)
    widx[:, 1, 0] = widx[:, 0, 2]           # a row duplicated across heads
    widx[:, 1, 2] = widx[:, 0, 2]           # ... three times
    widx[:, 1, K] = widx[:, 0, 1]           # an LRA row that was also read
    return dict(
        mem=mem, la=la, widx=widx.reshape(B, J), lra=widx[:, :, K].copy(),
        ww=rng.random((B, J)).astype(np.float32),
        a=rng.standard_normal((B, H, W)).astype(np.float32),
        rows=rng.standard_normal((B, J, W)).astype(np.float32),
        q=rng.standard_normal((B, H, W)).astype(np.float32),
        beta=(1.0 + rng.random((B, H))).astype(np.float32),
        g_mem=rng.standard_normal((B, N + 1, W)).astype(np.float32),
        g_read=rng.standard_normal((B, H, W)).astype(np.float32),
        g_w=rng.standard_normal((B, H, K)).astype(np.float32))


def _torch_vjp(fn, primals, cts):
    leaves = [torch.tensor(p, requires_grad=True) for p in primals]
    outs = fn(*[x.clone() for x in leaves])     # in-place ops take non-leaves
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves,
                               [torch.tensor(c) for c in cts])


def _jax_vjp(fn, primals, cts):
    _, vjp = jax.vjp(fn, *[jnp.asarray(p) for p in primals])
    return vjp(tuple(jnp.asarray(c) for c in cts) if len(cts) > 1
               else jnp.asarray(cts[0]))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["fused_read", "scatter_add", "scatter_set",
                                "sparse_write"])
def test_autograd_function_matches_jax_vjp(op, backend):
    d = _op_inputs()
    step = np.int32(9)
    if op == "fused_read":
        primals, cts = (d["q"], d["mem"], d["beta"]), (d["g_read"], d["g_w"])
        got = _torch_vjp(lambda q, m, b: ops.fused_read(q, m, b, K,
                                                        valid_n=N)[:2],
                         primals, cts)
        want = _jax_vjp(lambda q, m, b: jops.fused_read(
            q, m, b, K, backend=backend, block_n=32, valid_n=N)[:2],
            primals, cts)
    elif op.startswith("scatter"):
        mode = op.split("_")[1]
        idx = d["widx"]
        primals, cts = (d["mem"], d["rows"]), (d["g_mem"],)
        got = _torch_vjp(lambda m, r: ops.scatter_rows(
            m, torch.tensor(idx), r, mode), primals, cts)
        want = _jax_vjp(lambda m, r: jops.scatter_rows(
            m, jnp.asarray(idx), r, mode, backend=backend,
            scratch_row=N if mode == "add" else None), primals, cts)
    else:
        primals, cts = (d["mem"], d["ww"], d["a"]), (d["g_mem"],)
        got = _torch_vjp(lambda m, w, a: ops.sparse_write_update(
            m, torch.tensor(d["la"]), torch.tensor(d["widx"]), w, a,
            torch.tensor(d["lra"]), torch.tensor(step), delta=0.005)[0],
            primals, cts)
        want = _jax_vjp(lambda m, w, a: jops.sparse_write_update(
            m, jnp.asarray(d["la"]), jnp.asarray(d["widx"]), w, a,
            jnp.asarray(d["lra"]), step, delta=0.005, backend=backend,
            scratch_row=N)[0], primals, cts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, GRAD_ATOL, GRAD_RTOL)


def test_finish_candidate_read_matches_jax_with_signed_indices():
    """The read tail from recorded signed indices: -1 gets weight exactly 0,
    a head with no valid entry reads a zero word; forward and gradients
    (q, memory, beta) against JAX's `finish_candidate_read`."""
    d = _op_inputs(seed=3)
    idx = np.random.default_rng(3).integers(0, N, (B, H, K)).astype(np.int32)
    idx[0, 0, 1] = -1
    idx[1, 1, :] = -1
    primals, cts = (d["q"], d["mem"], d["beta"]), (d["g_w"], d["g_read"])

    def port(q, m, b):
        read = addr.finish_candidate_read(q, m, b, torch.tensor(idx))
        return read.weights, read.words

    def jax_side(q, m, b):
        read = jaddr.finish_candidate_read(q, m, b, jnp.asarray(idx))
        return read.weights, read.words

    fwd = port(*(torch.tensor(p) for p in primals))
    j_fwd = jax_side(*(jnp.asarray(p) for p in primals))
    for a, b in zip(fwd, j_fwd):
        _close(a, b)
    assert fwd[0][0, 0, 1] == 0 and (fwd[1][1, 1] == 0).all()
    for g, w in zip(_torch_vjp(port, primals, cts),
                    _jax_vjp(jax_side, primals, cts)):
        _close(g, w, GRAD_ATOL, GRAD_RTOL)


# --------------------------------------------------------------------------
# Unroll gradients: the port's three modes against JAX's naive and sparse
# --------------------------------------------------------------------------

def _unroll_inputs(seed=0, ann="exact"):
    """Weights from the JAX init; a random initial memory (scratch row
    zero), controller state and read weights (the all-zero initial read
    indices then make every step-1 write hit row 0 K times per head); xs
    and the loss weights from numpy. An LSH cell's index is JAX's
    `ann_build` of the initial memory."""
    rng = np.random.default_rng(seed)
    jcell = JaxSAMCell(_jax_cfg("ref", ann))
    jparams = _numpy(jcell.init_params(jax.random.PRNGKey(seed)))
    jstate = _numpy(jcell.init_state(B))
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    mem[:, N] = 0.0
    if ann == "lsh":
        jstate = jstate._replace(ann=_numpy(jann.ann_build(
            jnp.asarray(jparams["lsh_planes"]), jnp.asarray(mem),
            jcell.cfg.memory, partitions=1)))
    floats = dict(
        memory=mem,
        h=0.5 * rng.standard_normal((B, HIDDEN)).astype(np.float32),
        c=0.5 * rng.standard_normal((B, HIDDEN)).astype(np.float32),
        words=rng.standard_normal((B, H, W)).astype(np.float32),
        weights=rng.dirichlet(np.ones(K), (B, H)).astype(np.float32))
    xs = rng.integers(0, 2, (T, B, BITS + 2)).astype(np.float32)
    r_mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    r_h = rng.standard_normal((B, HIDDEN)).astype(np.float32)
    return jparams, jstate, floats, xs, (r_mem, r_h)


FLOAT_NAMES = ("memory", "h", "c", "words", "weights")


def _jax_state(jstate, f):
    return jstate._replace(
        memory=f["memory"], ctrl=JaxLSTMState(h=f["h"], c=f["c"]),
        read=jstate.read._replace(words=f["words"], weights=f["weights"]))


@functools.lru_cache(maxsize=None)
def _jax_unroll_grads(backend, mode, ann="exact"):
    """(loss, ys, grads as numpy: params tree, the FLOAT_NAMES, xs)."""
    jparams, jstate, floats, xs, (r_mem, r_h) = _unroll_inputs(ann=ann)
    cell = JaxSAMCell(_jax_cfg(backend, ann))

    def loss(p, f, x):
        final, ys = junroll.unroll(cell, p, _jax_state(jstate, f), x,
                                   mode=mode)
        return ((ys ** 2).sum() + (final.memory * r_mem).sum()
                + (final.ctrl.h * r_h).sum()), ys

    (val, ys), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jparams, floats, xs)
    return float(val), np.asarray(ys), _numpy(grads)


def _port_unroll_grads(mode, chunk, ann="exact"):
    jparams, jstate, floats, xs, (r_mem, r_h) = _unroll_inputs(ann=ann)
    params = convert.params_from_jax(jparams, device="cpu")
    p_leaves, p_spec = pytree.tree_flatten(params)
    p_leaves = [p.requires_grad_() for p in p_leaves]
    params = pytree.tree_unflatten(p_leaves, p_spec)
    f = {k: torch.tensor(v, requires_grad=True) for k, v in floats.items()}
    x = torch.tensor(xs, requires_grad=True)
    s0 = convert.state_from_jax(jstate, device="cpu")
    # The unroll writes the memory in place, so it takes a copy of the leaf.
    state0 = s0._replace(
        memory=f["memory"].clone(), ctrl=LSTMState(h=f["h"], c=f["c"]),
        read=s0.read._replace(words=f["words"], weights=f["weights"]))
    final, ys = unroll.unroll(SAMCell(_port_cfg(ann)), params, state0, x,
                              mode=mode, chunk=chunk)
    loss = ((ys ** 2).sum() + (final.memory * torch.tensor(r_mem)).sum()
            + (final.ctrl.h * torch.tensor(r_h)).sum())
    # The naive unroll never reaches the planes: their gradient is None.
    inputs = [*p_leaves, *(f[k] for k in FLOAT_NAMES), x]
    grads = [torch.zeros_like(i) if g is None else g for i, g in zip(
        inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]
    g_params = pytree.tree_unflatten(list(grads[:len(p_leaves)]), p_spec)
    g_floats = dict(zip(FLOAT_NAMES, grads[len(p_leaves):-1]))
    return (loss.item(), ys.detach(), g_params, g_floats, grads[-1],
            state0.memory.detach(), floats["memory"])


def _check_unroll_grads(mode, chunk, backend, ann="exact"):
    loss, ys, g_params, g_floats, g_xs, mem_after, mem0 = \
        _port_unroll_grads(mode, chunk, ann)
    if mode != "naive":
        # The rollback restored the initial memory bit for bit.
        np.testing.assert_array_equal(mem_after.numpy(), mem0)
    for j_mode in ("naive", "sparse"):
        j_loss, j_ys, (jg_params, jg_floats, jg_xs) = \
            _jax_unroll_grads(backend, j_mode, ann)
        _close(ys, j_ys)
        np.testing.assert_allclose(loss, j_loss, rtol=TOL)
        assert g_params.keys() == jg_params.keys()
        for group, leaves in jg_params.items():
            if group == "lsh_planes":         # fixed: zero on both sides
                assert (leaves == 0).all()
                assert (g_params[group] == 0).all()
                continue
            for name, want in leaves.items():
                _close(g_params[group][name], want, GRAD_ATOL, GRAD_RTOL)
        _close(g_floats["memory"], jg_floats["memory"], GRAD_ATOL, GRAD_RTOL)
        for name in FLOAT_NAMES[1:]:
            _close(g_floats[name], jg_floats[name], GRAD_ATOL, GRAD_RTOL)
        _close(g_xs, jg_xs, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode,chunk", [
    ("naive", None), ("sparse", None), ("chunked", 1), ("chunked", 3),
    ("chunked", T), ("chunked", "auto")],
    ids=["naive", "sparse", "chunked1", "chunked3", "chunkedT", "auto"])
def test_unroll_grads_match_jax(mode, chunk, backend):
    _check_unroll_grads(mode, chunk, backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode,chunk", [
    ("naive", None), ("sparse", None), ("chunked", 1), ("chunked", 3),
    ("chunked", T)],
    ids=["naive", "sparse", "chunked1", "chunked3", "chunkedT"])
def test_sam_ann_unroll_grads_match_jax(mode, chunk, backend):
    """The LSH cell: the chunked recompute must start each segment from
    the index as it was at the segment's start, or it selects other
    candidates and its gradients differ."""
    _check_unroll_grads(mode, chunk, backend, ann="lsh")


def test_sparse_backward_launches_no_selection():
    """The sparse backward needs neither the usage table nor a sweep: it
    calls no read or LRA selection, and the chunked one recomputes each
    segment's forward once."""
    calls = {"read": 0, "lra": 0}
    read0, lra0 = ops.fused_read, ops.lra_topn

    def read(*a, **kw):
        calls["read"] += 1
        return read0(*a, **kw)

    def lra(*a, **kw):
        calls["lra"] += 1
        return lra0(*a, **kw)

    ops.fused_read, ops.lra_topn = read, lra
    try:
        for mode, chunk, extra in (("sparse", None, 0), ("chunked", 3, T)):
            params = SAMCell(CFG).init_params(torch.Generator().manual_seed(0),
                                              device="cpu")
            for p in pytree.tree_leaves(params):
                p.requires_grad_()
            xs = torch.ones((T, B, BITS + 2))
            _, ys = unroll.unroll(SAMCell(CFG), params,
                                  SAMCell(CFG).init_state(B, device="cpu"),
                                  xs, mode=mode, chunk=chunk)
            calls.update(read=0, lra=0)
            ys.sum().backward()
            assert calls == {"read": extra, "lra": extra}
    finally:
        ops.fused_read, ops.lra_topn = read0, lra0


def test_rollback_restores_the_memory_bit_for_bit():
    cell = SAMCell(CFG)
    params = cell.init_params(torch.Generator().manual_seed(1), device="cpu")
    state = cell.init_state(B, device="cpu")
    xs = torch.tensor(np.random.default_rng(1).integers(0, 2, (T, B, BITS + 2)),
                      dtype=torch.float32)
    for x in xs[:3]:                         # a memory that is not all zero
        state, _ = cell.step(params, state, x)
    m0 = state.memory.clone()
    res = []
    for x in xs[3:]:
        prev = cell.residual_state(state)
        state, _, deltas = cell.step(params, state, x, collect_deltas=True)
        res.append((prev, deltas))
    assert not torch.equal(state.memory, m0)
    for prev, deltas in reversed(res):
        state = cell.rollback(state, prev, deltas)
    assert torch.equal(state.memory, m0)
    assert int(state.step) == 3


@pytest.mark.parametrize("mode,chunk", [("sparse", None), ("chunked", 3)])
def test_stepping_from_a_rolled_back_state_is_refused(mode, chunk):
    """After the backward, the memory is M0 again and the usage table is
    step T's: the returned state and state0 can be read but a step (or a
    new unroll) from either raises. Before the backward the final state
    carries on as in JAX; a fresh state steps as usual afterwards."""
    cell = SAMCell(CFG)
    params = cell.init_params(torch.Generator().manual_seed(2), device="cpu")
    for p in pytree.tree_leaves(params):
        p.requires_grad_()
    xs = torch.tensor(np.random.default_rng(2).integers(0, 2, (T, B, BITS + 2)),
                      dtype=torch.float32)
    state0 = cell.init_state(B, device="cpu")
    final, ys = unroll.unroll(cell, params, state0, xs, mode=mode, chunk=chunk)
    with torch.no_grad():
        cell.step(params, final._replace(memory=final.memory.clone(),
                                         last_access=final.last_access.clone()),
                  xs[0])
    ys.sum().backward()
    assert torch.equal(final.memory, torch.zeros_like(final.memory))
    for s in (final, state0):
        with pytest.raises(RuntimeError, match="rolled back"):
            cell.step(params, s, xs[0])
        with pytest.raises(RuntimeError, match="rolled back"):
            unroll.unroll(cell, params, s, xs, mode=mode, chunk=chunk)
    fresh = cell.init_state(B, device="cpu")
    _, ys2 = unroll.unroll(cell, params, fresh, xs, mode=mode, chunk=chunk)
    torch.testing.assert_close(ys2, ys, rtol=0, atol=0)


@pytest.mark.parametrize("mode,chunk", [("naive", None), ("sparse", None),
                                        ("chunked", 3), ("chunked", "auto")])
def test_residual_accounting_matches_jax(mode, chunk):
    jparams, jstate, _, xs, _ = _unroll_inputs()
    want = junroll.residual_accounting(JaxSAMCell(_jax_cfg("ref")), jparams,
                                       jstate, jnp.asarray(xs), mode=mode,
                                       chunk=chunk)
    got = unroll.residual_accounting(
        SAMCell(CFG), convert.params_from_jax(jparams, device="cpu"),
        convert.state_from_jax(jstate, device="cpu"), torch.tensor(xs),
        mode=mode, chunk=chunk)
    assert got == want
    assert unroll.suggest_chunk(
        SAMCell(CFG), None, convert.state_from_jax(jstate, device="cpu"),
        torch.tensor(xs)) == junroll.suggest_chunk(
            JaxSAMCell(_jax_cfg("ref")), jparams, jstate, jnp.asarray(xs))


# --------------------------------------------------------------------------
# Training steps and the optimizer
# --------------------------------------------------------------------------

def _acc_like(jparams, rng):
    return jax.tree.map(
        lambda p: (0.01 + rng.random(p.shape)).astype(np.float32) * 1e-3,
        jparams)


def _three_train_steps(kind, backend, bptt_chunk):
    """Three steps of the port and of JAX from the same weights, optimizer
    state and batches: losses, bit errors, weights and accumulators. An
    LSH cell's planes must come out bit for bit as they went in."""
    rng = np.random.default_rng(7)
    lr, max_len = 1e-3, 3
    ann = "lsh" if kind == "sam_ann" else "exact"
    jcfg = _jax_cfg(backend, ann)
    j_init, _, j_step = jax_train_step(
        JaxModelSpec(kind, jcfg.memory, jcfg.controller,
                     bptt_chunk=bptt_chunk), lr)
    cfg = _port_cfg()                  # build_model sets ann from the kind
    spec = training.ModelSpec(kind, cfg.memory, cfg.controller,
                              bptt_chunk=bptt_chunk)
    _, _, step = training.make_task_train_step(spec, lr, device="cpu")
    jparams = _numpy(j_init(jax.random.PRNGKey(3)))
    j_opt = jopt.RMSPropState(acc=_acc_like(jparams, rng))
    params = convert.params_from_jax(jparams, device="cpu")
    opt_state = convert.opt_state_from_jax(j_opt, device="cpu")
    planes0 = params.get("lsh_planes")
    j_step = jax.jit(j_step)
    for length in (3, 1, 2):
        seq = rng.integers(0, 2, (B, max_len, BITS))
        batch = copy_task(B, length, max_len, BITS, seq=seq, device="cpu")
        jparams, j_opt, j_loss, j_err = j_step(
            jparams, j_opt, *(jnp.asarray(t.numpy()) for t in batch))
        params, opt_state, loss, err = step(params, opt_state, *batch)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
        assert err.item() == float(j_err)
        for got, want in ((params, jparams), (opt_state.acc, j_opt.acc)):
            assert got.keys() == want.keys()
            for group, leaves in _numpy(want).items():
                if group == "lsh_planes":
                    _close(got[group], leaves)
                    continue
                for name, leaf in leaves.items():
                    _close(got[group][name], leaf)
    if kind == "sam_ann":
        assert torch.equal(params["lsh_planes"], planes0)
        np.testing.assert_array_equal(jparams["lsh_planes"], planes0.numpy())


@pytest.mark.parametrize("backend,bptt_chunk", [
    ("ref", None), ("pallas-interpret", None), ("ref", 3)],
    ids=["ref-sparse", "pallas-interpret-sparse", "ref-chunked3"])
def test_three_train_steps_match_jax(backend, bptt_chunk):
    _three_train_steps("sam", backend, bptt_chunk)


@pytest.mark.parametrize("backend,bptt_chunk", [
    ("ref", None), ("pallas-interpret", None), ("ref", 3)],
    ids=["ref-sparse", "pallas-interpret-sparse", "ref-chunked3"])
def test_three_sam_ann_train_steps_match_jax(backend, bptt_chunk):
    _three_train_steps("sam_ann", backend, bptt_chunk)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_rmsprop_and_clip_match_jax(max_norm):
    rng = np.random.default_rng(11)
    tree = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
            "b": rng.standard_normal((4,)).astype(np.float32)}
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                         .astype(np.float32), tree)
    acc = jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32), tree)
    t = lambda tr: pytree.tree_map(torch.tensor, tr)        # noqa: E731
    g, norm = opt.clip_by_global_norm(t(grads), max_norm)
    j_g, j_norm = jopt.clip_by_global_norm(grads, max_norm)
    _close(norm, j_norm)
    jax.tree.map(lambda x, y: _close(x, y), pytree.tree_map(np.asarray, g),
                 _numpy(j_g))
    p, s = opt.rmsprop_update(t(tree), g, opt.RMSPropState(acc=t(acc)),
                              lr=1e-2)
    j_p, j_s = jopt.rmsprop_update(tree, j_g, jopt.RMSPropState(acc=acc),
                                   lr=1e-2)
    jax.tree.map(lambda x, y: _close(x, y), pytree.tree_map(np.asarray, p),
                 _numpy(j_p))
    jax.tree.map(lambda x, y: _close(x, y),
                 pytree.tree_map(np.asarray, s.acc), _numpy(j_s.acc))
    # torch.optim.RMSprop puts eps outside the square root; here it is
    # inside, which a tiny gradient on a zero accumulator tells apart
    # (outside would give -3.16).
    tiny = opt.rmsprop_update({"w": torch.zeros(2)},
                              {"w": torch.full((2,), 1e-6)},
                              opt.rmsprop_init({"w": torch.zeros(2)}),
                              lr=1.0)[0]["w"]
    _close(tiny, np.full(2, -1e-6 / np.sqrt(1e-13 + 1e-10), np.float32))


def test_curriculum_copy_matches_jax():
    ours, theirs = Curriculum(patience=3), JaxCurriculum(patience=3)
    rng, j_rng = np.random.default_rng(5), np.random.default_rng(5)
    for loss in [0.5, 0.01, 0.02, 0.03, 0.2, 0.01, 0.01, 0.01, 0.0]:
        assert ours.update(loss) == theirs.update(loss)
        assert ours.sample_level(rng) == theirs.sample_level(j_rng)
    assert ours.level == theirs.level == 8
    assert ours.history == theirs.history


def test_build_model_sends_sam_to_the_rollback_engine_and_refuses_others():
    mem, ctl = CFG.memory, CFG.controller
    with pytest.raises(ValueError, match="unknown model kind"):
        training.build_model(training.ModelSpec("gru", mem, ctl))
    for kind in ("dam", "ntm", "dnc", "lstm"):      # plain loops, no engine
        assert not isinstance(training.build_model(
            training.ModelSpec(kind, mem, ctl), device="cpu")[2],
            functools.partial)
    for kind in ("sam", "sam_ann", "sdnc"):
        modes = [training.build_model(training.ModelSpec(kind, mem, ctl, **kw),
                                      device="cpu")[2].keywords
                 for kw in ({}, {"bptt_chunk": 4}, {"sparse_bptt": False})]
        assert modes == [{"mode": "sparse", "chunk": None},
                         {"mode": "chunked", "chunk": 4},
                         {"mode": "naive", "chunk": None}]
    # sam_ann is the SAM cell with the LSH read, whatever ``ann`` says.
    init_p, init_s, unroll_fn = training.build_model(
        training.ModelSpec("sam_ann", mem, ctl), device="cpu")
    assert unroll_fn.args[0].cfg.memory.ann == "lsh"
    assert "lsh_planes" in init_p(torch.Generator().manual_seed(0))
    assert init_s(B).ann is not None


def test_train_task_is_seeded_and_learns_nothing_wild():
    spec = training.ModelSpec("sam", CFG.memory, CFG.controller)
    runs = [training.train_task(spec, "copy", steps=3, batch=B, level=2,
                                max_level=2, bits=BITS, lr=1e-3, seed=4,
                                curriculum=Curriculum(), device="cpu")
            for _ in range(2)]
    (p1, h1), (p2, h2) = runs
    assert h1 == h2
    for a, b in zip(pytree.tree_leaves(p1), pytree.tree_leaves(p2)):
        assert torch.equal(a, b)
    assert all(np.isfinite(r["loss"]) and r["level"] <= 2 for r in h1)


def test_module_weights_train_and_its_forward_records_no_graph():
    model = SAM(CFG, seed=2, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    _, ys = model(model.init_state(B), torch.ones((3, B, BITS + 2)))
    assert not ys.requires_grad
    _, ys = unroll.unroll(SAMCell(CFG), model.params(),
                          model.init_state(B), torch.ones((3, B, BITS + 2)))
    ys.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
