"""The DNC and the sparse DNC (`repro_torch.core.dnc`, `core/cell.py::
SDNCCell`) and the associative-recall and priority-sort tasks on the CPU,
against the JAX package.

Sizes of `tests/test_unroll.py`: N = 32, W = 16, R = 2, K = 4, K_L = 4,
hidden 32, B = 2, T = 8 (input and output 8); the LSH SDNC with 2 tables
of 3 bits and buckets of 8. The same numpy inputs go to both sides;
weights and state come from JAX through `repro_torch.convert`. The JAX
side runs under the ``ref`` and the ``pallas-interpret`` backends.

* The helpers (`_merge_rows`, `_sparse_vec_lookup`, `_link_read` and the
  last-wins row set) on random rows and on rows full of ties and
  duplicates, forward and gradients.
* 8-step rollouts, every state leaf compared at every step: the SDNC,
  exact and LSH, from the zero state; the dense DNC from the zero state
  step by step (each step from JAX's state: the allocation sorts rows of
  equal usage, and an ulp of drift reorders them) and from a random state
  with distinct usages (the sort's margin asserted), whole.
* Gradients of the port's naive, sparse and chunked (C = 1, 4, 8, auto)
  SDNC unrolls against `jax.grad` of JAX's naive `dnc_unroll`, for the
  parameters, xs and the initial memory, N_t and P_t values, precedence
  and read weights (a random initial state, so the link cotangents flow);
  the dense DNC's naive gradients.
* The rollback (memory, N_t and P_t back bit for bit, stepping refused),
  the backward's launches, `residual_accounting`, three
  `make_task_train_step` steps of ``sdnc`` on ``associative_recall``
  (T = 64, C = 16) and of ``dnc``, the tasks' layouts and the refusals.

Tolerances: integers exact; forward floats within 1e-5; gradients within
atol 1e-5 / rtol 1e-5 (`tests/test_torch_train.py`).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import ann as jann
from repro.core import dnc as jdnc
from repro.core import unroll as junroll
from repro.core.cell import SDNCCell as JaxSDNCCell
from repro.core.training import ModelSpec as JaxModelSpec
from repro.core.training import make_task_train_step as jax_train_step
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.data import tasks as jtasks
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.core import dnc, training, unroll
from repro_torch.core.cell import SDNCCell
from repro_torch.core.types import ControllerConfig, MemoryConfig
from repro_torch.data import tasks
from repro_torch.distributed import mem_shard
from repro_torch.kernels import ops

TOL = 1e-5
GRAD_ATOL = GRAD_RTOL = 1e-5
B, N, W, R, K, KL, HIDDEN, D, T = 2, 32, 16, 2, 4, 4, 32, 8, 8
J = R * K + 1
BACKENDS = ["ref", "pallas-interpret"]
LSH = dict(lsh_tables=2, lsh_bits=3, lsh_bucket_size=8)


def _close(a, b, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(backend="ref", sparse=True, ann="exact", **mem):
    kw = dict(num_slots=N, word_size=W, num_heads=R, k=K, **mem)
    return jdnc.DNCConfig(
        JaxMemoryConfig(backend=backend, ann=ann,
                        **(LSH if ann == "lsh" else {}), **kw),
        JaxControllerConfig(input_size=D, hidden_size=HIDDEN, output_size=D),
        k_l=KL, sparse=sparse)


def _port_cfg(sparse=True, ann="exact", **mem):
    kw = dict(num_slots=N, word_size=W, num_heads=R, k=K, **mem)
    return dnc.DNCConfig(
        MemoryConfig(ann=ann, **(LSH if ann == "lsh" else {}), **kw),
        ControllerConfig(input_size=D, hidden_size=HIDDEN, output_size=D),
        k_l=KL, sparse=sparse)


def _assert_states_equal(got, want_jax):
    """Every leaf: integers exactly, floats within TOL."""
    want = convert.dnc_state_from_jax(_numpy(want_jax), device="cpu")
    a, spec_a = pytree.tree_flatten(got)
    b, spec_b = pytree.tree_flatten(want)
    assert spec_a == spec_b
    for x, y in zip(a, b):
        if not isinstance(x, torch.Tensor):
            assert x is None and y is None
        elif x.is_floating_point():
            _close(x, y)
        else:
            assert torch.equal(x, y)


# --------------------------------------------------------------------------
# The helpers
# --------------------------------------------------------------------------

def _rows(rng, kind, shape, n_cols=12):
    """(cols, vals) of sparse rows: random unique columns with empty slots,
    or rows full of ties (equal values) and duplicate columns."""
    if kind == "random":
        cols = np.stack([rng.permutation(n_cols)[:shape[-1]]
                         for _ in range(int(np.prod(shape[:-1])))])
        cols = cols.reshape(shape).astype(np.int32)
        cols[rng.random(shape) < 0.25] = -1
        vals = rng.random(shape).astype(np.float32)
    else:
        cols = rng.integers(-1, 3, shape).astype(np.int32)
        vals = np.where(rng.random(shape) < 0.5, 0.25, 0.0).astype(np.float32)
    return cols, vals


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_merge_rows_matches_jax(kind):
    rng = np.random.default_rng(1)
    ca, va = _rows(rng, kind, (B, 5, KL))
    cb, vb = _rows(rng, kind, (B, 5, 7))
    g_vals = rng.standard_normal((B, 5, KL)).astype(np.float32)
    want_c, want_v = jdnc._merge_rows(ca, va, cb, vb, KL)
    a, b = torch.tensor(va, requires_grad=True), torch.tensor(vb,
                                                             requires_grad=True)
    got_c, got_v = dnc._merge_rows(torch.tensor(ca), a, torch.tensor(cb), b,
                                   KL)
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    _close(got_v.detach(), want_v)
    _, vjp = jax.vjp(lambda x, y: jdnc._merge_rows(ca, x, cb, y, KL)[1],
                     jnp.asarray(va), jnp.asarray(vb))
    for g, w in zip(torch.autograd.grad(got_v, (a, b), torch.tensor(g_vals)),
                    vjp(jnp.asarray(g_vals))):
        _close(g, w, GRAD_ATOL, GRAD_RTOL)


def test_merge_rows_combines_duplicates_and_keeps_top_k():
    """The JAX suite's two cases (`tests/test_baselines.py`)."""
    cols, vals = dnc._merge_rows(torch.tensor([[1, 2, -1]]),
                                 torch.tensor([[0.5, 0.25, 0.0]]),
                                 torch.tensor([[2, 3, -1]]),
                                 torch.tensor([[0.25, 0.1, 0.0]]), 3)
    assert dict(zip(cols[0].tolist(), vals[0].tolist())) == pytest.approx(
        {1: 0.5, 2: 0.5, 3: 0.1})
    cols, _ = dnc._merge_rows(torch.tensor([[0, 1, 2]]),
                              torch.tensor([[0.9, 0.8, 0.7]]),
                              torch.tensor([[3, 4, 5]]),
                              torch.tensor([[0.95, 0.1, 0.05]]), 3)
    assert cols[0].tolist() == [3, 0, 1]


def test_sparse_vec_lookup_matches_jax():
    rng = np.random.default_rng(2)
    idx, val = _rows(rng, "random", (B, KL))
    query = rng.integers(-1, 12, (B, 9)).astype(np.int32)
    want = jdnc._sparse_vec_lookup(jdnc.SparseVec(idx, val), query)
    got = dnc._sparse_vec_lookup(
        dnc.SparseVec(torch.tensor(idx), torch.tensor(val)),
        torch.tensor(query))
    _close(got, want)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_link_read_matches_jax(kind):
    """N_t's rows at the previous read's indices, scaled by its weights,
    top K: indices exact, weights and their gradients (in the weights and
    in N_t's values) within the bars. The ties case reads rows full of
    equal values and duplicate columns, with zero read weights."""
    rng = np.random.default_rng(3)
    cols, vals = _rows(rng, kind, (B, N, KL), n_cols=N)
    idx = rng.integers(0, N, (B, R, K)).astype(np.int32)
    w = (rng.random((B, R, K)) if kind == "random"
         else np.zeros((B, R, K))).astype(np.float32)
    g_w = rng.standard_normal((B, R, K)).astype(np.float32)

    def jax_side(v, ww):
        return jdnc._link_read(jdnc.SparseMat(cols, v),
                               jdnc.SparseRead(idx, ww, None), K)

    want_idx, want_w = jax_side(vals, w)
    v_t, w_t = torch.tensor(vals, requires_grad=True), torch.tensor(
        w, requires_grad=True)
    got_idx, got_w = dnc._link_read(
        dnc.SparseMat(torch.tensor(cols), v_t),
        dnc.SparseRead(torch.tensor(idx), w_t, None), K)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    _close(got_w.detach(), want_w)
    _, vjp = jax.vjp(lambda v, ww: jax_side(v, ww)[1], jnp.asarray(vals),
                     jnp.asarray(w))
    for g, want in zip(torch.autograd.grad(got_w, (v_t, w_t),
                                           torch.tensor(g_w)),
                       vjp(jnp.asarray(g_w))):
        _close(g, want, GRAD_ATOL, GRAD_RTOL)


def test_set_rows_last_wins_and_only_the_winner_gets_a_gradient():
    """`.at[b, rows].set`: zeros(3).at[[0, 0]].set([1, 2]) gives 2 at 0 and
    the gradient [0, 1]. The port gives every duplicate its winner's row
    and the gradient to the winner only."""
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((B, 6, KL)).astype(np.float32)
    idx = np.array([[0, 0, 3, 5, 0, 3], [1, 2, 1, 1, 4, 4]], np.int32)
    rows = rng.standard_normal((B, 6, KL)).astype(np.float32)
    g_out = rng.standard_normal(buf.shape).astype(np.float32)
    b_ix = np.arange(B)[:, None]

    def jax_side(m, r):
        return m.at[b_ix, idx].set(r)

    want, vjp = jax.vjp(jax_side, jnp.asarray(buf), jnp.asarray(rows))
    m, r = (torch.tensor(x, requires_grad=True) for x in (buf, rows))
    got = m.clone()
    dnc._set_rows(got, torch.tensor(idx), r)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    for g, w in zip(torch.autograd.grad(got, (m, r), torch.tensor(g_out)),
                    vjp(jnp.asarray(g_out))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_an_empty_precedence_slot_undoes_row_0_of_p():
    """The reference's quirk, reproduced: an empty precedence slot (-1,
    clamped to row 0) comes after the valid ones and sets row 0's old P_t
    row back, so a real update of row 0 is lost (`dnc.py:402-417`)."""
    rng = np.random.default_rng(5)
    cols, vals = _rows(rng, "random", (B, N, KL), n_cols=N)
    prec = jdnc.SparseVec(np.array([[7, 0, -1, -1]] * B, np.int32),
                          rng.random((B, KL)).astype(np.float32))
    widx = rng.integers(1, N, (B, J)).astype(np.int32)
    ww = rng.random((B, J)).astype(np.float32)
    mat = jdnc.SparseMat(jnp.asarray(cols), jnp.asarray(vals))
    js = jdnc.init_state(B, _jax_cfg())._replace(prec_sp=prec, p_mat=mat,
                                                  n_mat=mat)
    _, p_mat, _ = _numpy(jdnc._update_linkage(js, jnp.asarray(widx),
                                              jnp.asarray(ww), KL))
    # Row 0's update is undone, row 7's is not.
    np.testing.assert_array_equal(p_mat.cols[:, 0], cols[:, 0])
    assert not np.array_equal(p_mat.vals[:, 7], vals[:, 7])
    p_rows = prec.idx.clip(0)
    t = torch.tensor
    old = [t(np.take_along_axis(x, p_rows[..., None], 1))
           for x in (cols, vals)]
    n_old = [t(np.take_along_axis(x, widx[..., None], 1))
             for x in (cols, vals)]
    _, mp, _ = dnc._linkage_rows(
        *n_old, *old, dnc.SparseVec(t(prec.idx), t(prec.val)), t(widx),
        t(ww), KL)
    port = dnc.SparseMat(t(cols), t(vals))
    dnc._set_rows(port.cols, t(p_rows), mp[0])
    dnc._set_rows(port.vals, t(p_rows), mp[1])
    np.testing.assert_array_equal(port.cols.numpy(), p_mat.cols)
    _close(port.vals, p_mat.vals)
    np.testing.assert_array_equal(port.vals[:, 0].numpy(), vals[:, 0])


# --------------------------------------------------------------------------
# Rollouts
# --------------------------------------------------------------------------

def _xs(seed=0):
    return np.random.default_rng(seed).standard_normal((T, B, D)).astype(
        np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ann", ["exact", "lsh"])
def test_sdnc_rollout_matches_jax(ann, backend):
    """8 steps from the zero state, every leaf (memory, usage, N_t, P_t,
    precedence, read, LSH index) compared after every step. The zero
    state's first steps are all ties (every previous read weight 0)."""
    jcfg, cfg = _jax_cfg(backend, ann=ann), _port_cfg(ann=ann)
    key = jax.random.PRNGKey(0)
    jparams = jdnc.init_params(key, jcfg)
    js = jdnc.init_state(B, jcfg)
    params = convert.params_from_jax(_numpy(jparams), device="cpu")
    state = convert.dnc_state_from_jax(_numpy(js), device="cpu")
    xs = np.asarray(jax.random.normal(key, (T, B, D)))  # test_unroll.py's
    for t, x in enumerate(xs):
        p_row0 = state.p_mat.cols[:, 0].clone()
        js, jy = jdnc.dnc_step(jparams, jcfg, js, jnp.asarray(x))
        with torch.no_grad():
            state, y = dnc.dnc_step(params, cfg, state, torch.tensor(x))
        _close(y, jy)
        _assert_states_equal(state, js)
        if ann == "exact" and t == 0:
            # Row 0 and an empty slot in the precedence's support ...
            assert state.prec_sp.idx.tolist() == [[31, 0, -1, -1]] * B
        if ann == "exact" and t == 1:
            # ... so step 2's update of P_t row 0 is undone.
            assert torch.equal(state.p_mat.cols[:, 0], p_row0)
    assert int(state.step) == T


def test_dnc_rollout_from_zero_matches_jax_step_by_step():
    """The dense DNC from its zero state: each step from JAX's state (rows
    never written have equal usage, and an ulp of drift between the two
    sides reorders the allocation's sort among them)."""
    jcfg, cfg = _jax_cfg(sparse=False), _port_cfg(sparse=False)
    jparams = jdnc.init_params(jax.random.PRNGKey(0), jcfg)
    js = jdnc.init_state(B, jcfg)
    params = convert.params_from_jax(_numpy(jparams), device="cpu")
    _assert_states_equal(dnc.init_state(B, cfg, device="cpu"), js)
    for x in _xs():
        state = convert.dnc_state_from_jax(_numpy(js), device="cpu")
        js, jy = jdnc.dnc_step(jparams, jcfg, js, jnp.asarray(x))
        with torch.no_grad():
            state, y = dnc.dnc_step(params, cfg, state, torch.tensor(x))
        _close(y, jy)
        _assert_states_equal(state, js)


def _random_dense_state(seed=6):
    """A dense DNC state with distinct usages: random memory, usage, read
    and write weights, precedence and link (zero diagonal)."""
    rng = np.random.default_rng(seed)
    js = _numpy(jdnc.init_state(B, _jax_cfg(sparse=False)))
    link = rng.random((B, N, N)).astype(np.float32) / N
    link[:, np.arange(N), np.arange(N)] = 0.0
    return js._replace(
        memory=rng.standard_normal((B, N, W)).astype(np.float32),
        usage=rng.random((B, N)).astype(np.float32),
        read_w=rng.dirichlet(np.ones(N), (B, R)).astype(np.float32),
        write_w=(0.5 * rng.dirichlet(np.ones(N), B)).astype(np.float32),
        prec=(0.5 * rng.dirichlet(np.ones(N), B)).astype(np.float32),
        link=link)


def test_dnc_rollout_from_a_random_state_matches_jax():
    """8 steps of `dnc_unroll`, whole, from a state with distinct usages:
    the allocation's sort keeps a margin between neighbours of a hundred
    times the usage's drift (and of 1e-5) at every step."""
    jcfg, cfg = _jax_cfg(sparse=False), _port_cfg(sparse=False)
    jparams = jdnc.init_params(jax.random.PRNGKey(1), jcfg)
    js = _random_dense_state()
    params = convert.params_from_jax(_numpy(jparams), device="cpu")
    state = convert.dnc_state_from_jax(js, device="cpu")
    xs = _xs(1)
    for x in xs:
        js, jy = jdnc.dnc_step(jparams, jcfg, js, jnp.asarray(x))
        with torch.no_grad():
            state, y = dnc.dnc_step(params, cfg, state, torch.tensor(x))
        _close(y, jy)
        _assert_states_equal(state, js)
        drift = (state.usage - torch.tensor(np.asarray(js.usage))).abs().max()
        gaps = torch.sort(state.usage, -1).values.diff(dim=-1)
        assert gaps.min() > 100 * max(drift, 1e-7)
    with torch.no_grad():
        final, ys = dnc.dnc_unroll(params, cfg,
                                   convert.dnc_state_from_jax(
                                       _random_dense_state(), device="cpu"),
                                   torch.tensor(xs))
    _, j_ys = jdnc.dnc_unroll(jparams, jcfg, _random_dense_state(),
                              jnp.asarray(xs))
    _close(ys, j_ys)
    _assert_states_equal(final, js)


# --------------------------------------------------------------------------
# Gradients against jax.grad of JAX's naive dnc_unroll
# --------------------------------------------------------------------------

FLOATS = ("memory", "n_vals", "p_vals", "prec_val", "read_w")


def _sdnc_inputs(ann, seed=0):
    """Weights from the JAX init; a random initial state: memory (scratch
    row zero), N_t and P_t (unique columns a row, a quarter empty),
    precedence (one empty slot), the previous read and controller; xs and
    the loss weights from numpy. An LSH SDNC's index is JAX's `ann_build`
    of the initial memory."""
    rng = np.random.default_rng(seed)
    jcfg = _jax_cfg(ann=ann)
    jparams = _numpy(jdnc.init_params(jax.random.PRNGKey(seed), jcfg))
    js = _numpy(jdnc.init_state(B, jcfg))
    n_cols, n_vals = _rows(rng, "random", (B, N, KL), n_cols=N)
    p_cols, p_vals = _rows(rng, "random", (B, N, KL), n_cols=N)
    p_idx = np.stack([rng.permutation(N)[:KL] for _ in range(B)])
    p_idx[0, -1] = -1
    mem = rng.standard_normal(js.memory.shape).astype(np.float32)
    mem[:, N] = 0.0
    js = js._replace(
        n_mat=js.n_mat._replace(cols=n_cols),
        p_mat=js.p_mat._replace(cols=p_cols),
        prec_sp=js.prec_sp._replace(idx=p_idx.astype(np.int32)),
        read=js.read._replace(
            indices=rng.integers(0, N, (B, R, K)).astype(np.int32)),
        ctrl=js.ctrl._replace(
            h=(0.5 * rng.standard_normal((B, HIDDEN))).astype(np.float32)))
    if ann == "lsh":
        js = js._replace(ann=_numpy(jann.ann_build(
            jnp.asarray(jparams["lsh_planes"]), jnp.asarray(mem),
            jcfg.memory, partitions=1)))
    floats = dict(memory=mem, n_vals=n_vals, p_vals=p_vals,
                  prec_val=rng.random((B, KL)).astype(np.float32),
                  read_w=rng.dirichlet(np.ones(K), (B, R)).astype(np.float32))
    xs = _xs(seed)
    r_mem = rng.standard_normal(mem.shape).astype(np.float32)
    r_link = rng.standard_normal(n_vals.shape).astype(np.float32)
    return jparams, js, floats, xs, (r_mem, r_link)


def _with_floats(s, f):
    """State ``s`` (JAX's or the port's) with the FLOATS of ``f``."""
    return s._replace(
        memory=f["memory"], n_mat=s.n_mat._replace(vals=f["n_vals"]),
        p_mat=s.p_mat._replace(vals=f["p_vals"]),
        prec_sp=s.prec_sp._replace(val=f["prec_val"]),
        read=s.read._replace(weights=f["read_w"]))


def _loss(final, ys, r_mem, r_link):
    """Reads the outputs and the final memory, N_t, P_t and read words."""
    return ((ys ** 2).sum() + (final.memory * r_mem).sum()
            + (final.n_mat.vals * r_link).sum()
            + (final.p_mat.vals * r_link).sum()
            + (final.read_words ** 2).sum())


@functools.lru_cache(maxsize=None)
def _jax_sdnc_grads(backend, ann):
    """(loss, ys, grads as numpy: params tree, the FLOATS, xs) of JAX's
    naive `dnc_unroll`."""
    jparams, js, floats, xs, (r_mem, r_link) = _sdnc_inputs(ann)
    jcfg = _jax_cfg(backend, ann=ann)

    def loss(p, f, x):
        final, ys = jdnc.dnc_unroll(p, jcfg, _with_floats(js, f), x)
        return _loss(final, ys, r_mem, r_link), ys

    (val, ys), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jparams, floats, xs)
    return float(val), np.asarray(ys), _numpy(grads)


def _port_sdnc_grads(mode, chunk, ann):
    jparams, js, floats, xs, (r_mem, r_link) = _sdnc_inputs(ann)
    params = convert.params_from_jax(jparams, device="cpu")
    p_leaves, p_spec = pytree.tree_flatten(params)
    p_leaves = [p.requires_grad_() for p in p_leaves]
    f = {k: torch.tensor(v, requires_grad=True) for k, v in floats.items()}
    x = torch.tensor(xs, requires_grad=True)
    # The unroll updates the memory, N_t and P_t in place: copies of the
    # leaves.
    s0 = _with_floats(convert.dnc_state_from_jax(js, device="cpu"),
                      {k: v.clone() if k in ("memory", "n_vals", "p_vals")
                       else v for k, v in f.items()})
    final, ys = unroll.unroll(SDNCCell(_port_cfg(ann=ann)),
                              pytree.tree_unflatten(p_leaves, p_spec), s0, x,
                              mode=mode, chunk=chunk)
    loss = _loss(final, ys, torch.tensor(r_mem), torch.tensor(r_link))
    inputs = [*p_leaves, *(f[k] for k in FLOATS), x]
    grads = [torch.zeros_like(i) if g is None else g for i, g in zip(
        inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]
    g_params = pytree.tree_unflatten(list(grads[:len(p_leaves)]), p_spec)
    return (loss.item(), ys.detach(), g_params,
            dict(zip(FLOATS, grads[len(p_leaves):-1])), grads[-1], s0,
            floats, js)


def _check_sdnc_grads(mode, chunk, ann):
    loss, ys, g_params, g_floats, g_xs, s0, floats, js = _port_sdnc_grads(
        mode, chunk, ann)
    if mode != "naive":
        # The rollback gave the memory, N_t and P_t back bit for bit.
        np.testing.assert_array_equal(s0.memory.detach(), floats["memory"])
        for mat, name in ((s0.n_mat, "n"), (s0.p_mat, "p")):
            np.testing.assert_array_equal(mat.vals.detach(),
                                          floats[f"{name}_vals"])
            np.testing.assert_array_equal(mat.cols,
                                          getattr(js, f"{name}_mat").cols)
    for backend in BACKENDS:
        j_loss, j_ys, (jg_params, jg_floats, jg_xs) = _jax_sdnc_grads(
            backend, ann)
        _close(ys, j_ys)
        np.testing.assert_allclose(loss, j_loss, rtol=TOL)
        assert g_params.keys() == jg_params.keys()
        for group, leaves in jg_params.items():
            if group == "lsh_planes":             # fixed: zero on both sides
                assert (leaves == 0).all() and (g_params[group] == 0).all()
                continue
            for name, want in leaves.items():
                _close(g_params[group][name], want, GRAD_ATOL, GRAD_RTOL)
        for name in FLOATS:
            assert np.abs(jg_floats[name]).max() > 0, name
            _close(g_floats[name], jg_floats[name], GRAD_ATOL, GRAD_RTOL)
        _close(g_xs, jg_xs, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("mode,chunk", [
    ("naive", None), ("sparse", None), ("chunked", 1), ("chunked", 4),
    ("chunked", T), ("chunked", "auto")],
    ids=["naive", "sparse", "chunked1", "chunked4", "chunkedT", "auto"])
def test_sdnc_unroll_grads_match_jax(mode, chunk):
    _check_sdnc_grads(mode, chunk, "exact")


@pytest.mark.parametrize("mode,chunk", [
    ("naive", None), ("sparse", None), ("chunked", 3)],
    ids=["naive", "sparse", "chunked3"])
def test_lsh_sdnc_unroll_grads_match_jax(mode, chunk):
    """The chunked recompute must start each segment from the index as it
    was at the segment's start."""
    _check_sdnc_grads(mode, chunk, "lsh")


@pytest.mark.parametrize("start,steps", [("zero", 2), ("random", T)])
def test_dnc_naive_grads_match_jax(start, steps):
    """The dense DNC's gradients (parameters, xs, initial memory) through
    the allocation's full sort and the cumprod over the zero state's
    zeros at step 1. From the zero state over two steps: from step 3 on,
    rows never written differ in usage by an ulp between the two sides
    and the sort orders them differently (the rollout tests)."""
    jcfg, cfg = _jax_cfg(sparse=False), _port_cfg(sparse=False)
    jparams = _numpy(jdnc.init_params(jax.random.PRNGKey(2), jcfg))
    js = (_numpy(jdnc.init_state(B, jcfg)) if start == "zero"
          else _random_dense_state())
    xs = _xs(2)[:steps]

    def loss(p, m, x):
        final, ys = jdnc.dnc_unroll(p, jcfg, js._replace(memory=m), x)
        return (ys ** 2).sum() + (final.memory ** 2).sum()

    j_val, (jg_p, jg_m, jg_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2)))(jparams, js.memory, xs)
    params = convert.params_from_jax(jparams, device="cpu")
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.requires_grad_() for p in leaves]
    m = torch.tensor(js.memory, requires_grad=True)
    x = torch.tensor(xs, requires_grad=True)
    s0 = convert.dnc_state_from_jax(js, device="cpu")._replace(memory=m)
    final, ys = dnc.dnc_unroll(pytree.tree_unflatten(leaves, spec), cfg, s0,
                               x)
    val = (ys ** 2).sum() + (final.memory ** 2).sum()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=TOL)
    grads = torch.autograd.grad(val, [*leaves, m, x])
    g_params = pytree.tree_unflatten(list(grads[:len(leaves)]), spec)
    for group, tree in _numpy(jg_p).items():
        for name, want in tree.items():
            _close(g_params[group][name], want, GRAD_ATOL, GRAD_RTOL)
    _close(grads[-2], jg_m, GRAD_ATOL, GRAD_RTOL)
    _close(grads[-1], jg_x, GRAD_ATOL, GRAD_RTOL)


# --------------------------------------------------------------------------
# The rollback, the backward's launches, the accounting
# --------------------------------------------------------------------------

def _cpu_params(cell, seed):
    params = cell.init_params(torch.Generator().manual_seed(seed),
                              device="cpu")
    for p in pytree.tree_leaves(params):
        p.requires_grad_()
    return params


def _buffers(s):
    return [s.memory, s.usage, *s.n_mat, *s.p_mat]


@pytest.mark.parametrize("mode,chunk", [("sparse", None), ("chunked", 3)])
def test_rollback_restores_memory_and_links_and_refuses_a_step(mode, chunk):
    """After a sparse or chunked backward the memory, N_t and P_t hold
    their contents from before the unroll bit for bit (the usage table
    stays at step T), and a step from the returned state or from state0
    raises; a fresh state steps as before."""
    cell = SDNCCell(_port_cfg())
    params = _cpu_params(cell, 1)
    xs = torch.tensor(_xs(1))
    state0 = cell.init_state(B, device="cpu")
    with torch.no_grad():
        for x in xs[:3]:                      # buffers that are not all zero
            state0, _ = cell.step(params, state0, x)
    before = [t.clone() for t in _buffers(state0)]
    final, ys = unroll.unroll(cell, params, state0, xs, mode=mode,
                              chunk=chunk)
    assert not all(torch.equal(a, b) for a, b in zip(_buffers(final), before))
    ys.sum().backward()
    for got, want, name in zip(_buffers(final), before,
                               ["memory", "usage", "n cols", "n vals",
                                "p cols", "p vals"]):
        assert torch.equal(got, want) == (name != "usage"), name
    for s in (final, state0):
        with pytest.raises(RuntimeError, match="rolled back"):
            cell.step(params, s, xs[0])
    fresh = cell.init_state(B, device="cpu")
    with torch.no_grad():
        cell.step(params, fresh, xs[0])


def test_sdnc_backward_launches_no_selection():
    """The sparse backward calls no read, LRA or hash (all O(N) or need the
    usage table or the index); the chunked one recomputes each segment's
    forward once."""
    calls = {"read": 0, "lra": 0, "hash": 0}
    saved = ops.fused_read, ops.lra_topn, ops.lsh_hash

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    ops.fused_read, ops.lra_topn, ops.lsh_hash = (
        counting(n, f) for n, f in zip(calls, saved))
    try:
        for ann, mode, chunk, extra in (
                ("exact", "sparse", None, 0), ("lsh", "sparse", None, 0),
                ("exact", "chunked", 3, T)):
            cell = SDNCCell(_port_cfg(ann=ann))
            params = _cpu_params(cell, 0)
            _, ys = unroll.unroll(cell, params,
                                  cell.init_state(B, device="cpu"),
                                  torch.tensor(_xs()), mode=mode, chunk=chunk)
            calls.update(read=0, lra=0, hash=0)
            ys.sum().backward()
            assert calls == {"read": extra, "lra": extra,
                             "hash": 2 * extra if ann == "lsh" else 0}
    finally:
        ops.fused_read, ops.lra_topn, ops.lsh_hash = saved


@pytest.mark.parametrize("ann", ["exact", "lsh"])
@pytest.mark.parametrize("mode,chunk", [("naive", None), ("sparse", None),
                                        ("chunked", 3), ("chunked", "auto")])
def test_residual_accounting_matches_jax(mode, chunk, ann):
    jparams, js, _, xs, _ = _sdnc_inputs(ann)
    jcell = JaxSDNCCell(_jax_cfg(ann=ann))
    want = junroll.residual_accounting(jcell, jparams, js, jnp.asarray(xs),
                                       mode=mode, chunk=chunk)
    state = convert.dnc_state_from_jax(js, device="cpu")
    cell = SDNCCell(_port_cfg(ann=ann))
    got = unroll.residual_accounting(
        cell, convert.params_from_jax(jparams, device="cpu"), state,
        torch.tensor(xs), mode=mode, chunk=chunk)
    assert got == want
    assert unroll.suggest_chunk(cell, None, state, torch.tensor(xs)) == \
        junroll.suggest_chunk(jcell, jparams, js, jnp.asarray(xs))


# --------------------------------------------------------------------------
# Training steps
# --------------------------------------------------------------------------

def _acc_like(jparams, rng):
    return jax.tree.map(
        lambda p: (0.01 + rng.random(p.shape)).astype(np.float32) * 1e-3,
        jparams)


def _three_train_steps(kind, mem, ctl, batches, bptt_chunk=None):
    """Three steps of the port and of JAX from the same weights, optimizer
    state and batches: losses, bit errors, weights and accumulators."""
    rng = np.random.default_rng(7)
    j_init, _, j_step = jax_train_step(
        JaxModelSpec(kind, JaxMemoryConfig(backend="ref", **mem),
                     JaxControllerConfig(**ctl), bptt_chunk=bptt_chunk), 1e-3)
    _, _, step = training.make_task_train_step(
        training.ModelSpec(kind, MemoryConfig(**mem), ControllerConfig(**ctl),
                           bptt_chunk=bptt_chunk), 1e-3, device="cpu")
    jparams = _numpy(j_init(jax.random.PRNGKey(3)))
    j_opt = jopt.RMSPropState(acc=_acc_like(jparams, rng))
    params = convert.params_from_jax(jparams, device="cpu")
    opt_state = convert.opt_state_from_jax(j_opt, device="cpu")
    j_step = jax.jit(j_step)
    for batch in batches:
        jparams, j_opt, j_loss, j_err = j_step(
            jparams, j_opt, *(jnp.asarray(t.numpy()) for t in batch))
        params, opt_state, loss, err = step(params, opt_state, *batch)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
        assert err.item() == float(j_err)
        for got, want in ((params, jparams), (opt_state.acc, j_opt.acc)):
            for group, leaves in _numpy(want).items():
                for name, leaf in leaves.items():
                    _close(got[group][name], leaf)


def _recall_batches(max_items, item_len, bits, seed=8):
    rng = np.random.default_rng(seed)
    out = []
    for n in (max_items, 3, 1):
        items = rng.integers(0, 2, (B, max_items, item_len, bits))
        q_idx = rng.integers(0, max(n - 1, 1), B)
        out.append(tasks.associative_recall_task(
            B, n, max_items, bits, item_len, items=items, q_idx=q_idx,
            device="cpu"))
    return out


def test_three_sdnc_train_steps_on_associative_recall_match_jax():
    """`tests/test_unroll.py`'s chunked train step (N = 16, W = 8, R = 2,
    K = 2, hidden 16) at T = 64 (29 items of 2 vectors) with C = 16."""
    batches = _recall_batches(29, 2, 6)
    assert batches[0][0].shape[1] == 64
    _three_train_steps("sdnc", dict(num_slots=16, word_size=8, num_heads=2,
                                    k=2),
                       dict(input_size=8, hidden_size=16, output_size=6),
                       batches, bptt_chunk=16)


def test_three_dnc_train_steps_on_priority_sort_match_jax():
    rng = np.random.default_rng(9)
    batches = [tasks.priority_sort_task(
        B, n, 4, 6, vecs=rng.integers(0, 2, (B, 4, 6)),
        prio=rng.uniform(-1, 1, (B, 4)), device="cpu") for n in (4, 2, 3)]
    _three_train_steps("dnc", dict(num_slots=16, word_size=8, num_heads=2,
                                   k=2),
                       dict(input_size=8, hidden_size=16, output_size=6),
                       batches)


# --------------------------------------------------------------------------
# The tasks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_items,max_items", [(1, 4), (4, 4), (5, 7),
                                                 (16, 20)])
def test_tasks_match_jax(num_items, max_items):
    """Both tasks' (inputs, targets, mask) bit for bit for JAX's draws:
    the associative-recall items and query, the priority-sort vectors and
    priorities (dead rows tie at -2.0; the answer count is ceil(0.8·n))."""
    key = jax.random.PRNGKey(10 * num_items + max_items)
    k1, k2 = jax.random.split(key)
    bits = 6
    items = np.asarray(jax.random.bernoulli(k1, 0.5, (3, max_items, 3, bits)),
                       np.float32)
    q_idx = np.asarray(jax.random.randint(k2, (3,), 0,
                                          max(num_items - 1, 1)))
    vecs = np.asarray(jax.random.bernoulli(k1, 0.5, (3, max_items, bits)),
                      np.float32)
    prio = np.asarray(jax.random.uniform(k2, (3, max_items), minval=-1.0,
                                         maxval=1.0))
    for got, want in (
            (tasks.associative_recall_task(3, num_items, max_items, bits,
                                           items=items, q_idx=q_idx,
                                           device="cpu"),
             jtasks.associative_recall_task(key, 3, num_items, max_items,
                                            bits)),
            (tasks.priority_sort_task(3, num_items, max_items, bits,
                                      vecs=vecs, prio=prio, device="cpu"),
             jtasks.priority_sort_task(key, 3, num_items, max_items, bits))):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tasks_draw_from_the_generator_and_train_task_runs_them():
    for name in ("associative_recall", "priority_sort"):
        fn = training.TASKS[name]
        a, b = (fn(B, 3, 5, 6, generator=torch.Generator().manual_seed(1),
                   device="cpu") for _ in range(2))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert a[2].sum() > 0
        assert set(a[0][..., :6].unique().tolist()) <= {0.0, 1.0}
    spec = training.ModelSpec("sdnc", MemoryConfig(num_slots=16, word_size=8,
                                                   num_heads=2, k=2),
                              ControllerConfig(input_size=8, hidden_size=16,
                                               output_size=6))
    _, history = training.train_task(spec, "priority_sort", steps=2, batch=B,
                                     level=3, max_level=4, bits=6, lr=1e-3,
                                     device="cpu")
    assert all(np.isfinite(h["loss"]) for h in history)


# --------------------------------------------------------------------------
# Refusals, the converter, the module
# --------------------------------------------------------------------------

def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match="int8"):
        SDNCCell(_port_cfg(mem_dtype="int8")).init_state(B, device="cpu")
    # bf16 rows build; a state whose memory is not the config's dtype is
    # refused.
    assert SDNCCell(_port_cfg(mem_dtype="bfloat16")).init_state(
        B, device="cpu").memory.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="sparse"):
        SDNCCell(_port_cfg(sparse=False))
    with pytest.raises(ValueError, match="no sparse rollback contract"):
        dnc.dnc_step({}, _port_cfg(sparse=False), None, None,
                     collect_deltas=True)
    state = SDNCCell(_port_cfg()).init_state(B, device="cpu")
    with pytest.raises(ValueError, match="needs a torch.float32 memory"):
        dnc.dnc_step({}, _port_cfg(), state._replace(
            memory=state.memory.bfloat16()), torch.zeros(B, D))
    # A slot-sharded memory: rank 0 of 2 holds rows [0, N/2).
    monkeypatch.setattr(mem_shard._CTX, "ctx", mem_shard.MemShardCtx(
        group=None, rank=0, shards=2, num_slots=N))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        dnc.init_state(B, _port_cfg(), device="cpu")
    block = state._replace(memory=state.memory[:, :N // 2 + 1].contiguous())
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        dnc.dnc_step({}, _port_cfg(), block, torch.zeros(B, D))
    monkeypatch.setattr(mem_shard._CTX, "ctx", None)
    # JAX's own messages.
    with pytest.raises(ValueError, match="int8"):
        jdnc.init_state(B, _jax_cfg(mem_dtype="int8"))


def test_converter_takes_the_dnc_trees():
    for sparse, ann in ((False, "exact"), (True, "exact"), (True, "lsh")):
        jcfg = _jax_cfg(sparse=sparse, ann=ann)
        jparams = _numpy(jdnc.init_params(jax.random.PRNGKey(0), jcfg))
        params = convert.params_from_jax(jparams, device="cpu")
        assert set(params) == set(jparams)
        for group, leaves in jparams.items():
            if group == "lsh_planes":
                np.testing.assert_array_equal(params[group], leaves)
                continue
            for name, leaf in leaves.items():
                np.testing.assert_array_equal(params[group][name], leaf)
        state = convert.dnc_state_from_jax(
            _numpy(jdnc.init_state(B, jcfg)), device="cpu")
        mine = dnc.init_state(B, _port_cfg(sparse=sparse, ann=ann),
                              device="cpu")
        _assert_states_equal(mine, jdnc.init_state(B, jcfg))
        assert (state.ann is None) == (ann == "exact")


def test_module_forward_records_no_graph_and_its_weights_train():
    model = dnc.DNC(_port_cfg(ann="lsh"), seed=2, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    assert "lsh_planes" in model.params()
    xs = torch.tensor(_xs())
    _, ys = model(model.init_state(B), xs)
    assert not ys.requires_grad and ys.shape == (T, B, D)
    cell = SDNCCell(model.cfg)
    _, ys = unroll.unroll(cell, model.params(), model.init_state(B), xs)
    ys.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
