"""The port's dense baselines (`repro_torch.core.dense`: DAM, the NTM, the
LSTM) and DAM's least-used selection (`usage_argmin`) against the JAX
package, on the CPU.

B = 2, H = 2, W = 8, N = 64 or 1024, controller 24, T <= 8. Both sides
get the same numpy inputs; weights and states come from the JAX side
through `repro_torch.convert`. The JAX side runs under the ``ref`` and the
``pallas-interpret`` backends (the Pallas `usage_argmin` in interpret
mode).

Tolerances: indices (DAM's least-used row) and step counters exact;
floats within 1e-5; gradients (`jax.grad` of ``(ys**2).sum()`` against
autograd) and three RMSProp steps within atol/rtol 1e-5, the bar of
`tests/test_torch_train.py`.

DAM's argmin decides which row is erased, and it sees near-ties: the
least and the second-least usage of a step can lie within a few times the
torch-XLA drift of the usage table (the two sum the same softmax weights
in other orders). So a whole rollout is compared only where every step's
relative gap exceeds ten times the drift measured in that rollout, and the
test asserts that margin; single steps from one converted state
(teacher-forced) see the same table on both sides and must pick the same
row outright.
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
from repro.core import dense as jdense
from repro.core.training import ModelSpec as JaxModelSpec
from repro.core.training import make_task_train_step as jax_train_step
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.kernels import ref as jref
from repro.kernels.usage_argmin import usage_argmin as pallas_argmin
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.core import addressing as addr
from repro_torch.core import dense, training
from repro_torch.core.types import ControllerConfig, MemoryConfig
from repro_torch.data.tasks import copy_task
from repro_torch.kernels import ops

TOL = 1e-5
B, H, W, HIDDEN, IN, OUT, T = 2, 2, 8, 24, 10, 8, 8
BACKENDS = ["ref", "pallas-interpret"]


def _close(a, b, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(model, N, backend="ref"):
    jcfg = jdense.DenseConfig(
        JaxMemoryConfig(num_slots=N, word_size=W, num_heads=H,
                        backend=backend),
        JaxControllerConfig(input_size=IN, hidden_size=HIDDEN,
                            output_size=OUT), model=model)
    cfg = dense.DenseConfig(
        MemoryConfig(num_slots=N, word_size=W, num_heads=H),
        ControllerConfig(input_size=IN, hidden_size=HIDDEN, output_size=OUT),
        model=model)
    return jcfg, cfg


def _xs(seed=0, steps=T):
    return np.random.default_rng(seed).standard_normal(
        (steps, B, IN)).astype(np.float32)


def _leaves_close(got, want):
    """A torch tree against a JAX one: dicts key by key (JAX orders a
    dict's leaves by sorted key, torch by insertion), tuples field by
    field; int32 leaves exact, float leaves within 1e-5."""
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _leaves_close(got[k], want[k])
    elif isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _leaves_close(g, w)
    elif got.dtype == torch.int32:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got.detach().numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# usage_argmin
# --------------------------------------------------------------------------

def _usage_table(case, N, block_n):
    """(3, N) f32 table and the indices it must give (None: as JAX's)."""
    rng = np.random.default_rng(N)
    u = (1.0 + rng.random((3, N))).astype(np.float32)
    if case == "ties":
        u[:] = 0.5
        return u, [0, 0, 0]
    if case == "two_tiles":          # a minimum in tiles 0 and 2, or 1 and 3
        lo = np.array([5, block_n + 1, 2])
        u[np.arange(3), lo] = u[np.arange(3), lo + 2 * block_n] = 0.25
        return u, lo.tolist()
    if case == "signed_zero":        # -0.0 equals +0.0: the lower index
        u[0, 7], u[0, 3 * block_n] = -0.0, 0.0
        u[1, 7], u[1, 3 * block_n] = 0.0, -0.0
        u[2, block_n], u[2, block_n + 1] = 0.0, -0.0
        return u, [7, 7, block_n]
    if case == "dam_initial":
        u[:] = np.arange(N, dtype=np.float32) * np.float32(1e-6)
        return u, [0, 0, 0]
    return u, None


@pytest.mark.parametrize("N,block_n", [(64, 16), (1024, 128)])
@pytest.mark.parametrize("case", ["random", "ties", "two_tiles",
                                  "signed_zero", "dam_initial"])
def test_usage_argmin_matches_jax_ref_and_pallas(case, N, block_n):
    u, want = _usage_table(case, N, block_n)
    got = ops.usage_argmin(torch.tensor(u))
    assert got.dtype == torch.int32 and got.shape == (3,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.usage_argmin_ref(jnp.asarray(u))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas_argmin(
        jnp.asarray(u), block_n=block_n, interpret=True)))
    if want is not None:
        assert got.tolist() == want
    # valid_n: the rows past it are not swept (a smaller value there).
    u[:, N - block_n:] = -1.0
    nv = N - block_n
    np.testing.assert_array_equal(
        ops.usage_argmin(torch.tensor(u), valid_n=nv).numpy(),
        np.asarray(pallas_argmin(jnp.asarray(u), block_n=block_n,
                                 interpret=True, valid_n=nv)))


# --------------------------------------------------------------------------
# Addressing
# --------------------------------------------------------------------------

def test_dam_usage_is_discounted_sum():
    usage = torch.ones((1, 4))
    rw = torch.zeros((1, 1, 4))
    rw[:, :, 2] = 1.0
    out = addr.dam_usage_update(usage, rw, torch.zeros((1, 1, 4)), 0.5)
    np.testing.assert_allclose(out[0].numpy(), [0.5, 0.5, 1.5, 0.5])
    rng = np.random.default_rng(1)
    u, r, w = (rng.random(s).astype(np.float32)
               for s in ((B, 64), (B, H, 64), (B, H, 64)))
    _close(addr.dam_usage_update(*map(torch.tensor, (u, r, w)), 0.99),
           jaddr.dam_usage_update(u, r, w, 0.99))


@pytest.mark.parametrize("N", [64, 2 * addr.READ_ROWS])
def test_dense_products_match_jax(N):
    """The similarities, the read and the write's add term; their sums over
    N run in chunks of `addr.READ_ROWS` rows where that divides N (two
    chunks at N = 2·READ_ROWS), in one piece elsewhere."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H, W)).astype(np.float32)
    m = rng.standard_normal((B, N, W)).astype(np.float32)
    m[:, 5] = 0.0                                # a zero row: rsqrt(eps)
    beta = (1.0 + rng.random((B, H))).astype(np.float32)
    t = [torch.tensor(x) for x in (q, m, beta)]
    _close(addr.cosine_sim(*t[:2]), jaddr.cosine_sim(q, m))
    w = addr.dense_read_weights(*t)
    _close(w, jaddr.dense_read_weights(q, m, beta))
    _close(addr.dense_read(w, t[1]), jaddr.dense_read(np.asarray(w), m))
    _close(addr.outer_rows(w, t[0]),
           jnp.einsum("bhn,bhw->bnw", np.asarray(w), q))


# --------------------------------------------------------------------------
# Steps and rollouts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("N", [64, 1024, 2 * addr.READ_ROWS])
@pytest.mark.parametrize("model", ["dam", "ntm"])
def test_dense_step_teacher_forced_matches_jax(model, N, backend):
    """Three JAX steps, then one step on each side from the converted
    state: the least-used row exact, every leaf of the new state and the
    output within 1e-5, the step counter exact."""
    jcfg, cfg = _configs(model, N, backend)
    jparams = _numpy(jdense.init_params(jax.random.PRNGKey(0), jcfg))
    xs = _xs()
    jstate, _ = jdense.dense_unroll(jparams, jcfg,
                                    jdense.init_state(B, jcfg), xs[:3])
    jstate = _numpy(jstate)
    state = convert.dense_state_from_jax(jstate, device="cpu")
    params = convert.params_from_jax(jparams, device="cpu")
    if model == "dam":
        np.testing.assert_array_equal(
            ops.usage_argmin(state.usage).numpy(),
            np.asarray(jref.usage_argmin_ref(jstate.usage)))
    j_new, j_y = jdense.dense_step(jparams, jcfg, jstate, xs[3])
    new, y = dense.dense_step(params, cfg, state, torch.tensor(xs[3]))
    _close(y, j_y)
    _leaves_close(new, _numpy(j_new))
    assert int(new.step) == 4


def _rel_gap(usage):
    """Per batch row: (second-least - least) / |second-least| of a usage
    table."""
    two = np.sort(usage, axis=-1)[:, :2]
    return (two[:, 1] - two[:, 0]) / np.abs(two[:, 1])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model,N", [("dam", 1024), ("ntm", 64),
                                     ("ntm", 1024)])
def test_dense_unroll_matches_jax_every_step(model, N, backend):
    """T steps from the same initial state, each side on its own: outputs
    and states within 1e-5 after every step, DAM's least-used rows equal.
    For DAM the margin of the comparison is asserted: every step's
    relative gap between the least and the second-least usage is at least
    ten times the largest relative drift between the two usage tables."""
    jcfg, cfg = _configs(model, N, backend)
    jparams = _numpy(jdense.init_params(jax.random.PRNGKey(1), jcfg))
    params = convert.params_from_jax(jparams, device="cpu")
    jstate = jdense.init_state(B, jcfg)
    state = dense.init_state(B, cfg, device="cpu")
    _leaves_close(state, _numpy(jstate))          # bit for bit at the start
    jstep = jax.jit(lambda s, x: jdense.dense_step(jparams, jcfg, s, x))
    gaps, drift = [], 0.0
    for x in _xs(1):
        j_lra = np.asarray(jref.usage_argmin_ref(jstate.usage))
        np.testing.assert_array_equal(ops.usage_argmin(state.usage).numpy(),
                                      j_lra)
        gaps.append(_rel_gap(np.asarray(jstate.usage)).min())
        jstate, j_y = jstep(jstate, x)
        state, y = dense.dense_step(params, cfg, state, torch.tensor(x))
        _close(y, j_y)
        _leaves_close(state, _numpy(jstate))
        drift = max(drift, float(np.abs(state.usage.numpy() / jstate.usage
                                        - 1.0).max()))
    if model == "dam":
        assert min(gaps) >= 10 * drift, (min(gaps), drift)


@pytest.mark.parametrize("model", ["dam", "ntm", "lstm"])
def test_grads_match_jax(model):
    """`jax.grad` of ``(ys**2).sum()`` over a T-step unroll (the dense
    kinds' `dense_unroll`, the LSTM's `lstm_baseline_unroll`) against
    autograd, for every weight leaf, and for the dense kinds the initial
    memory and the inputs: within atol/rtol 1e-5."""
    xs = _xs(2)
    if model == "lstm":
        jctl = JaxControllerConfig(input_size=IN, hidden_size=HIDDEN,
                                   output_size=OUT)
        ctl = ControllerConfig(input_size=IN, hidden_size=HIDDEN,
                               output_size=OUT)
        jparams = _numpy(jdense.lstm_baseline_init(jax.random.PRNGKey(2),
                                                   jctl))

        def jloss(p, m0, x):
            return (jdense.lstm_baseline_unroll(p, jctl, B, x)[1] ** 2).sum()

        def loss(p, m0, x):
            return (dense.lstm_baseline_unroll(p, ctl, B, x)[1] ** 2).sum()
        m0 = np.zeros(1, np.float32)
    else:
        jcfg, cfg = _configs(model, 64)
        jparams = _numpy(jdense.init_params(jax.random.PRNGKey(2), jcfg))
        js0 = jdense.init_state(B, jcfg)
        m0 = (np.asarray(js0.memory)
              + 0.1 * np.random.default_rng(3).standard_normal(
                  js0.memory.shape).astype(np.float32))

        def jloss(p, m, x):
            return (jdense.dense_unroll(p, jcfg, js0._replace(memory=m),
                                        x)[1] ** 2).sum()

        def loss(p, m, x):
            s0 = dense.init_state(B, cfg, device="cpu")._replace(memory=m)
            return (dense.dense_unroll(p, cfg, s0, x)[1] ** 2).sum()
    j_l, j_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jparams, m0, xs)
    leaves, tdef = pytree.tree_flatten(
        convert.params_from_jax(jparams, device="cpu"))
    leaves = [t.requires_grad_() for t in leaves]
    m = torch.tensor(m0, requires_grad=True)
    x = torch.tensor(xs, requires_grad=True)
    l_t = loss(pytree.tree_unflatten(leaves, tdef), m, x)
    _close(l_t.item(), float(j_l))
    got = torch.autograd.grad(l_t, [*leaves, m, x], allow_unused=True)
    got = [torch.zeros(t.shape) if g is None else g
           for t, g in zip([*leaves, m, x], got)]
    _leaves_close((pytree.tree_unflatten(got[:-2], tdef), *got[-2:]),
                  _numpy(j_g))


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def _acc_like(jparams, rng):
    return jax.tree.map(
        lambda p: (0.01 + rng.random(p.shape)).astype(np.float32) * 1e-3,
        jparams)


@pytest.mark.parametrize("kind", ["dam", "ntm", "lstm"])
def test_three_train_steps_match_jax(kind):
    """Three `make_task_train_step` steps of the port and of JAX from the
    same weights, optimizer state and copy-task batches: losses, bit
    errors, weights and accumulators within 1e-5."""
    rng = np.random.default_rng(7)
    lr, max_len, bits = 1e-3, 3, IN - 2
    jcfg, cfg = _configs(kind if kind != "lstm" else "dam", 64)
    _, _, j_step = jax_train_step(
        JaxModelSpec(kind, jcfg.memory, jcfg.controller), lr)
    j_init, _, _ = jax_train_step(
        JaxModelSpec(kind, jcfg.memory, jcfg.controller), lr)
    _, _, step = training.make_task_train_step(
        training.ModelSpec(kind, cfg.memory, cfg.controller), lr,
        device="cpu")
    jparams = _numpy(j_init(jax.random.PRNGKey(3)))
    j_opt = jopt.RMSPropState(acc=_acc_like(jparams, rng))
    params = convert.params_from_jax(jparams, device="cpu")
    opt_state = convert.opt_state_from_jax(j_opt, device="cpu")
    j_step = jax.jit(j_step)
    for length in (3, 1, 2):
        seq = rng.integers(0, 2, (B, max_len, bits))
        batch = copy_task(B, length, max_len, bits, seq=seq, device="cpu")
        jparams, j_opt, j_loss, j_err = j_step(
            jparams, j_opt, *(jnp.asarray(t.numpy()) for t in batch))
        params, opt_state, loss, err = step(params, opt_state, *batch)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
        assert err.item() == float(j_err)
        _leaves_close(params, _numpy(jparams))
        _leaves_close(opt_state.acc, _numpy(j_opt.acc))


def test_build_model_refuses_dnc_sdnc_and_other_rows():
    """The DNC and the SDNC build (a plain loop; the rollback engine); the
    SDNC builds on bf16 rows too, while the dense kinds refuse them (JAX's
    dense models ignore mem_dtype); an unknown kind raises."""
    _, cfg = _configs("dam", 64)
    for kind in ("dnc", "sdnc"):
        init_p, init_s, unroll = training.build_model(
            training.ModelSpec(kind, cfg.memory, cfg.controller),
            device="cpu")
        assert isinstance(unroll, functools.partial) == (kind == "sdnc")
        assert init_s(2).memory.shape[1] == 64 + (kind == "sdnc")
    with pytest.raises(ValueError, match="unknown model kind"):
        training.build_model(training.ModelSpec("gru", cfg.memory,
                                                cfg.controller))
    bf16 = MemoryConfig(num_slots=64, word_size=W, num_heads=H,
                        mem_dtype="bfloat16")
    for kind in ("dam", "ntm", "dnc", "lstm"):
        with pytest.raises(ValueError, match="ignore mem_dtype"):
            training.build_model(training.ModelSpec(kind, bf16,
                                                    cfg.controller))
    _, init_s, _ = training.build_model(
        training.ModelSpec("sdnc", bf16, cfg.controller), device="cpu")
    assert init_s(2).memory.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="expected 'dam' or 'ntm'"):
        dense.DenseConfig(cfg.memory, cfg.controller, model="dnc")


def test_lstm_kind_takes_the_batch_size_as_its_state():
    _, cfg = _configs("dam", 64)
    init_p, init_s, unroll = training.build_model(
        training.ModelSpec("lstm", cfg.memory, cfg.controller), device="cpu")
    params = init_p(torch.Generator().manual_seed(0))
    assert set(params) == {"lstm", "out"} and init_s(B) == B
    final, ys = unroll(params, B, torch.tensor(_xs(4)))
    assert ys.shape == (T, B, OUT) and final.h.shape == (B, HIDDEN)


# --------------------------------------------------------------------------
# The converter, the module and the activation reckoning
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["dam", "ntm"])
def test_convert_dense_params_and_state(model):
    """Weights and states carry across leaf for leaf: the initial state
    and the state after three steps; the LSTM baseline's two-group tree
    converts; any other tree, and a memory with a scratch row, raise."""
    jcfg, cfg = _configs(model, 64)
    jparams = _numpy(jdense.init_params(jax.random.PRNGKey(5), jcfg))
    params = convert.params_from_jax(jparams, device="cpu")
    _leaves_close(params, jparams)
    jstate = jdense.init_state(B, jcfg)
    state = convert.dense_state_from_jax(_numpy(jstate), device="cpu")
    _leaves_close(state, _numpy(jstate))
    _leaves_close(dense.init_state(B, cfg, device="cpu"), _numpy(jstate))
    assert state.memory.shape == (B, 64, W)        # no scratch row
    j3, _ = jdense.dense_unroll(jparams, jcfg, jstate, _xs()[:3])
    state3 = convert.dense_state_from_jax(_numpy(j3), device="cpu")
    _leaves_close(state3, _numpy(j3))
    assert state3.step.dtype == torch.int32 and int(state3.step) == 3
    jl = _numpy(jdense.lstm_baseline_init(jax.random.PRNGKey(6),
                                          jcfg.controller))
    _leaves_close(convert.params_from_jax(jl, device="cpu"), jl)
    with pytest.raises(ValueError, match="expected groups"):
        convert.params_from_jax({"lstm": jl["lstm"]}, device="cpu")
    with pytest.raises(ValueError, match="expected groups"):
        convert.params_from_jax({**jl, "lsh_planes": np.zeros((1, 2, W))},
                                device="cpu")
    padded = _numpy(jstate)._replace(
        memory=np.zeros((B, 65, W), np.float32))
    with pytest.raises(ValueError, match="beside its"):
        convert.dense_state_from_jax(padded, device="cpu")


@pytest.mark.parametrize("model", ["dam", "ntm"])
def test_module_forward_is_the_functional_unroll_and_trains(model):
    _, cfg = _configs(model, 64)
    module = dense.Dense(cfg, seed=3, device="cpu")
    xs = torch.tensor(_xs(5))
    s1, ys1 = module(module.init_state(B), xs)
    assert not ys1.requires_grad
    params = dense.init_params(torch.Generator().manual_seed(3), cfg,
                               device="cpu")
    s2, ys2 = dense.dense_unroll(params, cfg,
                                 dense.init_state(B, cfg, device="cpu"), xs)
    assert torch.equal(ys1, ys2) and torch.equal(s1.memory, s2.memory)
    _, ys = dense.dense_unroll(module.params(), cfg, module.init_state(B), xs)
    (ys ** 2).sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in module.parameters())


@pytest.mark.parametrize("model", ["dam", "ntm"])
def test_activation_bytes_counts_what_autograd_keeps(model):
    """`activation_bytes` against the storages autograd saves in one step
    (beyond the previous state's and the weights'): exact in N (at N that
    `addr.READ_ROWS` divides), and an upper bound within 1 KiB for the
    small tensors."""
    saved = {}
    for N in (2 * addr.READ_ROWS, 3 * addr.READ_ROWS):
        _, cfg = _configs(model, N)
        params = dense.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
        leaves = [t.requires_grad_() for t in pytree.tree_leaves(params)]
        s = dense.init_state(B, cfg, device="cpu")
        xs = torch.tensor(_xs(6, 2))
        s, _ = dense.dense_step(params, cfg, s, xs[0])
        old = {t.untyped_storage().data_ptr()
               for t in [*pytree.tree_leaves(s), *leaves]}
        seen = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in old:
                seen[st.data_ptr()] = st.nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            dense.dense_step(params, cfg, s, xs[1])
        saved[N] = (sum(seen.values()), dense.activation_bytes(cfg, B))
    (m2, a2), (m3, a3) = (saved[2 * addr.READ_ROWS],
                          saved[3 * addr.READ_ROWS])
    assert a3 - a2 == m3 - m2
    assert 0 <= a2 - m2 <= 1024


def test_quickstart_runs_on_the_cpu(capsys):
    """`python -m repro_torch.quickstart --device cpu` at a few steps:
    trains SAM, then times SAM's and the NTM's forward and backward."""
    from repro_torch import quickstart
    out = quickstart.main(["--device", "cpu", "--steps", "3"])
    assert out["device"] == "cpu" and np.isfinite(out["loss"]).all()
    assert out["sam_ms"] > 0 and out["ntm_ms"] > 0
    assert "SAM vs dense NTM at N=4096" in capsys.readouterr().out
