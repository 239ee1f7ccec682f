"""Training of the port's LM (`repro_torch.models`, `launch/steps.py`,
`launch/train.py`, `optim/optimizers.py`, `data/tokens.py`,
`distributed/compression.py`) against the JAX package, on the CPU, at the
reduced StarCoder2-7B + SAM config (2 layers, d 128, 4 heads over 2 kv
heads, head_dim 32, a memory of 64 slots of 16 with K = 4, a memory group
per layer, segments of 32).

The same numpy inputs go to both sides; the weights and the optimizer
state come from JAX through `repro_torch.convert`. The JAX memory ops run
under their default backend, ``ref``.

Tolerances. Forward floats (losses, outputs, AdamW's parameters and
moments) within 1e-5 of max(1, |JAX value|). Gradients against JAX within
the JAX suite's sparse-against-naive bar, atol 2e-4 / rtol 1e-3
(`tests/test_unroll.py`); the port's three unroll modes against each other
within 1e-5 of max(1, |g|), the bar `chip_smoke.py` holds the card to.
Integers exact. Reads of a memory written from zero have structural
near-ties (ROADMAP §C): every test that runs a whole forward records its
reads and asserts that no near-tie straddles K (`_assert_read_margins`),
so both sides read the same rows; the train step's second step starts
from JAX's state after the first.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import unroll as junroll
from repro.data import tokens as jtokens
from repro.distributed import compression as jcomp
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import sam_layer as jsam
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.core import unroll
from repro_torch.core.types import tree_bytes
from repro_torch.data import tokens
from repro_torch.distributed import compression
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm, sam_layer
from repro_torch.models.layers import tree_map
from repro_torch.optim import optimizers as opt

TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
READ_MARGIN = 1e-6
B, S = 2, 64
ARCH = "starcoder2_7b_sam"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if str(getattr(x, "dtype", "")) == "bfloat16":
        return np.asarray(jnp.asarray(x, jnp.float32))
    return np.asarray(x)


def _close(a, b, tol=TOL):
    """|a - b| <= tol · max(1, max |b|), elementwise."""
    a, b = _np(a), _np(b).astype(np.float32)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def _grads_close(got, want):
    """Two gradient trees (dicts), leaf by leaf by key."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _grads_close(got[k], want[k])
        return
    np.testing.assert_allclose(_np(got), _np(want), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


def _modes_close(got, want):
    """The port's modes against each other: 1e-5 of max(1, |g|)."""
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                   atol=TOL * max(1.0, float(w.abs().max())))


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def _configs(compute_dtype="float32", **mem):
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jcfg = dataclasses.replace(jcfg, compute_dtype=compute_dtype,
                               memory=dataclasses.replace(jcfg.memory, **mem))
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype,
                              memory=dataclasses.replace(cfg.memory, **mem))
    return jcfg, cfg


def _with_mode(cfg, mode, chunk=None):
    return dataclasses.replace(cfg, memory=dataclasses.replace(
        cfg.memory, unroll_mode=mode, unroll_chunk=chunk))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


@pytest.fixture(scope="module")
def batch():
    # Token seed 35: the f32 forward's reads hold no near-tie at K
    # (`tests/test_torch_lm.py::tokens`; asserted again where used).
    toks = np.random.default_rng(35).integers(0, 512, (B, S)).astype(
        np.int32)
    tg = np.random.default_rng(1).integers(0, 512, (B, S)).astype(np.int32)
    mask = (np.random.default_rng(2).random((B, S)) < 0.8).astype(np.float32)
    return {"tokens": toks, "targets": tg, "mask": mask}


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture
def reads(monkeypatch):
    """Every read the port runs, as (q, memory, k, valid_n)."""
    seen = []
    fused_read = ops.fused_read

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        seen.append((q.detach().clone(), mem.detach().clone(), k, valid_n))
        return fused_read(q, mem, beta, k, valid_n=valid_n)

    monkeypatch.setattr(ops, "fused_read", record)
    return seen


def _assert_read_margins(reads):
    """No read has a row within READ_MARGIN of its K-th similarity (f64)
    that could trade places across K (rows in that band all lie in the top
    K, or are equal: equal rows are ordered by index on both sides)."""
    assert reads
    for q, mem, k, valid_n in reads:
        sims = torch.einsum("bhw,bnw->bhn", ref._normalize(q.double()),
                            ref._normalize(mem[:, :valid_n].double()))
        v = sims.sort(dim=-1, descending=True).values[..., k - 1:k]
        band = (sims - v).abs() <= READ_MARGIN
        straddles = (sims > v + READ_MARGIN).sum(-1) + band.sum(-1) > k
        assert not (straddles & (band & (sims != v)).any(-1)).any(), \
            "a read near-tie at K"


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """`jax.value_and_grad(lm.loss_fn)` at f32 compute, jitted once."""
    jcfg, _ = _configs()
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))


@pytest.fixture(scope="module")
def jax_loss_and_grads(weights, batch, jax_value_and_grad):
    (loss, metrics), grads = jax_value_and_grad(weights[0], batch)
    return loss, metrics, grads


# --------------------------------------------------------------------------
# AdamW, the schedule, the token pipeline, the int8 round trip
# --------------------------------------------------------------------------

def test_adamw_and_cosine_schedule_match_jax():
    """Three AdamW steps at the schedule's rates on a small tree: the
    parameters, both moments and the count; and the schedule over warmup,
    decay and past the end."""
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "s": {"x": (3,)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
    jp, js = params, jopt.adamw_init(params)
    tp = tree_map(_t, params)
    ts = opt.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32) * 10.0 ** (i - 1), params)
        jlr = jopt.cosine_schedule(js.count, base_lr=1e-2, warmup=2,
                                   total=10)
        tlr = opt.cosine_schedule(ts.count, base_lr=1e-2, warmup=2, total=10)
        _close(tlr, jlr)
        jp, js = jopt.adamw_update(jp, g, js, lr=jlr)
        tp, ts = opt.adamw_update(tp, tree_map(_t, g), ts, lr=tlr)
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for (kp, w) in jax.tree_util.tree_flatten_with_path(want)[0]:
                node = got
                for k in kp:
                    node = node[k.key]
                _close(node, w)
        assert int(ts.count) == int(js.count) == i + 1
    for step in (0, 1, 2, 3, 6, 10, 12):
        _close(opt.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                   base_lr=3e-4, warmup=2, total=10),
               jopt.cosine_schedule(jnp.int32(step), base_lr=3e-4, warmup=2,
                                    total=10))
    # The in-place form is the same step on the caller's tensors.
    tq = tree_map(torch.clone, tp)
    st = opt.AdamWState(mu=tree_map(torch.clone, ts.mu),
                        nu=tree_map(torch.clone, ts.nu), count=ts.count)
    g = tree_map(torch.ones_like, tp)
    want_p, want_s = opt.adamw_update(tp, g, ts, lr=1e-3)
    st = opt.adamw_update_(tq, g, st, lr=1e-3)
    for a, b in zip(pytree.tree_leaves((tq, st)),
                    pytree.tree_leaves((want_p, want_s))):
        assert torch.equal(a, b)


def test_lm_token_batches_match_jax():
    jg = jtokens.lm_token_batches(512, 3, 40, jtokens.PipelineState(seed=4))
    tg = tokens.lm_token_batches(512, 3, 40, tokens.PipelineState(seed=4))
    for _ in range(3):
        (jb, js), (tb, ts) = next(jg), next(tg)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(tb[k], jb[k])
        assert (ts.step, ts.seed) == (js.step, js.seed)


@pytest.mark.parametrize("shape", [(), (7,), (256,), (3, 257)])
def test_int8_roundtrip_matches_compiled_jax(shape):
    """Bit for bit against the compiled JAX round trip (its scale is
    max|block| · fl(1/127), ROADMAP §C); codes and scales too."""
    x = (np.random.default_rng(len(shape)).standard_normal(shape) * 3.0
         ).astype(np.float32)
    want = jax.jit(jcomp.int8_roundtrip)(x)
    got = compression.int8_roundtrip(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if shape:
        jq, js = jax.jit(jcomp.quantize_int8)(x)
        tq, ts = compression.quantize_int8(_t(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert compression.int8_roundtrip(torch.tensor([1, 2])).dtype \
        == torch.int64


# --------------------------------------------------------------------------
# Attention with a gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B_,S_,H,Hkv,D,qb,dtype", [
    (1, 64, 2, 1, 16, 16, torch.float32),
    (2, 128, 4, 2, 32, 32, torch.float32),
    (1, 96, 8, 2, 16, 64, torch.float32),       # a ragged last q block
    (1, 64, 4, 2, 32, 32, torch.bfloat16),
])
def test_flash_attention_gradient(B_, S_, H, Hkv, D, qb, dtype):
    """The Function's blockwise backward against autograd through the
    plain version, and (f32, equal blocks; ROADMAP §C) against `jax.grad`
    of `chunked_attention`."""
    rng = np.random.default_rng(S_ + H)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B_, S_, H, D), (B_, S_, Hkv, D),
                            (B_, S_, Hkv, D), (B_, S_, H, D)))
    leaves = [_t(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, q_block=qb)
    got = torch.autograd.grad(out, leaves, _t(g).to(dtype))
    plain = [t.detach().float().requires_grad_() for t in leaves]
    want = torch.autograd.grad(ref.flash_attention_ref(*plain), plain, _t(g))
    assert out.dtype == dtype and all(t.dtype == dtype for t in got)
    for a, b in zip(got, want):
        if dtype == torch.float32:
            _close(a, b, 2e-5)
        else:       # the Function upcasts once; the bars of one bf16 ulp
            _close(a, b, 2.0 ** -7)
    if dtype == torch.float32 and S_ % qb == 0:
        jg = jax.grad(lambda q_, k_, v_: jnp.sum(jattn.chunked_attention(
            q_, k_, v_, q_block=qb, kv_block=qb) * g), argnums=(0, 1, 2))(
                q, k, v)
        for a, b in zip(got, jg):
            np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL)


# --------------------------------------------------------------------------
# The memory layer through the unroll engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cell_case():
    """JAX's `LMMemoryCell` unrolled naively over 6 summaries (B = 2): the
    loss Σ ys² + Σ memory_T·R and its gradients in the parameters, the
    summaries and the initial memory."""
    jcfg, cfg = _configs()
    cell = jsam.LMMemoryCell(jcfg)
    jp = cell.init_params(jax.random.PRNGKey(1))
    pooled = np.random.default_rng(4).standard_normal(
        (6, 2, cfg.d_model)).astype(np.float32)
    R = np.random.default_rng(5).standard_normal(
        (2, 65, 16)).astype(np.float32)

    def loss(p, xs, m0):
        st = cell.init_state(2)._replace(memory=m0)
        st, ys = junroll.unroll(cell, p, st, xs, mode="naive")
        return (ys ** 2).sum() + (st.memory * R).sum()

    m0 = cell.init_state(2).memory
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(jp, pooled, m0)
    return cfg, jp, pooled, R, val, grads


def _port_cell_loss(cfg, jp, pooled, R, mode, chunk):
    p = {k: _t(v).requires_grad_() for k, v in jp.items()}
    xs = _t(pooled).requires_grad_()
    st = sam_layer.init_memory_state(cfg, 2, device="cpu")
    m0 = st.memory.clone().requires_grad_()
    st = st._replace(memory=m0.clone())
    stT, ys = unroll.unroll(sam_layer.LMMemoryCell(cfg), p, st, xs,
                            mode=mode, chunk=chunk)
    val = (ys ** 2).sum() + (stT.memory * _t(R)).sum()
    grads = torch.autograd.grad(val, [*p.values(), xs, m0])
    return val, dict(zip(p, grads[:4])), grads[4], grads[5], st


@pytest.mark.parametrize("mode,chunk", [("naive", None), ("sparse", None),
                                        ("chunked", 2), ("chunked", 4)])
def test_memory_cell_modes_match_jax(cell_case, reads, mode, chunk):
    """`LMMemoryCell` through the port's engine in each mode against
    `jax.grad` of JAX's naive unroll (`tests/test_unroll.py`'s LM case,
    with the final memory in the loss); the modes against the port's naive
    within 1e-5; the rollback leaves the initial memory bit for bit."""
    cfg, jp, pooled, R, jval, (jgp, jgx, jgm) = cell_case
    val, gp, gx, gm, st = _port_cell_loss(cfg, jp, pooled, R, mode, chunk)
    _close(val, jval)
    _grads_close(gp, dict(jgp))
    _grads_close(gx, jgx)
    _grads_close(gm, jgm)
    if mode != "naive":
        assert torch.equal(st.memory, torch.zeros_like(st.memory))
        nval, ngp, ngx, ngm, _ = _port_cell_loss(cfg, jp, pooled, R,
                                                 "naive", None)
        _modes_close([gp, gx, gm], [ngp, ngx, ngm])
    _assert_read_margins(reads)


def test_memory_layer_seq_modes_match_jax(cell_case, reads):
    """`memory_layer_seq` (segments of 8 over S = 32) in the three modes:
    outputs within 1e-5 and the gradient in x against JAX's (its LM cell
    test's loss Σ y²), and the modes against each other within 1e-5."""
    cfg, jp, *_ = cell_case
    jcfg, _ = _configs()
    x = np.random.default_rng(6).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jy, _ = jsam.memory_layer_seq(jp, jcfg, x, jsam.init_memory_state(jcfg, 2),
                                  segment=8)
    jgx = jax.grad(lambda xx: (jsam.memory_layer_seq(
        jp, jcfg, xx, jsam.init_memory_state(jcfg, 2), segment=8)[0] ** 2
    ).sum())(x)
    p = {k: _t(v) for k, v in jp.items()}
    out = {}
    for mode in ("naive", "sparse", "chunked"):
        c = _with_mode(cfg, mode, 2)
        xx = _t(x).requires_grad_()
        y, _ = sam_layer.memory_layer_seq(
            p, c, xx, sam_layer.init_memory_state(c, 2, device="cpu"),
            segment=8)
        _close(y, jy)
        out[mode] = torch.autograd.grad((y ** 2).sum(), xx)[0]
        _grads_close(out[mode], jgx)
    _modes_close([out["sparse"], out["chunked"]], [out["naive"]] * 2)
    _assert_read_margins(reads)


@pytest.mark.parametrize("mode", ["sparse", "chunked"])
def test_chained_groups_restore_the_memory(cell_case, reads, mode):
    """Two memory groups over one memory, as the LM threads it: group 2's
    unroll changes in place the buffers group 1's node kept. Both
    backwards run, in reverse order; the memory is zero again bit for bit,
    a later step from it raises, and the gradients equal the naive
    chain's within 1e-5. Group 1's backward alone, before group 2's,
    raises: the buffers do not hold its final state."""
    cfg, jp, pooled, R, *_ = cell_case
    c = _with_mode(cfg, mode, 2)

    def chain(cfg_):
        p = {k: _t(v).requires_grad_() for k, v in jp.items()}
        xs = _t(pooled).requires_grad_()
        cell = sam_layer.LMMemoryCell(cfg_)
        st = sam_layer.init_memory_state(cfg_, 2, device="cpu")
        memory = st.memory
        kw = dict(mode=cfg_.memory.unroll_mode, chunk=cfg_.memory.unroll_chunk)
        st, y1 = unroll.unroll(cell, p, st, xs[:3], **kw)
        st, y2 = unroll.unroll(cell, p, st, xs[3:] + y1.mean(0), **kw)
        val = (y2 ** 2).sum() + (st.memory * _t(R)).sum()
        return memory, st, torch.autograd.grad(val, [*p.values(), xs])

    memory, st, grads = chain(c)
    assert torch.equal(memory, torch.zeros_like(memory))
    assert st.memory is memory
    with pytest.raises(RuntimeError, match="rolled back"):
        sam_layer.memory_access(tree_map(_t, dict(jp)), c,
                                torch.zeros((2, cfg.d_model)), st)
    _, _, want = chain(_with_mode(cfg, "naive"))
    _modes_close(grads, want)
    _assert_read_margins(reads)
    p = {k: _t(v).requires_grad_() for k, v in jp.items()}
    cell = sam_layer.LMMemoryCell(c)
    st = sam_layer.init_memory_state(c, 2, device="cpu")
    kw = dict(mode=mode, chunk=2)
    st, y1 = unroll.unroll(cell, p, st, _t(pooled[:3]), **kw)
    unroll.unroll(cell, p, st, _t(pooled[3:]), **kw)
    with pytest.raises(RuntimeError, match="later unroll"):
        torch.autograd.grad(y1.sum(), list(p.values()))


def test_memory_cell_residual_bytes():
    """`step_residual_bytes` counts what a step records, and the engine's
    accounting runs on the LM cell."""
    _, cfg = _configs()
    cell = sam_layer.LMMemoryCell(cfg)
    st = cell.init_state(2, device="cpu")
    p = lm.init_params(cfg, device="cpu")
    mp = tree_map(lambda t: t[0], p["memory"])
    _, _, deltas = cell.step(mp, st, torch.randn(2, cfg.d_model),
                             collect_deltas=True)
    rec = (tree_bytes(cell.residual_state(st)) + tree_bytes(tuple(deltas)))
    assert cell.step_residual_bytes(st) == rec
    acct = unroll.residual_accounting(cell, mp, st, torch.zeros(5, 2, 128),
                                      mode="sparse")
    assert acct["residual_bytes"] == tree_bytes(st) + 5 * rec


# --------------------------------------------------------------------------
# The loss, the train step, the driver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,remat", [("sparse", False), ("naive", False),
                                        ("chunked", True)])
def test_loss_and_every_gradient_match_jax(weights, batch, jax_loss_and_grads,
                                           reads, mode, remat):
    """`loss_fn` at f32 compute and every gradient leaf against
    `jax.value_and_grad(lm.loss_fn)` (JAX in its default sparse mode), in
    each of the port's unroll modes; with ``remat`` the blocks run under
    `torch.utils.checkpoint`."""
    _, tp = weights
    jloss, jmetrics, jgrads = jax_loss_and_grads
    _, cfg = _configs()
    cfg = dataclasses.replace(_with_mode(cfg, mode, 1), remat=remat)
    loss, metrics, grads = steps.value_and_grad(tp, cfg, _tb(batch))
    _close(loss, jloss)
    _close(metrics["ce"], jmetrics["ce"])
    _grads_close(grads, jgrads)
    _assert_read_margins(reads)


def test_chunked_ce_pads_and_masks():
    """A ragged length against the loss written out: the padded tail is
    masked, as in JAX."""
    rng = np.random.default_rng(9)
    h = rng.standard_normal((2, 37, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    t = rng.integers(0, 50, (2, 37)).astype(np.int32)
    m = (rng.random((2, 37)) < 0.7).astype(np.float32)
    want = jlm.chunked_ce(w, h, t, m, 16)
    got = lm.chunked_ce(_t(w), _t(h), torch.tensor(t), _t(m), 16)
    _close(got, want)


def test_bf16_default_is_finite_with_a_memory_gradient(weights, batch):
    """The reduced config as it is (bf16 compute, sparse mode), mirroring
    `tests/test_models_smoke.py::test_sam_augmented_arch`: a finite loss,
    and a non-zero gradient reaches the memory layer's weights."""
    _, tp = weights
    cfg = reduced(get_config(ARCH))
    assert cfg.compute_dtype == "bfloat16"
    loss, _, grads = steps.value_and_grad(tp, cfg, _tb(batch))
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in pytree.tree_leaves(grads))
    assert any((g != 0).any() for g in pytree.tree_leaves(grads["memory"]))


def _with_jax_gradients(fn):
    """The port's `steps.value_and_grad` with JAX's numbers: the loss and
    gradients of ``fn`` (`jax.value_and_grad(lm.loss_fn)`) on the same
    batch."""

    def value_and_grad(params, cfg, batch_):
        (loss, metrics), grads = fn(
            tree_map(lambda t: t.numpy(), params),
            {k: v.numpy() for k, v in batch_.items()})
        to_t = lambda x: torch.tensor(np.asarray(x))
        return (to_t(loss), {k: to_t(v) for k, v in metrics.items()},
                jax.tree.map(to_t, grads))
    return value_and_grad


def _tree_close(got, want, tol=TOL):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        _close(node, w, tol)


def _two_steps(jp, batch, jcfg, tstep, jstep):
    """Two steps on each side, the second from JAX's state after the
    first; yields each step's port and JAX results."""
    js, jparams = jopt.adamw_init(jp), jp
    for _ in range(2):
        tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
        ts = convert.adamw_state_from_jax(jax.tree.map(np.asarray, js),
                                          device="cpu")
        jparams, js, jm = jstep(jparams, js, batch)
        tp, ts, tm = tstep(tp, ts, _tb(batch))
        yield (tp, ts, tm), (jparams, js, jm)


@pytest.mark.parametrize("accum,compress", [(1, False), (2, True)])
def test_train_step_matches_jax(weights, batch, jax_value_and_grad,
                                monkeypatch, accum, compress):
    """`make_train_step` against JAX's jitted step at a real rate (1e-2
    after one warmup step): ``accum`` microbatches, the int8 round trip,
    clipping, the schedule and AdamW, two steps (the second from JAX's
    weights and optimizer state, `convert.adamw_state_from_jax`), with
    each microbatch's gradient JAX's own. Parameters, moments and metrics
    within 1e-5. (The port's own gradients are held to JAX's in
    `test_loss_and_every_gradient_match_jax`, and a whole step on them in
    `test_train_step_on_its_own_gradients`.)"""
    jp, _ = weights
    jcfg, cfg = _configs()
    kw = dict(lr=1e-2, accum=accum, warmup=1, total_steps=4,
              compress_pod_grads=compress)
    monkeypatch.setattr(steps, "value_and_grad",
                        _with_jax_gradients(jax_value_and_grad))
    for (tp, ts, tm), (jparams, js, jm) in _two_steps(
            jp, batch, jcfg, steps.make_train_step(cfg, **kw),
            jax.jit(jsteps.make_train_step(jcfg, **kw))):
        for k in ("loss", "grad_norm", "lr", "ce"):
            _close(tm[k], jm[k])
        _tree_close(tp, jparams)
        _tree_close(ts.mu, js.mu)
        _tree_close(ts.nu, js.nu)
        assert int(ts.count) == int(js.count)


def test_train_step_on_its_own_gradients(weights, batch, reads):
    """The whole step on the port's gradients, at JAX's default schedule
    (rate 3e-4, 100 warmup steps): parameters within 1e-5, the moments and
    the gradient norm within the gradient bar, the other metrics within
    1e-5. AdamW's step m̂/(√v̂ + ε)
    divides a gradient element by its own size, so where the gradient
    cancels to near zero the two sides' drift (within the gradient bar)
    becomes a different step: at a rate of 1e-2 one element of wq moves
    1.3e-4 apart (JAX's gradient -2.6e-8, the port's -7.0e-7; ROADMAP
    §C). At the default warmup's rates the step stays within 1e-5."""
    jp, _ = weights
    jcfg, cfg = _configs()
    for (tp, ts, tm), (jparams, js, jm) in _two_steps(
            jp, batch, jcfg, steps.make_train_step(cfg),
            jax.jit(jsteps.make_train_step(jcfg))):
        for k in ("loss", "lr", "ce"):
            _close(tm[k], jm[k])
        _grads_close(tm["grad_norm"], jm["grad_norm"])
        _tree_close(tp, jparams)
        _grads_close(ts.mu, dict(js.mu))
        _grads_close(ts.nu, dict(js.nu))
    _assert_read_margins(reads)


def test_train_losses_match_jax(monkeypatch, reads):
    """`train()` for 3 steps (B = 1, S = 64, f32 compute) from JAX's
    weights against JAX's `train()`: the logged losses and rates within
    1e-5, the gradient norms within the gradient bar (a norm of the
    gradient, which drifts within it: 1.5e-5 relative here)."""
    f32 = lambda cfg: dataclasses.replace(cfg, compute_dtype="float32")
    monkeypatch.setattr(jtrain, "reduce_cfg",
                        lambda cfg: f32(jax_reduced(cfg)))
    monkeypatch.setattr(ttrain, "reduce_cfg", lambda cfg: f32(reduced(cfg)))
    # B = 1: from JAX's weights and `lm_token_batches`' seed 0, B = 2 at
    # S = 64 reads near a tie at K within the three steps; B = 1 does not
    # (asserted).
    kw = dict(steps=3, batch=1, seq=64, log_every=1)
    _, jlog = jtrain.train(ARCH, **kw)
    jcfg = f32(jax_reduced(jax_get_config(ARCH)))
    tp = convert.lm_params_from_jax(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    (params, opt_state), tlog = ttrain.train(ARCH, device="cpu", params=tp,
                                             **kw)
    assert [i for i, _ in tlog] == [i for i, _ in jlog] == [0, 1, 2]
    for (_, tm), (_, jm) in zip(tlog, jlog):
        for k in ("loss", "lr"):
            _close(torch.tensor(tm[k]), np.float32(jm[k]))
        _grads_close(torch.tensor(tm["grad_norm"]), np.float32(jm["grad_norm"]))
    assert int(opt_state.count) == 3
    _assert_read_margins(reads)


def test_train_refusals(tmp_path):
    """A mesh (A11) and an architecture not ported (A9c) are refused. A
    checkpoint directory, refused until A10b was ported, now runs the
    steps under `ResilientLoop` and leaves the final step on disk
    (`tests/test_torch_fault_tolerance.py` holds it in full)."""
    with pytest.raises(NotImplementedError, match="A11"):
        ttrain.train(ARCH, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        ttrain.train(ARCH, mesh=object(), ckpt_dir=str(tmp_path),
                     device="cpu")
    ttrain.train(ARCH, ckpt_dir=str(tmp_path), steps=1, batch=1, seq=64,
                 device="cpu")
    assert latest_step(str(tmp_path)) == 0
    with pytest.raises(ValueError, match="A9c"):
        ttrain.train("yi_34b", device="cpu")
