"""Hymba-1.5B's hybrid family in the port's LM (`models/ssm.py`: the
causal conv, the selective scan through JAX's associative-scan recursion,
the O(1) decode; the hybrid block, sliding-window attention and the SSM
on the same normed input, averaged; the decode cache {k, v, conv, ssm})
against the JAX package, on the CPU, at `hymba_1_5b_sam`'s reduced config
(2 layers, d 128, 4 heads over 2 of head dim 32, a window of 32; the SSM
at d_inner 128, state 8, dt_rank 16, conv 4; a memory of 64 slots of 16
with K = 4 and a group per layer).

The weights come from JAX's `init_params(PRNGKey(0))`, carried across by
`convert.lm_params_from_jax`, with every SSM leaf drawn anew from a numpy
seed, the same values on both sides (`_draw_ssm_leaves`). JAX initialises
``a_log``, ``conv_b`` and ``dt_bias`` to zeros (A = -1 everywhere) and
``d_skip`` to ones, so a wrong index into any of them would pass: they
are drawn N(0, 0.5²). JAX draws a stacked matrix with the fan-in of the
stacked axis (the layer count: std 0.7 here), which makes Δ ~ 100, every
exp(Δ·A) ~ 0 and the SSM's output ~ 1e9, so its writes swamp the memory
and every read ties at K: the projections are drawn N(0, 1/fan_in) of
their own input width (`conv_w` keeps JAX's N(0, 0.5²)). The tests of the
SSM alone draw one layer's leaves by the same rule (`_ssm_params`).
Every input is made with numpy. The JAX memory ops run under their
default backend, ``ref``.

Tolerances (`tests/test_torch_rwkv.py`'s): a function within `TOL` = 1e-5
of max(1, |JAX value|) at f32; the whole slice within `SLICE_TOL` = 1e-4
of that scale; integers (positions, steps, usage, read rows, tokens)
exact; reads compared as sets with their weights, each test that runs the
memory asserting that no read has a near-tie at K. At bf16 compute a
function lies within `BF16_OP` = 2^-6 of the scale (two bf16 ulps), a
decode with memory states within `BF16_BOUND` = 0.1, and the decode's
states keep JAX's dtypes (ssm f32, conv bf16).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import engine as jengine
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.models import layers, lm, ssm

TOL = 1e-5
SLICE_TOL = 1e-4
BF16_OP = 2.0 ** -6
BF16_BOUND = 0.1
READ_MARGIN = 1e-6
ARCH = "hymba_1_5b_sam"
B = 2
D_INNER = 128
# JAX's constant-initialised leaves of the SSM, drawn here (docstring).
ZERO_LEAVES = ("a_log", "conv_b", "dt_bias", "d_skip")
# Matrices drawn N(0, 1/fan_in) of their own input width (docstring).
PROJECTIONS = ("in_proj", "x_proj", "dt_proj", "out_proj")
# The token seeds: the first of 0-39 whose reads hold no near-tie at K (a
# fresh memory's rows tie: ROADMAP §C).
PREFILL_SEED, DECODE_SEED, MEMORY_SEED = 0, 0, 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, tol=SLICE_TOL):
    """|a - b| <= tol · max(1, max |b|), elementwise."""
    a, b = _np(a), _np(b)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _t(x):
    return torch.tensor(np.array(x, dtype=np.float32))


def _configs(memory=True, compute_dtype="float32"):
    """(JAX config, port config), reduced, at ``compute_dtype``."""
    kw = dict(compute_dtype=compute_dtype)
    if not memory:
        kw["memory"] = None
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


def _ssm_leaf(name, shape, rng):
    """One SSM leaf of ``shape`` (a leading layer axis or not) from
    ``rng``: a projection N(0, 1/fan_in), fan_in its input axis
    (shape[-2]); conv_w and the constant-initialised leaves N(0, 0.5²)."""
    std = shape[-2] ** -0.5 if name in PROJECTIONS else 0.5
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _draw_ssm_leaves(jp, seed=5):
    """JAX's tree with every SSM leaf drawn from numpy (`_ssm_leaf`)."""
    rng = np.random.default_rng(seed)
    blocks = jax.tree.map(np.asarray, jp["blocks"])
    blocks["ssm"] = {name: _ssm_leaf(name, leaf.shape, rng)
                     for name, leaf in sorted(blocks["ssm"].items())}
    return dict(jp, blocks=jax.tree.map(jnp.asarray, blocks))


@functools.lru_cache(maxsize=None)
def _weights(jcfg):
    """JAX's weights of ``jcfg`` from PRNGKey(0), the SSM's leaves drawn,
    and the port's copy (one draw a config: the tests only read them)."""
    jp = _draw_ssm_leaves(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _ssm_params(cfg, seed=3, dtype=None):
    """One layer's SSM leaves from numpy (`_ssm_leaf`), on both sides, cast
    to ``dtype``."""
    rng = np.random.default_rng(seed)
    p = {name: _ssm_leaf(name, d.shape, rng)
         for name, d in sorted(ssm.ssm_defs(cfg, D_INNER).items())}
    jp, tp = ({k: jnp.asarray(v) for k, v in p.items()},
              {k: _t(v) for k, v in p.items()})
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jp)
        tp = layers.tree_map(lambda t: t.bfloat16(), tp)
    return jp, tp


def _inputs(seed, shape, dtype=None):
    """N(0, 1) of ``shape`` on both sides, cast to ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()
    return jnp.asarray(x), _t(x)


def _tokens(seed, S, n=B):
    return np.random.default_rng(seed).integers(0, 512, (n, S)).astype(
        np.int32)


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


def _assert_read_margins(reads, margin=READ_MARGIN):
    """No read has a row within ``margin`` of its K-th similarity (f64)
    that could trade places across K."""
    assert reads
    for q, mem, k, valid_n in reads:
        sims = torch.einsum("bhw,bnw->bhn", ref._normalize(q.double()),
                            ref._normalize(mem[:, :valid_n].double()))
        v = sims.sort(dim=-1, descending=True).values[..., k - 1:k]
        band = (sims - v).abs() <= margin
        straddles = (sims > v + margin).sum(-1) + band.sum(-1) > k
        assert not (straddles & (band & (sims != v)).any(-1)).any(), \
            "a read near-tie at K"


def _sorted_read(idx, w):
    idx, w = np.asarray(idx), _np(w)
    order = np.argsort(idx, axis=-1, kind="stable")
    return (np.take_along_axis(idx, order, -1),
            np.take_along_axis(w, order, -1))


def _assert_states_match(got, want, tol=SLICE_TOL):
    for g, w in zip(got, want, strict=True):
        _close(g.memory, w.memory, tol)
        _equal(g.last_access, w.last_access)
        _equal(g.step, w.step)
        g_idx, g_w = _sorted_read(g.read_idx, g.read_w)
        w_idx, w_w = _sorted_read(w.read_idx, w.read_w)
        _equal(g_idx, w_idx)
        _close(g_w, w_w, tol)


def _filled_state(st, rng, steps):
    """A JAX memory state as a session leaves it: random rows, usage and
    read history, its lanes' ``steps``."""
    batch, N = st.memory.shape[0], st.memory.shape[1] - 1
    mem = rng.standard_normal(st.memory.shape).astype(np.float32)
    mem[:, N] = 0.0
    la = np.asarray(st.last_access).copy()
    la[:, :N] = -rng.permuted(np.tile(np.arange(N), (batch, 1)), axis=1)
    idx = np.stack([rng.choice(N, st.read_idx.shape[1:], replace=False)
                    for _ in range(batch)]).astype(np.int32)
    w = rng.random(st.read_w.shape).astype(np.float32)
    return st._replace(
        memory=jnp.asarray(mem), last_access=jnp.asarray(la),
        read_idx=jnp.asarray(idx),
        read_w=jnp.asarray(w / w.sum(-1, keepdims=True)),
        step=jnp.asarray(np.array(steps, np.int32)[:, None]))


def _filled_memory_states(jcfg, seed, batch=B):
    rng = np.random.default_rng(seed)
    return tuple(_filled_state(st, rng, [5 + 4 * i for i in range(batch)])
                 for st in jlm.init_memory_states(jcfg, batch,
                                                  per_lane_step=True))


def _port_states(jm):
    return convert.lm_memory_states_from_jax(jax.tree.map(np.asarray, jm),
                                             device="cpu")


def _filled_cache(jcfg, rng, batch, max_len=16):
    """A JAX Hymba cache of ``batch`` lanes with random k, v, conv (the
    compute dtype) and ssm (f32) leaves, per-lane positions 0."""
    jc = jlm.init_cache(jcfg, batch, max_len, per_lane_pos=True)
    return {k: (v if k == "pos" else jnp.asarray(
        rng.standard_normal(v.shape), v.dtype)) for k, v in jc.items()}


# --------------------------------------------------------------------------
# The configuration, the parameter tree and the converter
# --------------------------------------------------------------------------

def test_configs_and_param_tree_match_jax():
    """The published config (and ``_sam``) and the reduced one field for
    field against JAX's (the reduced SSM override included); the full
    tree leaf for leaf (1,783,608,000 parameters with the memory, 3.57 GB
    in bf16); the cache shapes, k and v a ring of min(max_len, window)."""
    for name in (ARCH, "hymba_1_5b"):
        for got, want in ((get_config(name), jax_get_config(name)),
                          (reduced(get_config(name)),
                           jax_reduced(jax_get_config(name)))):
            want = dataclasses.asdict(want)
            if want["memory"] is not None:
                want["memory"].pop("backend")
            assert dataclasses.asdict(got) == want
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.padded_heads, full.head_dim, full.d_ff, full.vocab_size,
            full.window, full.act, full.block) == (
        32, 1600, 25, 5, 80, 64, 5504, 32001, 1024, "silu", "hybrid")
    s = full.ssm
    assert (s.state_size, s.expand, s.dt_rank, s.conv_width) == (16, 2, 100,
                                                                 4)
    small = reduced(full)
    assert (small.ssm.state_size, small.ssm.dt_rank, small.window) == (8, 16,
                                                                      32)
    jshapes = jax.tree.map(lambda t: tuple(t.shape),
                           jlm.abstract_params(jax_get_config(ARCH)))
    tshapes = jax.tree.map(lambda d: d.shape, lm.param_defs(full),
                           is_leaf=lambda d: isinstance(d, layers.ParamDef))
    assert tshapes == jshapes
    assert tshapes["blocks"]["ssm"]["x_proj"] == (32, 1600, 132)
    assert tshapes["memory"]["wq"][0] == 8
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        tshapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert n == 1_783_608_000
    assert lm.cache_shapes(full, 4, 2048) == jlm.cache_shapes(
        jax_get_config(ARCH), 4, 2048) == {
        "k": (32, 4, 1024, 5, 64), "v": (32, 4, 1024, 5, 64),
        "conv": (32, 4, 3, 1600), "ssm": (32, 4, 1600, 16)}
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    assert layers.tree_map(lambda t: tuple(t.shape), tp) == jax.tree.map(
        lambda t: tuple(t.shape), jp)
    fresh = lm.init_params(cfg, device="cpu")
    assert layers.tree_map(lambda t: tuple(t.shape), fresh) == \
        layers.tree_map(lambda t: tuple(t.shape), tp)
    assert bool((fresh["blocks"]["ssm"]["d_skip"] == 1).all())
    assert not fresh["blocks"]["ssm"]["a_log"].any()
    assert lm.cache_shapes(cfg, B, 16) == jlm.cache_shapes(jcfg, B, 16)


def test_cache_and_session_converters_take_hymba():
    """`lm_cache_from_jax` on a bf16-compute Hymba cache (k, v and conv
    bf16, ssm f32, per-lane positions) and `session_from_jax` on a
    session of one lane: bit for bit, dtypes kept, and equal in dtype and
    shape to the port's own `init_cache`."""
    jcfg, cfg = _configs(compute_dtype="bfloat16")
    rng = np.random.default_rng(3)
    jc = _filled_cache(jcfg, rng, B)
    assert jc["ssm"].dtype == jnp.float32
    assert jc["conv"].dtype == jnp.bfloat16
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    mine = lm.init_cache(cfg, B, 16, per_lane_pos=True, device="cpu")
    assert set(tc) == set(mine) == {"k", "v", "conv", "ssm", "pos"}
    for key in tc:
        assert tc[key].dtype == mine[key].dtype
        assert tc[key].shape == mine[key].shape
        _equal(_np(tc[key]), _np(jc[key]))
    sess = {"cache": {k: v[:, :1] for k, v in jc.items() if k != "pos"},
            "pos": np.array([7], np.int32), "counter": 7,
            "mem": _filled_memory_states(jcfg, 4, batch=1)}
    got = convert.session_from_jax(jax.tree.map(np.asarray, sess),
                                   device="cpu")
    assert got["counter"] == 7 and got["pos"].tolist() == [7]
    for key in ("k", "v", "conv", "ssm"):
        assert got["cache"][key].dtype == mine[key].dtype
        _equal(_np(got["cache"][key]), _np(sess["cache"][key]))
    _assert_states_match(got["mem"], sess["mem"])
    with pytest.raises(ValueError, match="cache keys"):
        convert.lm_cache_from_jax({"k": 0, "v": 0, "ssm": 0, "pos": 0})


# --------------------------------------------------------------------------
# The SSM alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 7, 64])
def test_scan_matches_jax(S):
    """`_scan_assoc` (JAX's associative-scan recursion) against JAX's
    `_scan_assoc` on a in (0, 1) and bx of N(0, 1), at one step, an odd
    length and 64: within TOL of max(1, |h|), and against the sequential
    recurrence."""
    rng = np.random.default_rng(S)
    a = rng.random((B, S, 6, 4)).astype(np.float32)
    bx = rng.standard_normal((B, S, 6, 4)).astype(np.float32)
    want = jssm._scan_assoc(jnp.asarray(a), jnp.asarray(bx))
    got = ssm._scan_assoc(_t(a), _t(bx))
    assert got.shape == (B, S, 6, 4)
    _close(got, want, TOL)
    h, seq = np.zeros((B, 6, 4), np.float64), []
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
        seq.append(h)
    _close(got, np.stack(seq, 1), TOL)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_matches_jax(dtype, carried):
    """The causal depthwise conv from zeros or a carried state: the output
    and the new state (the last K-1 inputs, in x's dtype)."""
    jw, tw = _inputs(0, (4, D_INNER), dtype)
    jb, tb = _inputs(1, (D_INNER,), dtype)
    jx, tx = _inputs(2, (B, 9, D_INNER), dtype)
    js, ts = _inputs(3, (B, 3, D_INNER), dtype) if carried else (None, None)
    want = jssm._conv1d(jx, jw, jb, js)
    got = ssm._conv1d(tx, tw, tb, ts)
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype)
        _close(g, w, TOL if dtype == "float32" else BF16_OP)


@pytest.mark.parametrize("mode", ["prefill", "carried", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_matches_jax(dtype, mode):
    """`ssm_apply` on x of N(0, 1): a prefill of 16 positions from zero
    states, one from carried conv and SSM states, and a decode step: the
    output, the conv state (x's dtype) and the SSM state (f32)."""
    jcfg, cfg = _configs()
    jp, tp = _ssm_params(cfg, dtype=dtype)
    S = 1 if mode == "decode" else 16
    jx, tx = _inputs(4, (B, S, 128), dtype)
    kw, tkw = {}, {}
    if mode != "prefill":
        jc, tc = _inputs(5, (B, 3, D_INNER), dtype)
        js, ts = _inputs(6, (B, D_INNER, 8))
        kw = dict(conv_state=jc, ssm_state=js, decode=mode == "decode")
        tkw = dict(conv_state=tc, ssm_state=ts, decode=mode == "decode")
    want = jssm.ssm_apply(jp, jcfg, jx, **kw)
    got = ssm.ssm_apply(tp, cfg, tx, **tkw)
    tol = TOL if dtype == "float32" else BF16_OP
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype)
        _close(g, w, tol)
    assert got[2].dtype == torch.float32


def test_prefill_states_equal_decode_steps():
    """As `tests/test_moe_rwkv_ssm.py`: a prefill of 12 positions gives
    the outputs and the final conv and SSM states of 12 decode steps from
    zero states (f32, within SLICE_TOL of the scale), in the port as in
    JAX, and the two agree."""
    jcfg, cfg = _configs()
    jp, tp = _ssm_params(cfg, seed=7)
    jx, tx = _inputs(8, (B, 12, 128))
    y, conv, state = ssm.ssm_apply(tp, cfg, tx)
    c = torch.zeros((B, 3, D_INNER))
    h = torch.zeros((B, D_INNER, 8))
    outs = []
    for t in range(12):
        o, c, h = ssm.ssm_apply(tp, cfg, tx[:, t:t + 1], conv_state=c,
                                ssm_state=h, decode=True)
        outs.append(o)
    _close(torch.cat(outs, 1), y)
    _close(c, conv)
    _close(h, state)
    jy, jconv, jstate = jssm.ssm_apply(jp, jcfg, jx)
    for g, w in ((y, jy), (conv, jconv), (state, jstate)):
        _close(g, w, TOL)


# --------------------------------------------------------------------------
# The whole slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("memory", [True, False])
def test_prefill_matches_jax(memory, reads):
    """`forward`'s hidden states and `prefill`'s logits on 64 tokens (two
    memory segments; the window of 32 binds), with the memory and
    without."""
    jcfg, cfg = _configs(memory=memory)
    jp, tp = _weights(jcfg)
    toks = _tokens(PREFILL_SEED, 64)
    jh, _ = jax.jit(jlm.forward, static_argnums=1)(jp, jcfg,
                                                   {"tokens": toks})
    jl = jax.jit(jlm.prefill, static_argnums=1)(jp, jcfg, {"tokens": toks})
    th, aux = lm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    tl = lm.prefill(tp, cfg, {"tokens": torch.tensor(toks)})
    assert th.shape == (B, 64, 128) and tl.shape == (B, 1, 512)
    assert float(aux) == 0.0
    _close(th, jh)
    _close(tl, jl)
    if memory:                    # 2 groups × 2 segments, in both runs
        assert len(reads) == cfg.num_layers * 2 * 2
        _assert_read_margins(reads)
    else:
        assert not reads


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_scan_with_memory_matches_jax(compute_dtype, reads):
    """12 tokens with filled memory states from a filled cache (k, v,
    conv, ssm) into a ring of 8 slots (the decode wraps it): the logits,
    the four cache leaves, the position and every memory state. At bf16
    compute one token against JAX's ``pallas-interpret`` memory ops
    (which upcast q and β as the port does): the logits and the states
    keep JAX's dtypes (ssm f32, conv bf16) and lie within `BF16_BOUND` of
    its values, the memory rows too, the steps exact."""
    jcfg, cfg = _configs(compute_dtype=compute_dtype)
    jp, tp = _weights(jcfg)
    T = 12 if compute_dtype == "float32" else 1
    if compute_dtype == "bfloat16":     # q and β upcast, as the port's
        jcfg = dataclasses.replace(jcfg, memory=dataclasses.replace(
            jcfg.memory, backend="pallas-interpret"))
    toks = _tokens(DECODE_SEED, T)
    jm = _filled_memory_states(jcfg, MEMORY_SEED)
    jc = _filled_cache(jcfg, np.random.default_rng(6), B, max_len=8)
    jc["pos"] = jnp.zeros((), jnp.int32)
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    tm = _port_states(jm)
    jl, jc, jm = jax.jit(jlm.decode_scan, static_argnums=1)(
        jp, jcfg, jc, toks, mem_states=jm)
    tl, tc, tm = lm.decode_scan(tp, cfg, tc, torch.tensor(toks),
                                mem_states=tm)
    assert len(reads) == len(tm) * T
    tol = SLICE_TOL if compute_dtype == "float32" else BF16_BOUND
    assert str(tl.dtype)[6:] == str(jl.dtype)
    _close(tl, jl, tol)
    for key in ("k", "v", "conv", "ssm"):
        assert tc[key].shape == jc[key].shape
        assert str(tc[key].dtype)[6:] == str(jc[key].dtype)
        _close(tc[key], jc[key], tol)
    assert tc["ssm"].dtype == torch.float32
    _equal(tc["pos"], jc["pos"])
    if compute_dtype == "float32":
        _assert_read_margins(reads)
        _assert_states_match(tm, jm)
        return
    # bf16: the token's write lands on the rows the filled states name on
    # both sides; its read may pick other rows where a bf16 rounding of q
    # crosses a near-tie at K (ROADMAP §C), and so stamp other usage.
    for g, w in zip(tm, jm, strict=True):
        _close(g.memory, w.memory, tol)
        _equal(g.step, w.step)


def test_engine_matches_jax():
    """The engine on 2 lanes of max_len 16 from the same sessions,
    carried across by `convert.session_from_jax`: a returning user u
    (filled k, v, conv, ssm and memory states, at position 5) asks for 3
    prompt tokens and 6 new, a neighbour from position 0 for 4; then u,
    evicted with its session, returns for 5 more, restored into another
    lane, and runs past max_len (a windowed config's ring bounds
    nothing, JAX's rule). JAX's tokens, and both final sessions (the
    cache leaves, the position, the memory states)."""
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(8)
    sessions = {}
    for user, pos in (("u", 5), ("noise", 0)):
        cache = _filled_cache(jcfg, rng, 1)
        sessions[user] = {
            "cache": {k: np.asarray(v) for k, v in cache.items()
                      if k != "pos"},
            "pos": np.array([pos], np.int32), "counter": pos,
            "mem": tuple(_filled_state(st, rng, [pos]) for st in
                         jlm.init_memory_states(jcfg, 1,
                                                per_lane_step=True))}
    prompts = {u: rng.integers(1, 512, 3).tolist() for u in sessions}

    def first(R):
        return [R(user="noise", prompt=prompts["noise"], max_new_tokens=4),
                R(user="u", prompt=prompts["u"], max_new_tokens=6)]

    def second(R):
        return [R(user="u", prompt=[11], max_new_tokens=5)]

    jstore = jengine.SessionStore(num_slots=jcfg.memory.num_slots)
    for user, sess in sessions.items():
        jstore.put(user, sess)
    je = jengine.ServeEngine(jcfg, lanes=2, max_len=16, session_store=jstore)
    je.params = jp
    te = ServeEngine(cfg, params=tp, device="cpu", lanes=2, max_len=16)
    for user, sess in sessions.items():
        te.sessions.put(user, convert.session_from_jax(
            jax.tree.map(np.asarray, sess), device="cpu"))
    for run in (first, second):
        want = {r["user"]: r["tokens"] for r in je.run(run(jengine.Request))}
        got = {r["user"]: r["tokens"] for r in te.run(run(Request))}
        assert got == want
    for user in sessions:
        port, ref_sess = te.sessions.take(user), je.sessions.take(user)
        for key in ("k", "v", "conv", "ssm"):
            assert str(port["cache"][key].dtype)[6:] == str(
                np.asarray(ref_sess["cache"][key]).dtype)
            _close(port["cache"][key], ref_sess["cache"][key])
        _equal(port["pos"], ref_sess["pos"])
        _assert_states_match(port["mem"], ref_sess["mem"])
        if user == "u":           # 5 + 3 + 6 - 1, then 1 + 5 - 1 more
            assert int(port["pos"][0]) == 18 > 16


def test_engine_window_is_not_bounded_by_max_len():
    """`max_len` does not bound a windowed config (JAX's engine.py:313):
    a request of 6 + 6 tokens in a max_len of 8 runs on both sides, the
    ring of 8 slots wrapping, with JAX's tokens."""
    jcfg, cfg = _configs(memory=False)
    jp, tp = _weights(jcfg)
    je = jengine.ServeEngine(jcfg, lanes=1, max_len=8)
    je.params = jp
    te = ServeEngine(cfg, params=tp, device="cpu", lanes=1, max_len=8)
    toks = []
    for eng, R in ((je, jengine.Request), (te, Request)):
        res = eng.run([R(user="u", prompt=[3, 1, 4, 1, 5, 9],
                         max_new_tokens=6)])
        toks.append(res[0]["tokens"])
        assert len(toks[-1]) == 6
    assert toks[0] == toks[1]


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_refusals():
    """A hybrid config without an SSM, or with another MLP, raises naming
    A9c. (`tests/test_torch_train_recurrent.py` holds the hybrid block's
    training against JAX.)"""
    _, cfg = _configs(memory=False)
    for bad in (dict(ssm=None), dict(act="gelu")):
        with pytest.raises(ValueError, match="A9c"):
            lm.param_defs(dataclasses.replace(cfg, **bad))
