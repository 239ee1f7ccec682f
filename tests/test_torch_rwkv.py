"""RWKV-6's family in the port's LM (`models/rwkv.py`: the time-mix with
its data-dependent lerp and decay, the WKV recurrence, the squared-ReLU
channel-mix; the O(1) decode state {tm_shift, wkv, cm_shift}) against the
JAX package, on the CPU, at `rwkv6_7b_sam`'s reduced config (2 layers, d
128, head_size 32 so 4 heads, decay_lora 16, mix_lora 8, d_ff 256; a
memory of 64 slots of 16 with K = 4 and a group per layer).

The weights come from JAX's `init_params(PRNGKey(0))`, carried across by
`convert.lm_params_from_jax`. JAX initialises the lerp's ``mu_*``,
``mix_b``, ``decay_base``, ``decay_b``, ``bonus``, ``ln_x``, ``mu_k2``
and ``mu_r2`` to zeros, so at init the lerp's and the decay's LoRAs and
the bonus change nothing and a wrong split order or a wrong ``mix_b``
block would pass: every test here draws those leaves from a numpy seed
(`_draw_zero_leaves`, the same values on both sides). Every input is
made with numpy. The JAX memory ops run under their default backend,
``ref``.

Tolerances (`tests/test_torch_llama4.py`'s): a function of the block
within `TOL` = 1e-5 of max(1, |JAX value|) at f32; the whole slice
within `SLICE_TOL` = 1e-4 of that scale; integers (positions, steps,
usage, read rows, tokens) exact; reads compared as sets with their
weights, each test that runs the memory asserting that no read has a
near-tie at K. At bf16 compute a function lies within `BF16_OP` = 2^-6
of the scale, two bf16 ulps (`tests/test_torch_lm.py`'s bar for a block:
each side rounds its bf16 intermediates once, after sums in other
orders), a decode with memory states within `BF16_BOUND` = 0.1 (its bar
for a bf16 slice), and the decode's states keep JAX's dtypes (wkv f32).
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
from repro.models import rwkv as jrwkv
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.models import layers, lm, rwkv

TOL = 1e-5
SLICE_TOL = 1e-4
BF16_OP = 2.0 ** -6
BF16_BOUND = 0.1
READ_MARGIN = 1e-6
ARCH = "rwkv6_7b_sam"
B = 2
# JAX's zero-initialised leaves of a block, drawn here (module docstring).
ZERO_LEAVES = {"tm": ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_x",
                      "mix_b", "decay_base", "decay_b", "bonus", "ln_x"),
               "cm": ("mu_k2", "mu_r2")}
# The token seeds: the first of 0-39 whose reads hold no near-tie at K (a
# fresh memory's rows tie: ROADMAP §C).
PREFILL_SEED, DECODE_SEED, MEMORY_SEED = 1, 0, 2


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


def _draw_zero_leaves(jp, seed=5):
    """JAX's tree with every zero-initialised RWKV leaf drawn from numpy:
    the lerp's μ in [0, 1), the others N(0, 0.5²)."""
    rng = np.random.default_rng(seed)
    blocks = jax.tree.map(np.asarray, jp["blocks"])
    for group, names in ZERO_LEAVES.items():
        for name in names:
            shape = blocks[group][name].shape
            draw = rng.random(shape) if name.startswith("mu_") \
                else 0.5 * rng.standard_normal(shape)
            blocks[group][name] = draw.astype(np.float32)
    return dict(jp, blocks=jax.tree.map(jnp.asarray, blocks))


@functools.lru_cache(maxsize=None)
def _weights(jcfg):
    """JAX's weights of ``jcfg`` from PRNGKey(0), zero leaves drawn, and
    the port's copy (one draw a config: the tests only read them)."""
    jp = _draw_zero_leaves(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _tokens(seed, S, n=B):
    return np.random.default_rng(seed).integers(0, 512, (n, S)).astype(
        np.int32)


def _layer0(jp, tp, group, dtype=None):
    """Layer 0's ``group`` leaves on both sides, cast to ``dtype``."""
    jg = jax.tree.map(lambda t: t[0], jp["blocks"][group])
    tg = layers.tree_map(lambda t: t[0], tp["blocks"][group])
    if dtype == "bfloat16":
        jg = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jg)
        tg = layers.tree_map(lambda t: t.bfloat16(), tg)
    return jg, tg


def _inputs(seed, shape, dtype=None):
    """N(0, 1) of ``shape`` on both sides, cast to ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()
    return jnp.asarray(x), _t(x)


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
    """A JAX RWKV cache of ``batch`` lanes with random states (wkv f32,
    the shifts in the compute dtype), per-lane positions 0."""
    jc = jlm.init_cache(jcfg, batch, max_len, per_lane_pos=True)
    return {k: (v if k == "pos" else jnp.asarray(
        rng.standard_normal(v.shape), v.dtype)) for k, v in jc.items()}


# --------------------------------------------------------------------------
# The configuration, the parameter tree and the converter
# --------------------------------------------------------------------------

def test_configs_and_param_tree_match_jax():
    """The published config (and ``_sam``) and the reduced one field for
    field against JAX's (the reduced RWKV override included); the full
    tree leaf for leaf (7.7 B parameters, ``mix_b`` at its (160, 20480));
    the reduced tree and the cache shapes, of no length."""
    for name in (ARCH, "rwkv6_7b"):
        for got, want in ((get_config(name), jax_get_config(name)),
                          (reduced(get_config(name)),
                           jax_reduced(jax_get_config(name)))):
            want = dataclasses.asdict(want)
            if want["memory"] is not None:
                want["memory"].pop("backend")
            assert dataclasses.asdict(got) == want
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.d_ff, full.vocab_size,
            full.block, full.act, full.rwkv.head_size, full.rwkv.decay_lora,
            full.rwkv.mix_lora) == (32, 4096, 14336, 65536, "rwkv",
                                    "relu_sq", 64, 64, 32)
    small = reduced(full)
    assert (small.rwkv.head_size, small.rwkv.decay_lora,
            small.rwkv.mix_lora) == (32, 16, 8)
    jshapes = jax.tree.map(lambda t: tuple(t.shape),
                           jlm.abstract_params(jax_get_config(ARCH)))
    tshapes = jax.tree.map(lambda d: d.shape, lm.param_defs(full),
                           is_leaf=lambda d: isinstance(d, layers.ParamDef))
    assert tshapes == jshapes and "attn" not in tshapes["blocks"]
    assert tshapes["blocks"]["tm"]["mix_b"] == (32, 160, 20480)
    assert tshapes["memory"]["wq"][0] == 8
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        tshapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert 7.6e9 < n < 7.8e9
    assert lm.cache_shapes(full, 4, 128) == jlm.cache_shapes(
        jax_get_config(ARCH), 4, 128) == {
        "tm_shift": (32, 4, 4096), "wkv": (32, 4, 64, 64, 64),
        "cm_shift": (32, 4, 4096)}
    jcfg, cfg = _configs()
    jp, tp = _weights(jcfg)
    assert layers.tree_map(lambda t: tuple(t.shape), tp) == jax.tree.map(
        lambda t: tuple(t.shape), jp)
    fresh = layers.tree_map(lambda t: tuple(t.shape),
                            lm.init_params(cfg, device="cpu"))
    assert fresh == layers.tree_map(lambda t: tuple(t.shape), tp)
    assert lm.cache_shapes(cfg, B, 16) == jlm.cache_shapes(jcfg, B, 16)
    assert lm.cache_shapes(cfg, B, 16) == lm.cache_shapes(cfg, B, 4096)


def test_cache_and_session_converters_take_rwkv():
    """`lm_cache_from_jax` on a bf16-compute RWKV cache (wkv f32, the
    shifts bf16, per-lane positions) and `session_from_jax` on a session
    of one lane: bit for bit, dtypes kept, and equal in dtype and shape to
    the port's own `init_cache`."""
    jcfg, cfg = _configs(compute_dtype="bfloat16")
    rng = np.random.default_rng(3)
    jc = _filled_cache(jcfg, rng, B)
    assert jc["wkv"].dtype == jnp.float32
    assert jc["tm_shift"].dtype == jnp.bfloat16
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    mine = lm.init_cache(cfg, B, 16, per_lane_pos=True, device="cpu")
    assert set(tc) == set(mine) == {"tm_shift", "wkv", "cm_shift", "pos"}
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
    for key in ("tm_shift", "wkv", "cm_shift"):
        assert got["cache"][key].dtype == mine[key].dtype
        _equal(_np(got["cache"][key]), _np(sess["cache"][key]))
    _assert_states_match(got["mem"], sess["mem"])
    with pytest.raises(ValueError, match="cache keys"):
        convert.lm_cache_from_jax({"tm_shift": 0, "wkv": 0, "pos": 0})


# --------------------------------------------------------------------------
# The block's functions, zero leaves drawn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddlerp_matches_jax(dtype):
    """`_ddlerp`'s five outputs, in JAX's order (xw, xk, xv, xr, xg), on
    x and a shifted x of N(0, 1)."""
    jcfg, _ = _configs()
    jp, tp = _layer0(*_weights(jcfg), "tm", dtype)
    jx, tx = _inputs(0, (B, 16, 128), dtype)
    jxs, txs = _inputs(1, (B, 16, 128), dtype)
    want = jrwkv._ddlerp(jp, jx, jxs)
    got = rwkv._ddlerp(tp, tx, txs)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype)
        _close(g, w, TOL if dtype == "float32" else BF16_OP)


def test_mix_b_reads_only_its_diagonal_blocks():
    """JAX's ``mix_b`` is (5·ml, 5·d) and `_ddlerp` reads only its five
    diagonal (ml, d) blocks (ROADMAP §C): filling the rest with junk
    changes neither side, and the two still agree."""
    jcfg, _ = _configs()
    jp, tp = _layer0(*_weights(jcfg), "tm")
    ml, d = 8, 128
    diag = np.zeros((5 * ml, 5 * d), bool)
    for i in range(5):
        diag[i * ml:(i + 1) * ml, i * d:(i + 1) * d] = True
    junk = np.where(diag, np.asarray(jp["mix_b"]), 7.0).astype(np.float32)
    jx, tx = _inputs(0, (B, 16, 128))
    jxs, txs = _inputs(1, (B, 16, 128))
    want = jrwkv._ddlerp(jp, jx, jxs)
    want_junk = jrwkv._ddlerp(dict(jp, mix_b=jnp.asarray(junk)), jx, jxs)
    got = rwkv._ddlerp(tp, tx, txs)
    got_junk = rwkv._ddlerp(dict(tp, mix_b=torch.tensor(junk)), tx, txs)
    for g, gj, w, wj in zip(got, got_junk, want, want_junk):
        _equal(_np(wj), _np(w))
        _equal(gj.numpy(), g.numpy())
        _close(g, w, TOL)


@pytest.mark.parametrize("fixed_order", [False, True])
def test_wkv_scan_matches_jax(fixed_order):
    """`wkv_scan` on 24 steps of r, k, v of N(0, 1), a decay in (0.5, 1),
    a bonus of N(0, 1) and a filled state: the outputs and the final
    state, with the batched read-out and with the decode's fixed-order
    one; the state passed in is not written."""
    rng = np.random.default_rng(7)
    r, k, v = (rng.standard_normal((B, 24, 4, 32)).astype(np.float32)
               for _ in range(3))
    w = (0.5 + 0.5 * rng.random((B, 24, 4, 32))).astype(np.float32)
    u = rng.standard_normal((4, 32)).astype(np.float32)
    s0 = rng.standard_normal((B, 4, 32, 32)).astype(np.float32)
    want_out, want_s = jrwkv.wkv_scan(r, k, v, w, u, s0)
    state = _t(s0)
    got_out, got_s = rwkv.wkv_scan(_t(r), _t(k), _t(v), _t(w), _t(u), state,
                                   fixed_order=fixed_order)
    assert got_out.shape == (B, 24, 4, 32) and got_s.dtype == torch.float32
    _close(got_out, want_out, TOL)
    _close(got_s, want_s, TOL)
    _equal(state.numpy(), s0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_matches_jax(dtype):
    """`time_mix` on 16 positions from a filled shift and WKV state: the
    output, the new shift and the new WKV state (f32 whatever the
    compute dtype)."""
    jcfg, cfg = _configs()
    jp, tp = _layer0(*_weights(jcfg), "tm", dtype)
    jx, tx = _inputs(0, (B, 16, 128), dtype)
    jsh, tsh = _inputs(1, (B, 128), dtype)
    js0, ts0 = _inputs(2, (B, 4, 32, 32))
    want = jrwkv.time_mix(jp, jcfg, jx, jsh, js0)
    got = rwkv.time_mix(tp, cfg, tx, tsh, ts0)
    tol = TOL if dtype == "float32" else BF16_OP
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype)
        _close(g, w, tol)
    assert got[2].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype):
    """`channel_mix` on 16 positions from a filled shift: the output and
    the new shift."""
    jcfg, cfg = _configs()
    jp, tp = _layer0(*_weights(jcfg), "cm", dtype)
    jx, tx = _inputs(3, (B, 16, 128), dtype)
    jsh, tsh = _inputs(4, (B, 128), dtype)
    want = jrwkv.channel_mix(jp, jcfg, jx, jsh)
    got = rwkv.channel_mix(tp, cfg, tx, tsh)
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(w.dtype)
        _close(g, w, TOL if dtype == "float32" else BF16_OP)


# --------------------------------------------------------------------------
# The whole slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("memory", [True, False])
def test_prefill_matches_jax(memory, reads):
    """`forward`'s hidden states and `prefill`'s logits on 64 tokens (two
    memory segments), with the memory and without."""
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
    """12 tokens with filled memory states from filled RWKV states: the
    logits, the three state leaves, the position and every memory state.
    At bf16 compute one token against JAX's ``pallas-interpret`` memory
    ops (which upcast q and β as the port does): the logits and the
    states keep JAX's dtypes (wkv f32, the shifts bf16) and lie within
    `BF16_BOUND` of its values (`tests/test_torch_lm.py`'s bar for a bf16
    slice), the memory rows too, the steps exact."""
    jcfg, cfg = _configs(compute_dtype=compute_dtype)
    jp, tp = _weights(jcfg)
    T = 12 if compute_dtype == "float32" else 1
    if compute_dtype == "bfloat16":     # q and β upcast, as the port's
        jcfg = dataclasses.replace(jcfg, memory=dataclasses.replace(
            jcfg.memory, backend="pallas-interpret"))
    toks = _tokens(DECODE_SEED, T)
    jm = _filled_memory_states(jcfg, MEMORY_SEED)
    jc = _filled_cache(jcfg, np.random.default_rng(6), B)
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
    for key in ("tm_shift", "wkv", "cm_shift"):
        assert tc[key].shape == jc[key].shape
        assert str(tc[key].dtype)[6:] == str(jc[key].dtype)
        _close(tc[key], jc[key], tol)
    assert tc["wkv"].dtype == torch.float32
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
    """The engine on 2 lanes of max_len 16 from the same sessions: a
    returning user u (filled RWKV and memory states, at position 5) asks
    for 3 prompt tokens and 6 new, a neighbour from position 0 for 4; then
    u, evicted with its session, returns for 2 more, restored into
    another lane. JAX's tokens, and both final sessions (the three state
    leaves, the position, the memory states)."""
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
        return [R(user="u", prompt=[11], max_new_tokens=2)]

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
        for key in ("tm_shift", "wkv", "cm_shift"):
            _close(port["cache"][key], ref_sess["cache"][key])
        _equal(port["pos"], ref_sess["pos"])
        _assert_states_match(port["mem"], ref_sess["mem"])
    assert int(port["pos"][0]) == 3 + 4 - 1      # noise: prompt + new - 1


# --------------------------------------------------------------------------
# The reference's quirks, copied on purpose (ROADMAP §C), and refusals
# --------------------------------------------------------------------------

def test_engine_max_len_bounds_rwkv_as_jax():
    """RWKV keeps no positional cache, but the engine's ``max_len`` still
    bounds a session, on both sides: a request of 6 + 6 tokens in a
    max_len of 8 raises, and the lane is freed."""
    jcfg, cfg = _configs(memory=False)
    jp, tp = _weights(jcfg)
    je = jengine.ServeEngine(jcfg, lanes=1, max_len=8)
    te = ServeEngine(cfg, params=tp, device="cpu", lanes=1, max_len=8)
    for eng, R in ((je, jengine.Request), (te, Request)):
        eng.submit(R(user="u", prompt=[1] * 6, max_new_tokens=6))
        with pytest.raises(ValueError, match="max_len=8"):
            eng.step()
        assert not eng.scheduler.active


def test_refusals():
    """A hybrid block needs an SSM and the gated SiLU MLP, so the RWKV
    config with block="hybrid" raises, naming A9c; so does another MLP;
    Hymba's registry entry loads. (`tests/test_torch_train_recurrent.py`
    holds RWKV's and Hymba's training against JAX.)"""
    _, cfg = _configs(memory=False)
    with pytest.raises(ValueError, match="A9c"):
        lm.param_defs(dataclasses.replace(cfg, block="hybrid"))
    with pytest.raises(ValueError, match="A9c"):
        lm.param_defs(dataclasses.replace(cfg, act="gelu"))
    for name in ("hymba_1_5b", "hymba_1_5b_sam"):
        assert get_config(name).block == "hybrid"
