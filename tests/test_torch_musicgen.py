"""MusicGen-medium's family in the port's LM (the stubbed audio frontend:
frame embeddings in place of tokens; MHA with pad heads at head dim 64,
the GELU MLP) against the JAX package, on the CPU, at f32 compute, at
`musicgen_medium_sam`'s reduced config (2 layers, d 128, 4 heads over 2,
head dim 32, no pad heads; a memory of 64 slots of 16 with K = 4 and a
group per layer) and in a ``padded`` variant of it with the full
config's head groups (4 MHA heads padded to 8: groups of 2, 1 real; the
full config's 24 heads padded to 48).

The weights come from JAX's `init_params(PRNGKey(0))`, carried across by
`convert.lm_params_from_jax`; every input is made with numpy, frames of
N(0, 1). The JAX memory ops run under their default backend, ``ref``.

Tolerances (`tests/test_torch_llama4.py`'s): the whole slice within
`SLICE_TOL` = 1e-4 of max(1, |JAX value|); integers (positions, steps,
usage, read rows, tokens) exact; reads compared as sets with their
weights, each test that runs the memory asserting that no read has a
near-tie at K.
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
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import layers, lm

SLICE_TOL = 1e-4
READ_MARGIN = 1e-6
ARCH = "musicgen_medium_sam"
B = 2
VARIANTS = {"jax": {}, "padded": dict(num_heads=4, num_kv_heads=4,
                                      pad_head_groups=2)}
# The frame seeds: the first of 0-39 whose reads hold no near-tie at K in
# both variants (a fresh memory's rows tie: ROADMAP §C).
PREFILL_SEED, DECODE_SEED, MEMORY_SEED = 12, 0, 2


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


def _configs(variant="jax", memory=True):
    """(JAX config, port config) of ``variant`` at f32 compute."""
    kw = dict(compute_dtype="float32", **VARIANTS[variant])
    if not memory:
        kw["memory"] = None
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


@functools.lru_cache(maxsize=None)
def _weights(jcfg):
    """JAX's weights of ``jcfg`` from PRNGKey(0) and the port's copy (one
    draw a config: the tests only read them)."""
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _frames(seed, S, n=B):
    return np.random.default_rng(seed).standard_normal((n, S, 128)).astype(
        np.float32)


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    """(variant, JAX config, port config, JAX weights, port weights)."""
    jcfg, cfg = _configs(request.param)
    return (request.param, jcfg, cfg, *_weights(jcfg))


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
    that could trade places across K."""
    assert reads
    for q, mem, k, valid_n in reads:
        sims = torch.einsum("bhw,bnw->bhn", ref._normalize(q.double()),
                            ref._normalize(mem[:, :valid_n].double()))
        v = sims.sort(dim=-1, descending=True).values[..., k - 1:k]
        band = (sims - v).abs() <= READ_MARGIN
        straddles = (sims > v + READ_MARGIN).sum(-1) + band.sum(-1) > k
        assert not (straddles & (band & (sims != v)).any(-1)).any(), \
            "a read near-tie at K"


def _sorted_read(idx, w):
    idx, w = np.asarray(idx), _np(w)
    order = np.argsort(idx, axis=-1, kind="stable")
    return (np.take_along_axis(idx, order, -1),
            np.take_along_axis(w, order, -1))


def _assert_states_match(got, want):
    for g, w in zip(got, want, strict=True):
        _close(g.memory, w.memory)
        _equal(g.last_access, w.last_access)
        _equal(g.step, w.step)
        g_idx, g_w = _sorted_read(g.read_idx, g.read_w)
        w_idx, w_w = _sorted_read(w.read_idx, w.read_w)
        _equal(g_idx, w_idx)
        _close(g_w, w_w)


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


def _filled_memory_states(jcfg, seed):
    rng = np.random.default_rng(seed)
    return tuple(_filled_state(st, rng, [5 + 4 * i for i in range(B)])
                 for st in jlm.init_memory_states(jcfg, B,
                                                  per_lane_step=True))


# --------------------------------------------------------------------------
# The configuration and the parameter tree
# --------------------------------------------------------------------------

def test_configs_and_param_tree_match_jax():
    """The published config (and ``_sam``) and the reduced one field for
    field against JAX's; the full tree leaf for leaf (``embed`` kept,
    unused, as in JAX; wq and wo at 48 padded heads; 1.6 B parameters);
    the variants' trees and caches."""
    for name in (ARCH, "musicgen_medium"):
        for got, want in ((get_config(name), jax_get_config(name)),
                          (reduced(get_config(name)),
                           jax_reduced(jax_get_config(name)))):
            want = dataclasses.asdict(want)
            if want["memory"] is not None:
                want["memory"].pop("backend")
            assert dataclasses.asdict(got) == want
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.act,
            full.frontend, full.padded_heads) == \
        (48, 1536, 24, 24, 64, 6144, 2048, "gelu", "audio", 48)
    jshapes = jax.tree.map(lambda t: tuple(t.shape),
                           jlm.abstract_params(jax_get_config(ARCH)))
    tshapes = jax.tree.map(lambda d: d.shape, lm.param_defs(full),
                           is_leaf=lambda d: isinstance(d, layers.ParamDef))
    assert tshapes == jshapes
    assert tshapes["embed"]["tok"] == (2048, 1536)
    assert tshapes["blocks"]["attn"]["wq"] == (48, 1536, 48, 64)
    assert tshapes["memory"]["wq"][0] == 12
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        tshapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert 1.5e9 < n < 1.7e9
    assert lm.cache_shapes(full, 4, 128) == jlm.cache_shapes(
        jax_get_config(ARCH), 4, 128) == {"k": (48, 4, 128, 24, 64),
                                          "v": (48, 4, 128, 24, 64)}
    for variant in VARIANTS:
        jcfg, cfg = _configs(variant)
        jp, tp = _weights(jcfg)
        assert layers.tree_map(lambda t: tuple(t.shape), tp) == \
            jax.tree.map(lambda t: tuple(t.shape), jp)
        assert cfg.padded_heads == {"jax": 4, "padded": 8}[variant]
        assert lm.cache_shapes(cfg, B, 16) == jlm.cache_shapes(jcfg, B, 16)


# --------------------------------------------------------------------------
# The whole slice on frames
# --------------------------------------------------------------------------

@pytest.mark.parametrize("memory", [True, False])
def test_prefill_on_frames_matches_jax(models, memory, reads):
    """`forward`'s hidden states and `prefill`'s logits on 64 frames (two
    memory segments), with the memory and without: the batch holds no
    tokens; in the padded variant the pad heads' weights change
    nothing."""
    variant, jcfg, cfg, jp, tp = models
    if not memory:
        jcfg, cfg = (dataclasses.replace(c, memory=None) for c in (jcfg, cfg))
        jp = {k: v for k, v in jp.items() if k != "memory"}
        tp = {k: v for k, v in tp.items() if k != "memory"}
    frames = _frames(PREFILL_SEED, 64)
    jh, _ = jax.jit(jlm.forward, static_argnums=1)(
        jp, jcfg, {"frame_embeds": frames})
    jl = jax.jit(jlm.prefill, static_argnums=1)(jp, jcfg,
                                                {"frame_embeds": frames})
    batch = {"frame_embeds": torch.tensor(frames)}
    th, _ = lm.forward(tp, cfg, batch)
    tl = lm.prefill(tp, cfg, batch)
    assert th.shape == (B, 64, 128) and tl.shape == (B, 1, 512)
    _close(th, jh)
    _close(tl, jl)
    if memory:                    # 2 groups × 2 segments, in both runs
        assert len(reads) == 2 * 2 * 2
        _assert_read_margins(reads)
    else:
        assert not reads
    if variant == "padded":
        attn = tp["blocks"]["attn"]
        pad = torch.tensor([1, 3, 5, 7])              # each group's second
        junk = dict(tp, blocks=dict(tp["blocks"], attn=dict(
            attn, wo=attn["wo"].clone().index_fill_(1, pad, 7.0))))
        _equal(lm.forward(junk, cfg, batch)[0].numpy(), th.numpy())


def test_decode_scan_on_frames_with_memory_matches_jax(models, reads):
    """12 frames (B, 12, d) with filled memory states into a cache of
    max_len 16: the logits, the k and v caches, the position and every
    memory state (reads as sets)."""
    _, jcfg, cfg, jp, tp = models
    frames = _frames(DECODE_SEED, 12)
    jm = _filled_memory_states(jcfg, MEMORY_SEED)
    tm = convert.lm_memory_states_from_jax(jax.tree.map(np.asarray, jm),
                                           device="cpu")
    jl, jc, jm = jax.jit(jlm.decode_scan, static_argnums=1)(
        jp, jcfg, jlm.init_cache(jcfg, B, 16), frames, mem_states=jm)
    tl, tc, tm = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 16,
                                                       device="cpu"),
                                torch.tensor(frames), mem_states=tm)
    _close(tl, jl)
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        _close(tc[key], jc[key])
    _equal(tc["pos"], jc["pos"])
    _assert_states_match(tm, jm)
    assert len(reads) == len(tm) * 12
    _assert_read_margins(reads)


# --------------------------------------------------------------------------
# `serve`'s one-hot feed, a quirk of the reference copied on purpose
# --------------------------------------------------------------------------

def test_serve_one_hot_feed_matches_jax():
    """`serve` on frames: JAX's prompt (normal frames from its key) and 8
    greedy tokens, each fed back as ``one_hot(token, d_model)``; the
    reduced vocabulary (512) is larger than d_model (128), as MusicGen's
    2048 is than its 1536, and a token of 128 or more feeds a zero frame
    (ROADMAP §C): such tokens are among those chosen, and `one_hot` is
    JAX's on both sides of d_model."""
    jcfg, cfg = _configs("padded", memory=False)
    _, tp = _weights(jcfg)
    kw = dict(batch=B, prompt_len=8, gen_len=8, max_len=16, seed=0)
    want = np.asarray(jserve._serve(jcfg, **kw)["tokens"])
    prompt = jax.random.normal(jax.random.PRNGKey(0), (B, 8, 128))
    got = tserve._serve(cfg, **kw, device="cpu", params=tp,
                        prompt=torch.tensor(np.asarray(prompt)))
    _equal(got["tokens"], want)
    assert (want[:, :-1] >= 128).any()
    tok = np.array([0, 5, 127, 128, 511, 2047], np.int32)
    feed = tserve.one_hot(torch.tensor(tok), 128)
    _equal(feed.numpy(), np.asarray(jax.nn.one_hot(tok, 128)))
    assert feed.dtype == torch.float32 and not feed[3:].any()


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_engine_and_trainer_refuse_audio():
    """The engine feeds token ids, on both sides (JAX refuses audio at
    construction), so `serve_continuous` refuses too. The trainer trains
    an audio config on frames (`tests/test_torch_train_frontends.py`
    holds it against JAX)."""
    jcfg, cfg = _configs(memory=False)
    with pytest.raises(NotImplementedError, match="audio frames"):
        jengine.ServeEngine(jcfg, lanes=2, max_len=16)
    with pytest.raises(NotImplementedError, match="audio frames"):
        ServeEngine(cfg, lanes=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match="audio frames"):
        tserve.serve_continuous(ARCH, requests=1, device="cpu")
    (_, opt_state), log = ttrain.train(ARCH, steps=2, batch=1, seq=64,
                                      log_every=1, device="cpu")
    assert int(opt_state.count) == 2
    assert all(np.isfinite(m["loss"]) for _, m in log)
