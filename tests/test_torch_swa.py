"""The sliding-window family of the port's LM (H2O-Danube3-4B + SAM: a
window on the attention, a ring-buffer decode cache, the gated SiLU MLP,
head_dim 120) against the JAX package, on the CPU, at the reduced
`h2o_danube_3_4b_sam` (2 layers, d 128, 4 heads over 2 kv heads, window
32, a memory of 64 slots of 16 with K = 4, a memory group per layer,
segments of 32) at f32 compute, with JAX's head_dim 32 and with Danube's
own 120 (so that the port's D = 120 path runs).

The weights come from JAX's `init_params(PRNGKey(0))`, carried across by
`convert.lm_params_from_jax`; every input is made with numpy. The JAX
memory ops run under their default backend, ``ref``.

Tolerances, as in `tests/test_torch_lm.py`: the attention's plain version
against `chunked_attention(window=)` within 2e-5 on unit normal inputs
(the JAX suite's bar) and its gradient within 1e-5 of max(1, |g|); the
MLP and one decode step within 1e-5 of max(1, |JAX value|); the whole
slice within `SLICE_TOL` = 1e-4 of that scale (the stacked init's fan_in
of 2 makes scores of std ~64, whose softmax carries one-ulp differences
into the stream); `loss_fn`'s gradients within the JAX suite's
sparse-against-naive bar, atol 2e-4 / rtol 1e-3, as
`tests/test_torch_lm_train.py` holds StarCoder2's, with JAX's own
response to a one-ulp perturbation of its weights as the arbiter where a
leaf lies beyond it (at head_dim 120 one memory-gate element is 2.2e-4
off, where that perturbation moves JAX's own gate gradients by
1.9-2.1e-4: the reads' softmax and the large scores make the gradient
that ill-conditioned); integers (positions, steps, usage, read rows,
tokens) exact. Reads are compared as sets with their weights, and every
test that runs the memory asserts that no read has a near-tie at K. Rows
written from zero by one head in one step are parallel and tie (ROADMAP
§C), so the decodes and the engine start from filled memory states
(random rows, usage and read history), and the prefill's token seed was
picked among 0-39.

With max_len below the window, JAX's decode attends to the last max_len
tokens (its ring has min(max_len, window) slots) while its prefill attends
to the last `window`. The port copies this, so that its sessions are
JAX's (`test_decode_under_the_window_is_jax_s_ring`, ROADMAP §C).
"""
from __future__ import annotations

import contextlib
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import engine as jengine
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.models import attention, layers, lm

TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
FLASH_TOL = 2e-5
SLICE_TOL = 1e-4
READ_MARGIN = 1e-6
ARCH = "h2o_danube_3_4b_sam"
B = 2
HEAD_DIMS = (32, 120)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32) if str(
        getattr(x, "dtype", "")) != "bfloat16" else np.asarray(
        jnp.asarray(x, jnp.float32))


def _close(a, b, tol=SLICE_TOL):
    """|a - b| <= tol · max(1, max |b|), elementwise."""
    a, b = _np(a), _np(b)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _t(x):
    return torch.tensor(np.array(x, dtype=np.float32))


def _configs(head_dim=32, memory=True):
    kw = dict(compute_dtype="float32", head_dim=head_dim)
    if not memory:
        kw["memory"] = None
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


def _tokens(seed, S):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", params=HEAD_DIMS, ids=lambda d: f"hd{d}")
def models(request):
    """(JAX config, port config, JAX weights, port weights) at f32."""
    jcfg, cfg = _configs(request.param)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jcfg, cfg, jp, tp


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
    K, or are equal: both sides order equal rows by index)."""
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


# --------------------------------------------------------------------------
# The configuration and the parameter tree
# --------------------------------------------------------------------------

def test_config_and_param_tree_match_jax():
    for name in (ARCH, "h2o_danube_3_4b"):
        for got, want in ((get_config(name), jax_get_config(name)),
                          (reduced(get_config(name)),
                           jax_reduced(jax_get_config(name)))):
            want = dataclasses.asdict(want)
            if want["memory"] is not None:
                want["memory"].pop("backend")
            assert dataclasses.asdict(got) == want
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    assert (full.window, full.head_dim, full.act) == (4096, 120, "silu")
    assert reduced(full).window == 32
    for max_len in (16, 128, 8192):          # a ring of min(max_len, 4096)
        assert lm.cache_shapes(full, 4, max_len) == \
            jlm.cache_shapes(jfull, 4, max_len)
    assert lm.cache_shapes(full, 4, 8192)["k"] == (24, 4, 4096, 8, 120)
    for head_dim in HEAD_DIMS:
        jcfg, cfg = _configs(head_dim)
        jshapes = jax.tree.map(lambda t: tuple(t.shape), jax.eval_shape(
            lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
        tshapes = layers.tree_map(lambda t: tuple(t.shape),
                                  lm.init_params(cfg, device="cpu"))
        assert tshapes == jshapes
        assert tshapes["blocks"]["mlp"]["w3"] == (2, 128, 256)
        for max_len in (16, 64):
            assert lm.cache_shapes(cfg, B, max_len) == \
                jlm.cache_shapes(jcfg, B, max_len)


# --------------------------------------------------------------------------
# The windowed attention and the gated MLP
# --------------------------------------------------------------------------

def _qkv(seed, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


# (S, window, D, block): a window under S and a multiple of the block;
# one at least S (nothing hidden); one that is not a multiple of the
# block; Danube's head dim at the reduced config's blocks; width 1; and
# S past the plain version's 256-row query block.
@pytest.mark.parametrize("S,window,D,block", [
    (64, 16, 32, 16), (64, 100, 32, 32), (96, 40, 32, 32),
    (128, 32, 120, 64), (128, 1, 16, 32), (600, 100, 32, 200)])
def test_windowed_attention_matches_jax(S, window, D, block):
    q, k, v = _qkv(S + window, S, 4, 2, D)
    want = jattn.chunked_attention(q, k, v, q_block=block, kv_block=block,
                                   window=window)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), window)
    _close(got, want, FLASH_TOL)
    _close(ops.flash_attention(_t(q), _t(k), _t(v), q_block=block,
                               window=window), want, FLASH_TOL)
    if window < S:          # the window hides keys
        causal = jattn.chunked_attention(q, k, v, q_block=block,
                                         kv_block=block)
        assert np.abs(np.asarray(causal) - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("D,q_block", [(32, 32), (120, 128)])
def test_windowed_attention_gradient_matches_jax(D, q_block):
    """The attention Function's plain backward (query blocks of
    ``q_block`` rows, each against the keys from its window's first)
    against `jax.grad` of `chunked_attention(window=40)`."""
    S, window = 128, 40
    q, k, v = _qkv(D, S, 4, 2, D)
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        o = jattn.chunked_attention(q, k, v, q_block=32, kv_block=32,
                                    window=window)
        return jnp.sum(o * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, q_block=q_block, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for a, b in zip(got, want):
        _close(a, b, TOL)


def test_gated_mlp_matches_jax():
    """silu(w1·x) ∘ (w3·x), then w2, at f32 and bf16; the defs as JAX's.
    A gate of another activation than 'silu' or 'geglu' (GeGLU:
    tests/test_torch_vlm.py) is refused."""
    rng = np.random.default_rng(3)
    d, f = 128, 256
    p = {name: (rng.standard_normal(shape) * 0.1).astype(np.float32)
         for name, shape in (("w1", (d, f)), ("w2", (f, d)), ("w3", (d, f)))}
    x = rng.standard_normal((B, 8, d)).astype(np.float32)
    defs = layers.mlp_defs(d, f, gated=True)
    jdefs = jlayers.mlp_defs(jax_reduced(jax_get_config(ARCH)), d, f, True)
    assert {k: v.shape for k, v in defs.items()} == \
        {k: tuple(v.shape) for k, v in jdefs.items()}
    want = jlayers.mlp_apply(p, x, "silu")
    got = layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), "silu")
    _close(got, want, TOL)
    jb = jlayers.mlp_apply({k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in p.items()},
                           jnp.asarray(x, jnp.bfloat16), "silu")
    tb = layers.mlp_apply({k: _t(v).bfloat16() for k, v in p.items()},
                          _t(x).bfloat16(), "silu")
    assert tb.dtype == torch.bfloat16 and jb.dtype == jnp.bfloat16
    _close(tb, jb, 2 ** -6)       # two bf16 ulps: each side rounds its own
    with pytest.raises(ValueError, match="gated MLP"):
        layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), "relu")


# --------------------------------------------------------------------------
# The whole slice
# --------------------------------------------------------------------------

PREFILL_SEED, DECODE_SEED, MEMORY_SEED = 21, 0, 1


def test_prefill_matches_jax(models, reads):
    """forward's hidden states and prefill's logits at S = 128: four
    windows of 32, two query blocks of 64, four memory segments."""
    jcfg, cfg, jp, tp = models
    toks = _tokens(PREFILL_SEED, 128)
    jh, _ = jlm.forward(jp, jcfg, {"tokens": toks})
    jl = jlm.prefill(jp, jcfg, {"tokens": toks})
    th, _ = lm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    tl = lm.prefill(tp, cfg, {"tokens": torch.tensor(toks)})
    _close(th, jh)
    _close(tl, jl)
    assert len(reads) == 2 * 2 * 4
    _assert_read_margins(reads)


def filled_state(st, rng, steps):
    """A JAX memory state as a session leaves it (random rows, usage and
    read history, its lanes' ``steps``): a fresh memory's rows, written
    from zero by one head in one step, are parallel and tie (ROADMAP §C)."""
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


def filled_memory_states(jcfg, seed):
    """`filled_state` for every memory group, batch B, steps 5 and 9."""
    rng = np.random.default_rng(seed)
    return tuple(filled_state(st, rng, [5, 9]) for st in
                 jlm.init_memory_states(jcfg, B, per_lane_step=True))


def test_decode_scan_past_the_wrap_matches_jax(models, reads):
    """40 tokens with memory states (filled: `filled_memory_states`) into a
    cache of max_len 64: a ring of 32 slots (the window), which wraps at
    token 32. The logits, the whole ring, the position and every memory
    state."""
    jcfg, cfg, jp, tp = models
    toks = _tokens(DECODE_SEED, 40)
    jc = jlm.init_cache(jcfg, B, 64)
    assert jc["k"].shape[2] == 32
    jm = filled_memory_states(jcfg, MEMORY_SEED)
    tm = convert.lm_memory_states_from_jax(jax.tree.map(np.asarray, jm),
                                           device="cpu")
    jl, jc, jm = jlm.decode_scan(jp, jcfg, jc, toks, mem_states=jm)
    tc = lm.init_cache(cfg, B, 64, device="cpu")
    tl, tc, tm = lm.decode_scan(tp, cfg, tc, torch.tensor(toks),
                                mem_states=tm)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    _equal(tc["pos"], jc["pos"])
    assert int(tc["pos"]) == 40
    _assert_states_match(tm, jm)
    assert len(reads) == 2 * 40
    _assert_read_margins(reads)


def test_gqa_decode_ring_per_lane_matches_jax(models):
    """One decode step of the attention on a filled ring of 32 slots, per
    lane at positions 3 (not yet wrapped), 31 (the last slot), 32 (the
    first wrap) and 75; then the lockstep () position 45. The output, and
    the rings (the new k and v in slot pos % 32 of each lane, nothing
    else moved)."""
    jcfg, cfg, jp, tp = models
    rng = np.random.default_rng(11)
    jparams = jax.tree.map(lambda t: t[0], jp["blocks"]["attn"])
    tparams = layers.tree_map(lambda t: t[0], tp["blocks"]["attn"])
    shape = (4, 32, cfg.num_kv_heads, cfg.head_dim)
    for pos in (np.array([3, 31, 32, 75], np.int32), np.int32(45)):
        kc, vc = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        x = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
        jo, jk, jv = jattn.gqa_decode(jparams, jcfg, x, jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(pos))
        to, tk, tv = attention.gqa_decode(tparams, cfg, _t(x), _t(kc),
                                          _t(vc), torch.tensor(pos))
        _close(to, jo, TOL)
        for got, want, before in ((tk, jk, kc), (tv, jv, vc)):
            _close(got, want, TOL)
            moved = (got.numpy() != before).any(axis=(2, 3))
            slots = np.zeros((4, 32), bool)
            slots[np.arange(4), np.broadcast_to(pos, (4,)) % 32] = True
            _equal(moved, slots)


def test_decode_per_lane_past_the_wrap_matches_jax(models):
    """The engine's call without memory states: lanes at positions 0 and
    28 decode 8 tokens (lane 1 wraps at 32) into one ring."""
    jcfg, cfg, jp, tp = models
    toks = _tokens(5, 8)
    jc = jlm.init_cache(jcfg, B, 64, per_lane_pos=True)
    jc["pos"] = jnp.array([0, 28], jnp.int32)
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    jl, jc = jlm.decode_scan(jp, jcfg, jc, toks)
    tl, tc = lm.decode_scan(tp, cfg, tc, torch.tensor(toks))
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    _equal(tc["pos"], jc["pos"])
    _equal(tc["pos"], [8, 36])


def test_serve_greedy_tokens_match_jax(models):
    """`serve`: an 8-token prompt and 40 greedy tokens in a cache of
    max_len 32 (a ring of 32 that wraps at token 32)."""
    jcfg, cfg, jp, tp = models
    kw = dict(batch=B, prompt_len=8, gen_len=40, max_len=32, seed=0)
    want = jserve._serve(jcfg, **kw)["tokens"]
    prompt = jax.random.randint(jax.random.PRNGKey(0), (B, 8), 1,
                                jcfg.vocab_size)
    got = tserve._serve(cfg, **kw, device="cpu", params=tp,
                        prompt=torch.tensor(np.asarray(prompt)))
    _equal(got["tokens"], want)


def test_decode_under_the_window_is_jax_s_ring():
    """The reference's own inconsistency, pinned (ROADMAP §C): at max_len
    64 (a ring of 32 = the window) the decode's last logits equal the
    prefill's; at max_len 16 the ring holds 16 tokens, so the decode at
    position 47 sees the last 16 where the prefill sees the last 32. The
    port's prefill and both decodes equal JAX's; the short ring's decode
    is far from the prefill on both sides."""
    jcfg, cfg = _configs(memory=False)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    toks = _tokens(2, 48)
    jpre = jlm.prefill(jp, jcfg, {"tokens": toks})
    tpre = lm.prefill(tp, cfg, {"tokens": torch.tensor(toks)})
    _close(tpre, jpre)
    for max_len in (64, 16):
        jl, _ = jlm.decode_scan(jp, jcfg, jlm.init_cache(jcfg, B, max_len),
                                toks)
        tl, _ = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, max_len,
                                                      device="cpu"),
                               torch.tensor(toks))
        _close(tl, jl)
        gap = np.abs(_np(tl) - _np(tpre)).max() / max(
            1.0, np.abs(_np(tpre)).max())
        if max_len == 64:
            assert gap <= SLICE_TOL
        else:
            assert gap > 1e-2
            assert np.abs(np.asarray(jl) - np.asarray(jpre)).max() / max(
                1.0, np.abs(np.asarray(jpre)).max()) > 1e-2


# --------------------------------------------------------------------------
# The engine: a returning session past max_len, its checkpoint
# --------------------------------------------------------------------------

def filled_session(jcfg, rng, pos: int, max_len: int):
    """A JAX engine session (batch 1) as a returning user leaves it: a ring
    of min(max_len, window) random k and v slots, the position, the token
    counter, and `filled_state` memory states."""
    L, Hkv, D = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    smax = min(max_len, jcfg.window)
    mem = tuple(filled_state(st, rng, [pos]) for st in
                jlm.init_memory_states(jcfg, 1, per_lane_step=True))
    return {"cache": {k: rng.standard_normal(
                (L, 1, smax, Hkv, D)).astype(np.float32) for k in ("k", "v")},
            "pos": np.array([pos], np.int32), "counter": pos, "mem": mem}


@contextlib.contextmanager
def _active_reads(eng, seen):
    """Record the reads of the engine's active lanes as (q, memory, k,
    valid_n): an idle lane's memory stays zero and its reads tie."""
    fused_read = ops.fused_read

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        act = sorted(eng.scheduler.active)
        seen.append((q[act].clone(), mem[act].clone(), k, valid_n))
        return fused_read(q, mem, beta, k, valid_n=valid_n)

    ops.fused_read = record
    try:
        yield
    finally:
        ops.fused_read = fused_read


ENGINE_SEED = 1


def _engine_case(jcfg):
    """The sessions (u at position 5, the neighbour at 0) and the prompts
    of the engine test, from ENGINE_SEED."""
    rng = np.random.default_rng(ENGINE_SEED)
    sessions = {"u": filled_session(jcfg, rng, 5, 8),
                "noise": filled_session(jcfg, rng, 0, 8)}
    prompts = {u: rng.integers(1, 512, 2).tolist() for u in sessions}
    return sessions, prompts


def _requests(R, prompts):
    return [R(user="u", prompt=prompts["u"], max_new_tokens=8),
            R(user="noise", prompt=prompts["noise"], max_new_tokens=4)]


def test_engine_session_past_max_len_matches_jax(models, tmp_path):
    """A returning user u at position 5 asks for 2 prompt tokens and 8 new
    in engines of max_len 8 (a ring of 8 slots, under the window), to
    position 14: JAX admits it for a windowed config. JAX's store of one
    hot session spills u to disk in its checkpoint format; the port
    restores that directory (`checkpoint.ckpt`, a ring-sized template),
    converts the neighbour's session (`convert.session_from_jax`) and
    serves the same requests: JAX's tokens and both final sessions."""
    jcfg, cfg, jp, tp = models
    sessions, prompts = _engine_case(jcfg)
    spill = tmp_path / "jax_spill"
    jstore = jengine.SessionStore(num_slots=jcfg.memory.num_slots,
                                  capacity=1, spill_dir=str(spill))
    for user, sess in sessions.items():
        jstore.put(user, sess)
    assert jstore.spills == 1            # u, on disk
    shutil.copytree(spill / "session_u", tmp_path / "copy")
    je = jengine.ServeEngine(jcfg, lanes=2, max_len=8, session_store=jstore)
    want = {r["user"]: r["tokens"]
            for r in je.run(_requests(jengine.Request, prompts))}

    cache = lm.init_cache(cfg, 1, 8, per_lane_pos=True, device="cpu")
    assert cache["k"].shape[2] == 8
    template = {"cache": {k: cache[k] for k in ("k", "v")},
                "pos": cache["pos"], "counter": 0,
                "mem": lm.init_memory_states(cfg, 1, per_lane_step=True,
                                             device="cpu")}
    u_sess, _ = ckpt.restore_checkpoint(str(tmp_path / "copy"), template)
    te = ServeEngine(cfg, params=tp, device="cpu", lanes=2, max_len=8)
    te.sessions.put("u", u_sess)
    te.sessions.put("noise", convert.session_from_jax(sessions["noise"],
                                                      device="cpu"))
    seen = []
    with _active_reads(te, seen):
        got = {r["user"]: r["tokens"]
               for r in te.run(_requests(Request, prompts))}
    assert got == want
    for user in sessions:
        port = te.sessions.take(user)
        _assert_port_session_matches(port, je.sessions.take(user))
        if user == "u":                  # 5 + 2 + 8 - 1: past max_len
            _equal(port["pos"], [14])
    _assert_read_margins(seen)


def _assert_port_session_matches(got, want):
    for key in ("k", "v"):
        _close(got["cache"][key], want["cache"][key])
    _equal(got["pos"], want["pos"])
    assert int(got["counter"]) == int(want["counter"])
    _assert_states_match(got["mem"], want["mem"])


# --------------------------------------------------------------------------
# Training: loss_fn's gradients through the windowed forward
# --------------------------------------------------------------------------

def test_loss_fn_gradients_match_jax(models, reads):
    """`loss_fn` at f32 compute and every gradient leaf against
    `jax.value_and_grad(lm.loss_fn)`, within GRAD_ATOL + GRAD_RTOL·|g|;
    where a leaf is not, no further from JAX than twice JAX's own move
    under a one-ulp perturbation of its weights (the gradient is that
    ill-conditioned here: the memory gates' moves by 1.9-2.1e-4). Through
    the windowed attention's forward and
    its plain backward, the gated MLP, the memory layers in the port's
    default sparse unroll. B = 2, S = 64: two windows, two segments."""
    jcfg, cfg, jp, tp = models
    toks = _tokens(PREFILL_SEED, 64)
    batch = {"tokens": toks,
             "targets": np.random.default_rng(1).integers(
                 0, 512, (B, 64)).astype(np.int32)}
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, batch), has_aux=True))
    (jloss, _), jgrads = value_and_grad(jp)
    tp = layers.tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss, _ = lm.loss_fn(tp, cfg, {k: torch.tensor(v)
                                   for k, v in batch.items()})
    leaves, spec = pytree.tree_flatten(tp)
    grads = pytree.tree_unflatten(torch.autograd.grad(loss, leaves), spec)
    _close(loss, jloss, TOL)

    def jax_spread():
        """JAX's own response to a one-ulp perturbation of its weights
        (each leaf times 1 + 2^-24·N(0, 1)): the arbiter."""
        rng = np.random.default_rng(0)
        jp2 = jax.tree.map(lambda t: t * (1 + rng.standard_normal(
            t.shape).astype(np.float32) * 2 ** -24), jp)
        return value_and_grad(jp2)[1]

    spread = None
    for path, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        node, other = grads, None
        for key in path:
            node = node[key.key]
        got, want = _np(node), _np(want)
        err = np.abs(got - want)
        if (err <= GRAD_ATOL + GRAD_RTOL * np.abs(want)).all():
            continue
        if spread is None:
            spread = jax_spread()
        other = spread
        for key in path:
            other = other[key.key]
        own = float(np.abs(_np(other) - want).max())
        assert err.max() <= 2 * own, (jax.tree_util.keystr(path),
                                      err.max(), own)
    _assert_read_margins(reads)
