"""The vision-language family of the port's LM (PaliGemma-3B + SAM: a
stubbed vision prefix of patch embeddings, prefix-LM attention over it,
MQA with pad heads, the GeGLU MLP, head_dim 256, tied embeddings) against
the JAX package, on the CPU, at f32 compute, in two variants of the
reduced `paligemma_3b_sam` (2 layers, d 128, a prefix of 16, a memory of
64 slots of 16 with K = 4, a memory group per layer, segments of 32):
JAX's own (4 heads over 2 kv heads, head_dim 32, no padding), and
``mqa``: head_dim 256 over one kv head, its 4 query heads padded to 8
(``pad_head_groups`` 8, so 4 dead heads are computed and masked, as
PaliGemma's 8 of 16), so that the port's D = 256, MQA and pad-head paths
run.

The weights come from JAX's `init_params(PRNGKey(0))`, carried across by
`convert.lm_params_from_jax` (no ``lm_head``: the head is the embedding);
every input, the patch embeddings too, is made with numpy. The JAX memory
ops run under their default backend, ``ref``.

Tolerances, as in `tests/test_torch_swa.py`: the attention's plain
version against `chunked_attention(prefix_len=)` within 2e-5 on unit
normal inputs (the JAX suite's bar) and its gradient within 1e-5 of
max(1, |g|); the MLP within 1e-5 of max(1, |JAX value|); the whole slice
within `SLICE_TOL` = 1e-4 of that scale (the stacked init's fan_in of 2
makes scores of std ~64, whose softmax carries one-ulp differences into
the stream); `loss_fn`'s gradients within the JAX suite's atol 2e-4 /
rtol 1e-3, JAX's own response to a one-ulp perturbation of its weights
the arbiter where a leaf lies beyond it; integers (positions, steps,
usage, read rows, tokens) exact. Reads are compared as sets with their
weights, and every test that runs the memory asserts that no read has a
near-tie at K; the decodes and the engine start from filled memory
states, and the prefill's and the loss's token seeds were picked among
0-39 (rows written from zero by one head tie: ROADMAP §C).

Two faults of the reference, copied on purpose and pinned here on both
sides (ROADMAP §C): memory groups that do not cover the layers leave the
trailing blocks out (`test_uneven_groups_skip_the_trailing_blocks`), and
the vision prefill and the token decode are different functions of the
same text (`test_vision_prefill_is_not_the_token_decode`).
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
from repro.launch import engine as jengine
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_attention_kernel
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.models import attention, layers, lm

TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
FLASH_TOL = 2e-5
SLICE_TOL = 1e-4
READ_MARGIN = 1e-6
ARCH = "paligemma_3b_sam"
B = 2
P = 16                       # the reduced config's vision prefix
VARIANTS = {"jax": {}, "mqa": dict(head_dim=256, num_kv_heads=1,
                                   pad_head_groups=8)}


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


def _configs(variant="jax", memory=True, **extra):
    kw = dict(compute_dtype="float32", **VARIANTS[variant], **extra)
    if not memory:
        kw["memory"] = None
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **kw),
            dataclasses.replace(reduced(get_config(ARCH)), **kw))


def _weights(jcfg):
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _batch(seed, S_t, d=128, targets=False):
    """Numpy tokens (B, S_t) and patch embeddings (B, P, d) of N(0, 1)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 512, (B, S_t)).astype(np.int32),
             "patch_embeds": rng.standard_normal((B, P, d)).astype(
                 np.float32)}
    if targets:
        batch["targets"] = rng.integers(0, 512, (B, S_t)).astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    """(JAX config, port config, JAX weights, port weights) at f32."""
    jcfg, cfg = _configs(request.param)
    return (jcfg, cfg, *_weights(jcfg))


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


def filled_state(st, rng, steps):
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


def filled_memory_states(jcfg, seed, batch=B):
    rng = np.random.default_rng(seed)
    return tuple(filled_state(st, rng, [5 + 4 * i for i in range(batch)])
                 for st in jlm.init_memory_states(jcfg, batch,
                                                  per_lane_step=True))


def _port_states(jm):
    return convert.lm_memory_states_from_jax(jax.tree.map(np.asarray, jm),
                                             device="cpu")


# --------------------------------------------------------------------------
# The configuration and the parameter tree
# --------------------------------------------------------------------------

def test_configs_and_param_tree_match_jax():
    for name in (ARCH, "paligemma_3b"):
        for got, want in ((get_config(name), jax_get_config(name)),
                          (reduced(get_config(name)),
                           jax_reduced(jax_get_config(name)))):
            want = dataclasses.asdict(want)
            if want["memory"] is not None:
                want["memory"].pop("backend")
            assert dataclasses.asdict(got) == want
    full = get_config(ARCH)
    assert (full.head_dim, full.num_kv_heads, full.padded_heads,
            full.q_heads_per_kv) == (256, 1, 16, 8)
    assert (full.act, full.frontend, full.frontend_len, full.prefix_lm,
            full.tie_embeddings) == ("geglu", "vision", 256, 256, True)
    assert (reduced(full).frontend_len, reduced(full).prefix_lm) == (16, 16)
    assert lm.cache_shapes(full, 4, 128) == \
        jlm.cache_shapes(jax_get_config(ARCH), 4, 128) == \
        {"k": (18, 4, 128, 1, 256), "v": (18, 4, 128, 1, 256)}
    for variant in VARIANTS:
        jcfg, cfg = _configs(variant)
        jshapes = jax.tree.map(lambda t: tuple(t.shape), jax.eval_shape(
            lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg)))
        tshapes = layers.tree_map(lambda t: tuple(t.shape),
                                  lm.init_params(cfg, device="cpu"))
        assert tshapes == jshapes and "lm_head" not in tshapes
        assert tshapes["blocks"]["mlp"]["w3"] == (2, 128, 256)
        assert tshapes["blocks"]["attn"]["wq"][2:] == (
            cfg.padded_heads, cfg.head_dim)
        assert lm.cache_shapes(cfg, B, 32) == jlm.cache_shapes(jcfg, B, 32)
    # The tied tree and the pad heads convert leaf for leaf.
    jcfg, cfg = _configs("mqa")
    jp, tp = _weights(jcfg)
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        _equal(node.numpy(), np.asarray(want))
    assert cfg.padded_heads == 8 and cfg.q_heads_per_kv == 4


# --------------------------------------------------------------------------
# The prefix attention and the GeGLU MLP
# --------------------------------------------------------------------------

def _qkv(seed, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


# (S, prefix, window, H, Hkv, D, block): no prefix; one of a block; one not
# a multiple of the block (40); the whole sequence; past it; with a window
# (the prefix's keys reach past it); head dim 256 over one kv head with 16
# query heads (PaliGemma's padded heads); S past the plain version's
# 256-row query block.
@pytest.mark.parametrize("S,prefix,window,H,Hkv,D,block", [
    (64, 0, None, 4, 2, 32, 16), (64, 16, None, 4, 2, 32, 16),
    (96, 40, None, 4, 2, 32, 32), (64, 64, None, 4, 2, 32, 32),
    (64, 100, None, 4, 2, 32, 32), (96, 40, 24, 4, 2, 32, 32),
    (64, 16, None, 16, 1, 256, 32), (128, 40, None, 16, 1, 256, 64),
    (600, 256, None, 4, 1, 32, 200)])
def test_prefix_attention_matches_jax(S, prefix, window, H, Hkv, D, block):
    q, k, v = _qkv(S + prefix + D, S, H, Hkv, D)
    want = jattn.chunked_attention(q, k, v, q_block=block, kv_block=block,
                                   window=window, prefix_len=prefix)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), window, prefix)
    _close(got, want, FLASH_TOL)
    _close(ops.flash_attention(_t(q), _t(k), _t(v), q_block=block,
                               window=window, prefix=prefix), want, FLASH_TOL)
    if prefix > 1:                  # the prefix shows keys
        causal = jattn.chunked_attention(q, k, v, q_block=block,
                                         kv_block=block, window=window)
        assert np.abs(np.asarray(causal) - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("S,prefix,window,H,Hkv,D,q_block", [
    (128, 40, None, 4, 2, 32, 32), (64, 16, None, 8, 1, 256, 16),
    (64, 100, None, 4, 2, 32, 64), (128, 40, 24, 4, 2, 32, 48)])
def test_prefix_attention_gradient_matches_jax(S, prefix, window, H, Hkv, D,
                                               q_block):
    """The attention Function's plain backward (query blocks of
    ``q_block`` rows, each against the keys up to the prefix's end)
    against `jax.grad` of `chunked_attention(prefix_len=)`."""
    q, k, v = _qkv(D + prefix, S, H, Hkv, D)
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        o = jattn.chunked_attention(q, k, v, q_block=32, kv_block=32,
                                    window=window, prefix_len=prefix)
        return jnp.sum(o * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, q_block=q_block, window=window,
                              prefix=prefix)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for a, b in zip(got, want):
        _close(a, b, TOL)


def test_geglu_mlp_matches_jax():
    """gelu(w1·x) ∘ (w3·x), then w2, GELU the tanh approximation, at f32
    and bf16; the defs as JAX's for ``act="geglu"``."""
    rng = np.random.default_rng(4)
    d, f = 128, 256
    p = {name: (rng.standard_normal(shape) * 0.1).astype(np.float32)
         for name, shape in (("w1", (d, f)), ("w2", (f, d)), ("w3", (d, f)))}
    x = rng.standard_normal((B, 8, d)).astype(np.float32)
    jcfg, cfg = _configs()
    jdefs = jlayers.mlp_defs(jcfg, d, f, True)
    defs = layers.mlp_defs(d, f, gated=True)
    assert {k: v.shape for k, v in defs.items()} == \
        {k: tuple(v.shape) for k, v in jdefs.items()}
    assert set(lm.param_defs(cfg)["blocks"]["mlp"]) == {"w1", "w2", "w3"}
    want = jlayers.mlp_apply(p, x, "geglu")
    got = layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), "geglu")
    _close(got, want, TOL)
    silu = layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), "silu")
    assert np.abs(_np(silu) - _np(want)).max() > 1e-3
    jb = jlayers.mlp_apply({k: jnp.asarray(v, jnp.bfloat16)
                            for k, v in p.items()},
                           jnp.asarray(x, jnp.bfloat16), "geglu")
    tb = layers.mlp_apply({k: _t(v).bfloat16() for k, v in p.items()},
                          _t(x).bfloat16(), "geglu")
    assert tb.dtype == torch.bfloat16 and jb.dtype == jnp.bfloat16
    _close(tb, jb, 2 ** -6)       # two bf16 ulps: each side rounds its own


# --------------------------------------------------------------------------
# The whole slice
# --------------------------------------------------------------------------

# The prefill's and the loss's token seeds: two of those of 0-39 whose
# reads hold no near-tie at K in both variants (a fresh memory's rows
# tie: ROADMAP §C).
PREFILL_SEED, LOSS_SEED, DECODE_SEED, MEMORY_SEED = 5, 6, 0, 1
UNEVEN_SEED = 0             # the same for the five-layer config


def test_prefill_matches_jax(models, reads):
    """forward's hidden states and prefill's logits on 16 patch embeddings
    and 48 tokens (S = 64: the prefix, one query block, two memory
    segments), and the port's bf16 default dtype flow on the same batch."""
    jcfg, cfg, jp, tp = models
    batch = _batch(PREFILL_SEED, 48)
    jh, _ = jlm.forward(jp, jcfg, batch)
    jl = jlm.prefill(jp, jcfg, batch)
    th, _ = lm.forward(tp, cfg, _torch_batch(batch))
    tl = lm.prefill(tp, cfg, _torch_batch(batch))
    assert th.shape == (B, P + 48, 128) and tl.shape == (B, 1, 512)
    _close(th, jh)
    _close(tl, jl)
    assert len(reads) == 2 * 2 * 2
    _assert_read_margins(reads)


def test_loss_fn_gradients_match_jax(models, reads):
    """`loss_fn` on a vision batch (the loss over the 48 text positions;
    the prefix predicts nothing) at f32 compute and every gradient leaf
    (the tied embedding's too) against `jax.value_and_grad(lm.loss_fn)`,
    within GRAD_ATOL + GRAD_RTOL·|g|; where a leaf is not, no further from
    JAX than twice JAX's own move under a one-ulp perturbation of its
    weights. Through the prefix attention's forward and its plain
    backward, the GeGLU MLP and the memory layers in the sparse unroll."""
    jcfg, cfg, jp, tp = models
    batch = _batch(LOSS_SEED, 48, targets=True)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, batch), has_aux=True))
    (jloss, _), jgrads = value_and_grad(jp)
    tp = layers.tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss, _ = lm.loss_fn(tp, cfg, _torch_batch(batch))
    leaves, spec = pytree.tree_flatten(tp)
    grads = pytree.tree_unflatten(torch.autograd.grad(loss, leaves), spec)
    _close(loss, jloss, TOL)

    spread = None
    for path, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        node = grads
        for key in path:
            node = node[key.key]
        got, want = _np(node), _np(want)
        err = np.abs(got - want)
        if (err <= GRAD_ATOL + GRAD_RTOL * np.abs(want)).all():
            continue
        if spread is None:
            rng = np.random.default_rng(0)
            spread = value_and_grad(jax.tree.map(
                lambda t: t * (1 + rng.standard_normal(t.shape).astype(
                    np.float32) * 2 ** -24), jp))[1]
        other = spread
        for key in path:
            other = other[key.key]
        own = float(np.abs(_np(other) - want).max())
        assert err.max() <= 2 * own, (jax.tree_util.keystr(path),
                                      err.max(), own)
    _assert_read_margins(reads)


def test_decode_scan_with_memory_matches_jax(models, reads):
    """24 tokens with memory states (filled) into a cache of max_len 32:
    the logits, the whole cache, the position and every memory state.
    The decode has no prefix, on both sides."""
    jcfg, cfg, jp, tp = models
    toks = _batch(DECODE_SEED, 24)["tokens"]
    jm = filled_memory_states(jcfg, MEMORY_SEED)
    tm = _port_states(jm)
    jl, jc, jm = jlm.decode_scan(jp, jcfg, jlm.init_cache(jcfg, B, 32), toks,
                                 mem_states=jm)
    tl, tc, tm = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 32,
                                                       device="cpu"),
                                torch.tensor(toks), mem_states=tm)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    _equal(tc["pos"], jc["pos"])
    _assert_states_match(tm, jm)
    assert len(reads) == 2 * 24
    _assert_read_margins(reads)


def test_gqa_decode_mqa_pad_heads_matches_jax():
    """One decode step of the attention at D = 256 over one kv head with
    the pad heads (`_tree_sum` over 256 columns and a cache of 32), per
    lane and in lockstep: the output (the dead heads zero before wo) and
    the caches."""
    jcfg, cfg = _configs("mqa")
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(12)
    jparams = jax.tree.map(lambda t: t[0], jp["blocks"]["attn"])
    tparams = layers.tree_map(lambda t: t[0], tp["blocks"]["attn"])
    shape = (4, 32, 1, 256)
    for pos in (np.array([0, 7, 30, 31], np.int32), np.int32(19)):
        kc, vc = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
        x = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
        jo, jk, jv = jattn.gqa_decode(jparams, jcfg, x, jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(pos))
        to, tk, tv = attention.gqa_decode(tparams, cfg, _t(x), _t(kc),
                                          _t(vc), torch.tensor(pos))
        _close(to, jo, TOL)
        _close(tk, jk, TOL)
        _close(tv, jv, TOL)


def test_serve_greedy_tokens_match_jax(models):
    """`serve`: token prompts (no image, as JAX serves PaliGemma), an
    8-token prompt and 16 greedy tokens."""
    jcfg, cfg, jp, tp = models
    kw = dict(batch=B, prompt_len=8, gen_len=16, max_len=32, seed=0)
    want = jserve._serve(jcfg, **kw)["tokens"]
    prompt = jax.random.randint(jax.random.PRNGKey(0), (B, 8), 1,
                                jcfg.vocab_size)
    got = tserve._serve(cfg, **kw, device="cpu", params=tp,
                        prompt=torch.tensor(np.asarray(prompt)))
    _equal(got["tokens"], want)


def test_engine_matches_jax(models):
    """The engine on 2 lanes of max_len 16: a returning user u at position
    5 (a filled session) asks for 2 prompt tokens and 8 new, a neighbour
    from position 0 for 4; both sides from the same sessions: JAX's tokens
    and both final sessions."""
    jcfg, cfg, jp, tp = models
    rng = np.random.default_rng(2)
    L, D = jcfg.num_layers, jcfg.head_dim
    sessions = {}
    for user, pos in (("u", 5), ("noise", 0)):
        mem = tuple(filled_state(st, rng, [pos]) for st in
                    jlm.init_memory_states(jcfg, 1, per_lane_step=True))
        cache = {k: np.zeros((L, 1, 16, jcfg.num_kv_heads, D), np.float32)
                 for k in ("k", "v")}
        for k in cache:
            cache[k][:, :, :pos] = rng.standard_normal(
                cache[k][:, :, :pos].shape)
        sessions[user] = {"cache": cache, "pos": np.array([pos], np.int32),
                          "counter": pos, "mem": mem}
    prompts = {u: rng.integers(1, 512, 2).tolist() for u in sessions}

    def requests(R):
        return [R(user="u", prompt=prompts["u"], max_new_tokens=8),
                R(user="noise", prompt=prompts["noise"], max_new_tokens=4)]

    jstore = jengine.SessionStore(num_slots=jcfg.memory.num_slots)
    for user, sess in sessions.items():
        jstore.put(user, sess)
    je = jengine.ServeEngine(jcfg, lanes=2, max_len=16, session_store=jstore)
    want = {r["user"]: r["tokens"] for r in je.run(requests(jengine.Request))}
    te = ServeEngine(cfg, params=tp, device="cpu", lanes=2, max_len=16)
    for user, sess in sessions.items():
        te.sessions.put(user, convert.session_from_jax(sess, device="cpu"))
    got = {r["user"]: r["tokens"] for r in te.run(requests(Request))}
    assert got == want
    for user in sessions:
        port, ref_sess = te.sessions.take(user), je.sessions.take(user)
        for key in ("k", "v"):
            _close(port["cache"][key], ref_sess["cache"][key])
        _equal(port["pos"], ref_sess["pos"])
        _assert_states_match(port["mem"], ref_sess["mem"])
        if user == "u":                  # 5 + 2 + 8 - 1
            _equal(port["pos"], [14])


# --------------------------------------------------------------------------
# The reference's faults, copied on purpose (ROADMAP §C)
# --------------------------------------------------------------------------

def test_uneven_groups_skip_the_trailing_blocks(reads):
    """5 layers with a memory group every 2: JAX makes 2 groups of 2
    blocks and runs block 4 nowhere (as `paligemma_3b_sam` runs 16 of its
    18). Both forwards are unchanged by block 4's weights and equal each
    other; an eager loop of JAX's `decode_step` with memory states (its
    cache shrinks to 4 layers after the first step) equals the port's
    `decode_scan`, whose layer-4 cache stays zero; JAX's `decode_scan`
    with memory states raises, the port's does not. Without memory
    states every block runs."""
    jcfg, cfg = _configs(num_layers=5)
    jcfg = dataclasses.replace(jcfg, memory=dataclasses.replace(
        jcfg.memory, every_n_layers=2))
    cfg = dataclasses.replace(cfg, memory=dataclasses.replace(
        cfg.memory, every_n_layers=2))
    jp, tp = _weights(jcfg)
    jp0 = jax.tree.map(lambda t: t, jp)
    jp0["blocks"] = jax.tree.map(lambda t: t.at[4].set(0.0), jp["blocks"])
    tp0 = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp0),
                                     device="cpu")
    batch = _batch(UNEVEN_SEED, 48)
    jh, _ = jlm.forward(jp, jcfg, batch)
    jh0, _ = jlm.forward(jp0, jcfg, batch)
    th, _ = lm.forward(tp, cfg, _torch_batch(batch))
    th0, _ = lm.forward(tp0, cfg, _torch_batch(batch))
    _equal(np.asarray(jh0), np.asarray(jh))
    _equal(th0.numpy(), th.numpy())
    _close(th, jh)

    toks = _batch(DECODE_SEED, 6)["tokens"]
    jm = filled_memory_states(jcfg, MEMORY_SEED)
    tm = _port_states(jm)
    jc = jlm.init_cache(jcfg, B, 16)
    for t in range(toks.shape[1]):
        jl, jc, jm = jlm.decode_step(jp, jcfg, jc, toks[:, t:t + 1],
                                     mem_states=jm)
    assert jc["k"].shape[0] == 4
    tl, tc, tm = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 16,
                                                       device="cpu"),
                                torch.tensor(toks), mem_states=tm)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc[key][:4], jc[key])
        assert not tc[key][4].any()
    _assert_states_match(tm, jm)
    with pytest.raises(TypeError):
        jlm.decode_scan(jp, jcfg, jlm.init_cache(jcfg, B, 16), toks,
                        mem_states=filled_memory_states(jcfg, MEMORY_SEED))
    # Without memory states all five blocks run, on both sides.
    jl, jc = jlm.decode_scan(jp, jcfg, jlm.init_cache(jcfg, B, 16), toks)
    tl, tc = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 16, device="cpu"),
                            torch.tensor(toks))
    _close(tl, jl)
    assert tc["k"][4].any() and jc["k"].shape[0] == 5
    _assert_read_margins(reads)


def test_vision_prefill_is_not_the_token_decode():
    """The reference's two serving paths, pinned: `prefill` needs the
    patch embeddings and attends both ways over them; `decode_scan` (and
    `serve` and the engine) takes the tokens alone, causally from position
    0. On the same text the two give different last logits, on both
    sides, and each side's equals the other's."""
    jcfg, cfg = _configs(memory=False)
    jp, tp = _weights(jcfg)
    batch = _batch(5, 48)
    jpre = jlm.prefill(jp, jcfg, batch)
    tpre = lm.prefill(tp, cfg, _torch_batch(batch))
    _close(tpre, jpre)
    jl, _ = jlm.decode_scan(jp, jcfg, jlm.init_cache(jcfg, B, 64),
                            batch["tokens"])
    tl, _ = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 64, device="cpu"),
                           torch.tensor(batch["tokens"]))
    _close(tl, jl)
    for got, pre in ((_np(tl), _np(tpre)), (_np(jl), _np(jpre))):
        assert np.abs(got - pre).max() / max(1.0, np.abs(pre).max()) > 1e-2


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_refusals():
    """A vision batch without patch embeddings (JAX raises a KeyError)
    and the attention's prefix as anything but an int >= 0, in the
    kernel's wrapper before it looks at the device.
    (`tests/test_torch_train_frontends.py` holds a frontend config's
    training against JAX.)"""
    jcfg, cfg = _configs(memory=False)
    jp, tp = _weights(jcfg)
    toks = _batch(0, 48)["tokens"]
    with pytest.raises(KeyError, match="patch_embeds"):
        jlm.forward(jp, jcfg, {"tokens": toks})
    with pytest.raises(ValueError, match="patch_embeds"):
        lm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    q, k, v = (_t(x) for x in _qkv(0, 64, 4, 2, 32))
    for prefix in (-1, 2.5, None, True):
        with pytest.raises(ValueError, match="prefix"):
            flash_attention_kernel(q, k, v, prefix=prefix)
        with pytest.raises(ValueError, match="prefix"):
            ops.flash_attention(q, k, v, prefix=prefix)
