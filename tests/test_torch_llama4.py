"""Llama-4 Maverick's family in the port's LM (GQA with pad heads over the
capacity-dispatch mixture of experts at top-1 with one shared expert and
no dense layer) against the JAX package, on the CPU, at f32 compute, in
two variants of `llama4_maverick_400b_a17b_sam`:

* ``jax``: JAX's reduced config (2 layers, both MoE blocks; d 128, 4
  heads over 2, head dim 32, no pad heads; 4 experts of 64, top-1, 1
  shared; a memory of 64 slots of 16 with K = 4 and a group per layer);
* ``padded``: the same with 10 heads over 2 padded to 12 (groups of 6, 5
  real: the full config's 40 heads over 8 padded to 48), a memory group
  every 4 layers (so, as on the card at 2 of 48 layers, one group
  follows both blocks).

In both the prefill's 128 tokens drop pairs past the capacity of 40 a
expert (asserted).

The weights come from JAX's `init_params(PRNGKey(0))`, carried across by
`convert.lm_params_from_jax`; every input is made with numpy. The JAX
memory ops run under their default backend, ``ref``.

Tolerances (`tests/test_torch_mla_moe.py`'s): the MoE layer within 1e-5
of max(1, |JAX value|); the whole slice within `SLICE_TOL` = 1e-4 of that
scale; integers (routing, positions, steps, usage, read rows, tokens)
exact. Every test that routes asserts that no token's top two router
probabilities lie within ROUTER_MARGIN, and reads are compared as sets
with their weights, each test that runs the memory asserting that no read
has a near-tie at K; the decodes start from filled memory states.

The weight draw's rule for slices past `layers.DRAW_LIMIT` is held here
too: the earlier configs draw what they drew, and a slice past the limit
is drawn slice by slice of its next axis.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import PORTED, get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers, lm, moe

TOL = 1e-5
SLICE_TOL = 1e-4
READ_MARGIN = 1e-6
ROUTER_MARGIN = 1e-6
ARCH = "llama4_maverick_400b_a17b_sam"
B = 2
PADDED = dict(num_heads=10, num_kv_heads=2, pad_head_groups=6)
VARIANTS = ("jax", "padded")
# The token seeds: the first of 0-39 whose reads hold no near-tie at K
# and whose routers none at k in both variants (a fresh memory's rows
# tie: ROADMAP §C).
PREFILL_SEED, DECODE_SEED, MEMORY_SEED = 14, 0, 2


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


def _configs(variant="jax", memory=True):
    """(JAX config, port config) of ``variant`` at f32 compute."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)),
                               compute_dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(ARCH)),
                              compute_dtype="float32")
    if variant == "padded":
        jcfg, cfg = (dataclasses.replace(
            c, **PADDED,
            memory=dataclasses.replace(c.memory, every_n_layers=4))
            for c in (jcfg, cfg))
    if not memory:
        jcfg, cfg = (dataclasses.replace(c, memory=None)
                     for c in (jcfg, cfg))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(jcfg):
    """JAX's weights of ``jcfg`` from PRNGKey(0) and the port's copy (one
    draw a config: the tests only read them)."""
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _tokens(seed, S, n=B):
    return np.random.default_rng(seed).integers(0, 512, (n, S)).astype(
        np.int32)


@pytest.fixture(scope="module", params=VARIANTS)
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


@pytest.fixture
def routes(monkeypatch):
    """Every router softmax the port ranks, as (probs, k)."""
    seen = []
    top_k = moe.top_k

    def record(probs, k):
        seen.append((probs.detach().clone(), k))
        return top_k(probs, k)

    monkeypatch.setattr(moe, "top_k", record)
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


def _assert_router_margins(routes):
    """Every token's top router probability lies more than ROUTER_MARGIN
    above its second: the two sides' ulps cannot route it apart."""
    assert routes
    for probs, k in routes:
        assert k == 1
        top = probs.sort(dim=-1, descending=True).values
        gap = (top[:, 0] - top[:, 1]).min().item()
        assert gap > ROUTER_MARGIN, f"a router near-tie at k: {gap:.3g}"


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


def _leaf_defs(defs):
    if isinstance(defs, layers.ParamDef):
        return [defs]
    return [d for v in defs.values() for d in _leaf_defs(v)]


# --------------------------------------------------------------------------
# The configuration, the parameter tree and the converter
# --------------------------------------------------------------------------

def test_configs_and_param_tree_match_jax():
    """The published config (and ``_sam``) and the reduced one field for
    field against JAX's; the 2-of-48-layer cut the card serves (34.7 B
    parameters, 64.6 GiB in bf16) leaf for leaf; the variants' trees, no
    ``dense_blocks``, and the memory grouping of each."""
    for name in (ARCH, "llama4_maverick_400b_a17b"):
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
            full.rope_theta, full.pad_head_groups, full.padded_heads) == \
        (48, 5120, 40, 8, 128, 8192, 202048, "silu", 5e5, 6, 48)
    assert (full.moe.num_experts, full.moe.top_k, full.moe.d_expert,
            full.moe.shared_experts, full.moe.num_dense_layers) == \
        (128, 1, 8192, 1, 0)
    small = reduced(full)
    assert (small.num_layers, small.moe.num_experts, small.moe.top_k,
            small.moe.d_expert, small.moe.shared_experts,
            small.moe.num_dense_layers, small.pad_head_groups) == \
        (2, 4, 1, 64, 1, 0, None)
    cut = dataclasses.replace(full, num_layers=2)
    jcut = dataclasses.replace(jax_get_config(ARCH), num_layers=2)
    assert lm.cache_shapes(cut, 4, 128) == jlm.cache_shapes(jcut, 4, 128) \
        == {"k": (2, 4, 128, 8, 128), "v": (2, 4, 128, 8, 128)}
    jshapes = jax.tree.map(lambda t: tuple(t.shape), jlm.abstract_params(jcut))
    tshapes = jax.tree.map(lambda d: d.shape, lm.param_defs(cut),
                           is_leaf=lambda d: isinstance(d, layers.ParamDef))
    assert tshapes == jshapes and "dense_blocks" not in tshapes
    assert tshapes["blocks"]["moe"]["w1"] == (2, 128, 5120, 8192)
    assert tshapes["memory"]["wq"][0] == 1          # one group: 2 // 4 -> 1
    n = sum(int(np.prod(d.shape)) for d in _leaf_defs(lm.param_defs(cut)))
    assert n == 34_688_947_200
    for variant in VARIANTS:
        jcfg, cfg = _configs(variant)
        jshapes = jax.tree.map(lambda t: tuple(t.shape),
                               jlm.abstract_params(jcfg))
        tshapes = layers.tree_map(lambda t: tuple(t.shape),
                                  lm.init_params(cfg, device="cpu"))
        assert tshapes == jshapes and "dense_blocks" not in tshapes
        assert "shared" in tshapes["blocks"]["moe"]
        assert lm.cache_shapes(cfg, B, 32) == jlm.cache_shapes(jcfg, B, 32)
        groups = len(lm.init_memory_states(cfg, B, device="cpu"))
        assert groups == len(jlm.init_memory_states(jcfg, B)) \
            == {"jax": 2, "padded": 1}[variant]
        assert lm._per_group(cfg, groups) == {"jax": 1, "padded": 2}[variant]


def test_converter_carries_the_tree_and_round_trips(tmp_path):
    """JAX's tree without ``dense_blocks`` carried across leaf for leaf;
    the port's checkpoint of it restored by JAX, and JAX's by the port,
    bit for bit, with the same leaf paths."""
    jcfg, _ = _configs("padded")
    jp, tp = _weights(jcfg)
    jnp_tree = jax.tree.map(np.asarray, jp)
    assert "dense_blocks" not in jnp_tree and set(tp) == set(jnp_tree)
    flat_j = jax.tree_util.tree_flatten_with_path(jnp_tree)[0]
    flat_t = dict(ckpt.flatten_with_paths(tp))
    assert len(flat_j) == len(flat_t)
    for path, want in flat_j:
        got = flat_t["/".join(k.key for k in path)]
        assert got.dtype == torch.float32
        _equal(got.numpy(), want)
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, tp)
    back, step = jckpt.restore_checkpoint(str(tmp_path / "port"), jnp_tree)
    assert step == 3
    jax.tree.map(lambda a, b: _equal(np.asarray(a), b), back, jnp_tree)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 4, jnp_tree)
    mine, step = ckpt.restore_checkpoint(str(tmp_path / "jax"), tp)
    assert step == 4
    for path, t in ckpt.flatten_with_paths(mine):
        assert torch.equal(t, flat_t[path])


# --------------------------------------------------------------------------
# The weight draw past the slice limit
# --------------------------------------------------------------------------

def _old_draw(shape, gen, scale):
    """The draw before the slice limit: slice by slice of the leading
    axis, each whole."""
    out = torch.empty(shape)
    for i in range(shape[0]):
        out[i] = torch.randn(shape[1:], generator=gen) * scale
    return out


def test_earlier_configs_draw_what_they_drew():
    """Every earlier ported config's reduced weights equal the old rule's
    draws leaf for leaf, and no leaf of their published configs has a
    leading-axis slice past the limit (so their full-width draws are the
    old rule's too; DeepSeek-V2's largest is 4.7 GiB). Llama-4's routed
    experts are the only leaves past it."""
    def over(cfg):
        return sorted({d.shape for d in _leaf_defs(lm.param_defs(cfg))
                       if len(d.shape) > 2
                       and int(np.prod(d.shape[1:])) * 4 > layers.DRAW_LIMIT})

    assert layers.DRAW_LIMIT == 8 << 30
    for name in PORTED:
        cfg = get_config(name + "_sam")
        if name == "llama4_maverick_400b_a17b":
            assert over(cfg) == [(48, 128, 5120, 8192), (48, 128, 8192, 5120)]
            continue
        assert over(cfg) == [], name
        small = reduced(cfg)
        got = lm.init_params(small, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(0)

        def old(defs):
            if isinstance(defs, layers.ParamDef):
                if defs.init != "normal" or len(defs.shape) == 1:
                    return defs.initialize(gen, torch.float32, "cpu")
                scale = defs.scale if defs.scale is not None \
                    else defs.shape[0] ** -0.5
                return _old_draw(defs.shape, gen, scale)
            return {k: old(defs[k]) for k in sorted(defs)}

        want = old(lm.param_defs(small))
        for path, t in ckpt.flatten_with_paths(want):
            assert torch.equal(dict(ckpt.flatten_with_paths(got))[path], t), \
                (name, path)


@pytest.mark.parametrize("limit,finer", [(layers.DRAW_LIMIT, False),
                                         (3 * 4 * 5 * 4, False),
                                         (3 * 4 * 5 * 4 - 1, True)])
def test_a_slice_past_the_limit_is_drawn_finer(limit, finer):
    """`fill_normal` on a (2, 3, 4, 5) leaf: within the limit each (3, 4,
    5) slice (240 B in f32) is drawn whole; a byte past it each (4, 5)
    slice of it is; the generator advances over the same count of numbers
    either way, and a bf16 leaf holds the f32 draws rounded."""
    shape, scale = (2, 3, 4, 5), 0.5
    out = torch.empty(shape)
    gen = torch.Generator().manual_seed(3)
    layers.fill_normal(out, gen, scale, limit)
    g2 = torch.Generator().manual_seed(3)
    if finer:
        want = torch.stack([torch.stack([
            torch.randn(shape[2:], generator=g2) * scale
            for _ in range(shape[1])]) for _ in range(shape[0])])
    else:
        want = _old_draw(shape, g2, scale)
    assert torch.equal(out, want)
    assert torch.equal(torch.randn(3, generator=gen),
                       torch.randn(3, generator=g2))
    bf = torch.empty(shape, dtype=torch.bfloat16)
    layers.fill_normal(bf, torch.Generator().manual_seed(3), scale, limit)
    assert torch.equal(bf, want.bfloat16())


# --------------------------------------------------------------------------
# The mixture of experts at top-1
# --------------------------------------------------------------------------

def _moe_params(jp, tp):
    return (jax.tree.map(lambda t: t[0], jp["blocks"]["moe"]),
            layers.tree_map(lambda t: t[0], tp["blocks"]["moe"]))


@pytest.mark.parametrize("capacity_factor,drops", [(8.0, False),
                                                   (1.0, True)])
def test_moe_apply_top1_matches_jax(routes, capacity_factor, drops):
    """`moe_apply` at top-1 with the shared expert on 2 × 32 tokens of
    N(0, 1), with ample capacity (then each token's output is its expert's
    MLP times p / (p + 1e-9), plus the shared expert) and at a capacity of
    16 a expert for 64 tokens (pairs dropped: those tokens get the shared
    expert alone): the output, the aux loss (the one-hot of choice 0, the
    only choice) and the routing."""
    jcfg, cfg = _configs(memory=False)
    jp, tp = _moe_params(*_weights(jcfg))
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=capacity_factor)) for c in (jcfg, cfg))
    x = np.random.default_rng(7).standard_normal((B, 32, 128)).astype(
        np.float32)
    want, jaux = jmoe.moe_apply(jp, jcfg, x, "silu")
    got, aux = moe.moe_apply(tp, cfg, _t(x), "silu")
    _close(got, want, TOL)
    _close(aux, jaux, TOL)
    _assert_router_margins(routes)
    probs, k = routes[0]
    _, top_e = jax.lax.top_k(jnp.asarray(probs.numpy()), 1)
    e = moe.top_k(probs, 1)[1][:, 0]
    _equal(e.numpy(), np.asarray(top_e)[:, 0])
    C = moe.capacity(cfg, B * 32)
    per_expert = np.bincount(e.numpy(), minlength=4)
    assert (per_expert.max() > C) == drops, (per_expert, C)
    fe = np.bincount(e.numpy(), minlength=4) / e.numel()
    np.testing.assert_allclose(
        float(aux), 4 * (fe * probs.mean(0).numpy()).sum() * 0.001,
        rtol=1e-6)
    xt = _t(x).reshape(-1, 128)
    p = probs.max(-1).values
    kept = moe._rank_in_expert(e, 4) < C
    expert = torch.stack([layers.mlp_apply(
        {w: tp[w][i] for w in ("w1", "w2", "w3")}, xt[None], "silu")[0]
        for i in range(4)], 1)[torch.arange(xt.shape[0]), e]  # (T, d)
    routed = expert * (p / (p + 1e-9))[:, None] * kept[:, None]
    shared = layers.mlp_apply(tp["shared"], xt[None], "silu")[0]
    _close(got.reshape(-1, 128), routed + shared, TOL)
    assert bool(kept.all()) != drops


# --------------------------------------------------------------------------
# The whole slice
# --------------------------------------------------------------------------

def test_forward_and_prefill_match_jax(models, reads, routes):
    """`forward`'s hidden states and aux loss and `prefill`'s logits on
    64 tokens (one query block, two memory segments), with the memory and
    without; the prefill drops pairs past capacity (asserted), and in the
    padded variant the pad heads' weights change nothing."""
    variant, jcfg, cfg, jp, tp = models
    toks = _tokens(PREFILL_SEED, 64)
    batch = {"tokens": toks}
    jforward = jax.jit(jlm.forward, static_argnums=1)
    jh, jaux = jforward(jp, jcfg, batch)
    jl = jax.jit(jlm.prefill, static_argnums=1)(jp, jcfg, batch)
    th, aux = lm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    tl = lm.prefill(tp, cfg, {"tokens": torch.tensor(toks)})
    assert th.shape == (B, 64, 128) and tl.shape == (B, 1, 512)
    _close(th, jh)
    _close(tl, jl)
    _close(aux, jaux, TOL)
    assert float(aux) > 0.0
    assert len(reads) == len(jlm.init_memory_states(jcfg, 1)) * 2 * 2
    _assert_read_margins(reads)
    _assert_router_margins(routes)
    C = moe.capacity(cfg, B * 64)
    dropped = [int(np.maximum(np.bincount(
        probs.argmax(-1).numpy(), minlength=4) - C, 0).sum())
        for probs, _ in routes[:cfg.num_layers]]
    assert sum(dropped) > 0, dropped
    if variant == "padded":
        mask = np.arange(12) % 6 >= 5                  # the pad heads
        attn = tp["blocks"]["attn"]
        junk = dict(tp, blocks=dict(tp["blocks"], attn=dict(
            attn, wo=attn["wo"].clone().index_fill_(
                1, torch.tensor(np.flatnonzero(mask)), 7.0))))
        _equal(lm.forward(junk, cfg, {"tokens": torch.tensor(toks)})[0],
               th.numpy())
    jcfg0, cfg0 = (dataclasses.replace(c, memory=None) for c in (jcfg, cfg))
    tp0 = {k: v for k, v in tp.items() if k != "memory"}
    jp0 = {k: v for k, v in jp.items() if k != "memory"}
    jh, jaux = jlm.forward(jp0, jcfg0, batch)
    th, aux = lm.forward(tp0, cfg0, {"tokens": torch.tensor(toks)})
    _close(th, jh)
    _close(aux, jaux, TOL)
    _assert_router_margins(routes)


def test_decode_scan_with_memory_matches_jax(models, reads, routes):
    """12 tokens with memory states (filled) into a cache of max_len 16:
    the logits, the k and v caches, the position and every memory state
    (reads as sets); with the padded variant's one group both blocks run
    before its memory access."""
    variant, jcfg, cfg, jp, tp = models
    toks = _tokens(DECODE_SEED, 12)
    jm = _filled_memory_states(jcfg, MEMORY_SEED)
    tm = convert.lm_memory_states_from_jax(jax.tree.map(np.asarray, jm),
                                           device="cpu")
    jl, jc, jm = jax.jit(jlm.decode_scan, static_argnums=1)(
        jp, jcfg, jlm.init_cache(jcfg, B, 16), toks, mem_states=jm)
    tl, tc, tm = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 16,
                                                       device="cpu"),
                                torch.tensor(toks), mem_states=tm)
    _close(tl, jl)
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        _close(tc[key], jc[key])
    _equal(tc["pos"], jc["pos"])
    _assert_states_match(tm, jm)
    assert len(reads) == len(tm) * 12
    _assert_read_margins(reads)
    _assert_router_margins(routes)


def test_serve_greedy_tokens_match_jax(routes):
    """`serve` in the padded variant: an 8-token prompt and 8 greedy
    tokens (no memory states, as JAX's `serve`)."""
    jcfg, cfg = _configs("padded")
    _, tp = _weights(jcfg)
    kw = dict(batch=B, prompt_len=8, gen_len=8, max_len=16, seed=0)
    want = jserve._serve(jcfg, **kw)["tokens"]
    prompt = jax.random.randint(jax.random.PRNGKey(0), (B, 8), 1,
                                jcfg.vocab_size)
    got = tserve._serve(cfg, **kw, device="cpu", params=tp,
                        prompt=torch.tensor(np.asarray(prompt)))
    _equal(got["tokens"], want)
    _assert_router_margins(routes)


def test_training_llama4_is_refused():
    """The reduced Llama-4 trains: two AdamW steps with finite losses, the
    router's aux term in them, and a non-zero gradient in the experts and
    the router (`tests/test_torch_train_moe.py` holds it against JAX).
    The name is the test's from when training MoE was refused."""
    (params, opt_state), log = ttrain.train(ARCH, steps=2, batch=2, seq=64,
                                            log_every=1, device="cpu")
    assert int(opt_state.count) == 2
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for _, m in log)
    moe_mu = opt_state.mu["blocks"]["moe"]
    assert all(moe_mu[k].abs().max() > 0 for k in ("w1", "w2", "router"))
