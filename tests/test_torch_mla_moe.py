"""DeepSeek-V2's family in the port's LM (multi-head latent attention with
the absorbed decode, the capacity-dispatch mixture of experts, a leading
dense layer) against the JAX package, on the CPU, at f32 compute, in two
variants of `deepseek_v2_236b_sam`:

* ``jax``: JAX's reduced config (2 layers: the dense one and one MoE
  block; d 128, 4 heads; MLA kv_lora 32, q_lora 48, nope 32, rope 16, v
  32; 4 experts of 64, top-2, 2 shared; a memory of 64 slots of 16 with
  K = 4 and a group per layer, so with memory JAX's grouping runs no MoE
  block: per = (2 - 1) // 2 = 0, copied on purpose);
* ``wide``: the same at the full config's head widths (nope 128, rope
  64, v 128: the attention kernel's (192, 128) pair), 2 heads, kv_lora
  64, and 3 layers with a memory group every 2 (one group after the dense
  layer and both MoE blocks, as the full config's first 4 of 60 layers
  run one group after all 4).

The weights come from JAX's `init_params(PRNGKey(0))`, carried across by
`convert.lm_params_from_jax`; every input is made with numpy. The JAX
memory ops run under their default backend, ``ref``.

Tolerances: the attention's plain version against `chunked_attention`
within 2e-5 on unit normal inputs (the JAX suite's bar) and its gradient
within 1e-5 of max(1, |g|); the MoE layer within 1e-5 of max(1, |JAX
value|); MLA, the absorbed decode, the blocks and the whole slice within
`SLICE_TOL` = 1e-4 of that scale, as the other LM families' tests (JAX's
init draws with fan_in the stacked axis, 1 for the dense layer, so MLA's
scores reach the hundreds, whose softmax carries one-ulp differences into
its output); integers (routing, positions, steps,
usage, read rows, tokens) exact. Routing is compared exactly: every test
that routes asserts that no token's k-th and (k+1)-th router
probabilities lie within ROUTER_MARGIN (a near-tie there could route the
two sides apart), and reads are compared as sets with their weights, each
test that runs the memory asserting that no read has a near-tie at K;
the decodes and the engine start from filled memory states (rows written
from zero by one head tie: ROADMAP §C).

The reference's grouping with a leading dense layer (per = (L - n_dense)
// n_groups, so trailing blocks run nowhere) is pinned on both sides in
`test_uneven_groups_with_a_dense_layer_skip_trailing_blocks` (ROADMAP
§C).
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
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.config import MLAConfig as JMLAConfig
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.models import attention, layers, lm, moe, transformer
from repro_torch.models.config import MLAConfig

TOL = 1e-5
FLASH_TOL = 2e-5
SLICE_TOL = 1e-4
READ_MARGIN = 1e-6
ROUTER_MARGIN = 1e-6
ARCH = "deepseek_v2_236b_sam"
B = 2
WIDE_MLA = dict(kv_lora=64, q_lora=48, rope_head_dim=64, nope_head_dim=128,
                v_head_dim=128)
VARIANTS = ("jax", "wide")


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


def _configs(variant="jax", memory=True, every=None, **extra):
    """(JAX config, port config) of ``variant`` at f32 compute; ``every``
    sets the memory's group spacing."""
    kw = dict(compute_dtype="float32", **extra)
    jkw, tkw = dict(kw), dict(kw)
    if variant == "wide":
        jkw.update(num_heads=2, num_kv_heads=2, num_layers=3,
                   mla=JMLAConfig(**WIDE_MLA))
        tkw.update(num_heads=2, num_kv_heads=2, num_layers=3,
                   mla=MLAConfig(**WIDE_MLA))
        every = every or 2
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)), **jkw)
    cfg = dataclasses.replace(reduced(get_config(ARCH)), **tkw)
    if not memory:
        return (dataclasses.replace(jcfg, memory=None),
                dataclasses.replace(cfg, memory=None))
    if every is not None:
        jcfg = dataclasses.replace(jcfg, memory=dataclasses.replace(
            jcfg.memory, every_n_layers=every))
        cfg = dataclasses.replace(cfg, memory=dataclasses.replace(
            cfg.memory, every_n_layers=every))
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
    """Every token's k-th router probability lies more than ROUTER_MARGIN
    above its (k+1)-th: the two sides' ulps cannot route it apart."""
    assert routes
    for probs, k in routes:
        top = probs.sort(dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).min().item()
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
    for name in (ARCH, "deepseek_v2_236b"):
        for got, want in ((get_config(name), jax_get_config(name)),
                          (reduced(get_config(name)),
                           jax_reduced(jax_get_config(name)))):
            want = dataclasses.asdict(want)
            if want["memory"] is not None:
                want["memory"].pop("backend")
            assert dataclasses.asdict(got) == want
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.d_ff,
            full.vocab_size) == (60, 5120, 128, 12288, 102400)
    assert (full.mla.kv_lora, full.mla.q_lora, full.mla.nope_head_dim,
            full.mla.rope_head_dim, full.mla.v_head_dim) == \
        (512, 1536, 128, 64, 128)
    assert (full.moe.num_experts, full.moe.top_k, full.moe.d_expert,
            full.moe.shared_experts, full.moe.num_dense_layers) == \
        (160, 6, 1536, 2, 1)
    cut = dataclasses.replace(full, num_layers=4)
    jcut = dataclasses.replace(jax_get_config(ARCH), num_layers=4)
    assert lm.cache_shapes(cut, 4, 128) == jlm.cache_shapes(jcut, 4, 128) \
        == {"ckv": (4, 4, 128, 576)}
    # 13.3 B parameters at 4 of 60 layers: the cut the card serves.
    n = sum(int(np.prod(t.shape))
            for t in jax.tree.leaves(jlm.abstract_params(jcut)))
    tn = sum(int(np.prod(d.shape)) for d in _leaf_defs(lm.param_defs(cut)))
    assert tn == n and 13.2e9 < n < 13.4e9
    for variant in VARIANTS:
        jcfg, cfg = _configs(variant)
        jshapes = jax.tree.map(lambda t: tuple(t.shape),
                               jlm.abstract_params(jcfg))
        tshapes = layers.tree_map(lambda t: tuple(t.shape),
                                  lm.init_params(cfg, device="cpu"))
        assert tshapes == jshapes
        assert set(tshapes["dense_blocks"]) == {"ln1", "ln2", "attn", "mlp"}
        assert "shared" in tshapes["blocks"]["moe"]
        assert lm.cache_shapes(cfg, B, 32) == jlm.cache_shapes(jcfg, B, 32)


def _leaf_defs(defs):
    if isinstance(defs, layers.ParamDef):
        return [defs]
    return [d for v in defs.values() for d in _leaf_defs(v)]


# --------------------------------------------------------------------------
# The attention at a v narrower than q·k
# --------------------------------------------------------------------------

def _qkv(seed, S, H, Hkv, D, DV):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, DV)).astype(np.float32))


# (S, H, Hkv, D, DV, block): the reduced config's (48, 32); the full
# config's (192, 128) with MLA's H = Hkv; S past the plain version's
# 256-row query block; v wider than q·k.
@pytest.mark.parametrize("S,H,Hkv,D,DV,block", [
    (64, 4, 4, 48, 32, 16), (96, 2, 2, 192, 128, 32),
    (320, 2, 1, 192, 128, 64), (64, 4, 2, 32, 64, 32)])
def test_attention_narrow_v_matches_jax(S, H, Hkv, D, DV, block):
    q, k, v = _qkv(S + D, S, H, Hkv, D, DV)
    want = jattn.chunked_attention(q, k, v, q_block=block, kv_block=block)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v))
    assert got.shape == (B, S, H, DV)
    _close(got, want, FLASH_TOL)
    _close(ops.flash_attention(_t(q), _t(k), _t(v), q_block=block), want,
           FLASH_TOL)


@pytest.mark.parametrize("S,H,D,DV,q_block", [(64, 2, 192, 128, 16),
                                              (96, 4, 48, 32, 64)])
def test_attention_narrow_v_gradient_matches_jax(S, H, D, DV, q_block):
    """The attention Function's plain backward at DV != D against
    `jax.grad` of `chunked_attention`."""
    q, k, v = _qkv(D + DV, S, H, H, D, DV)
    g = np.random.default_rng(1).standard_normal(
        (B, S, H, DV)).astype(np.float32)

    def jloss(q, k, v):
        o = jattn.chunked_attention(q, k, v, q_block=32, kv_block=32)
        return jnp.sum(o * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, q_block=q_block)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, TOL)


def test_kernel_pairs_and_refusals():
    """The kernel is built for (D, D) and (192, 128) only; its wrapper
    refuses a CPU tensor (the dispatch sends those to the plain version)."""
    assert (192, 128) in fa_kernel.HEAD_DIM_PAIRS
    assert all(dq == dv or (dq, dv) == (192, 128)
               for dq, dv in fa_kernel.HEAD_DIM_PAIRS)
    q, k, v = (_t(x) for x in _qkv(0, 64, 2, 2, 192, 128))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)


# --------------------------------------------------------------------------
# MLA: the prefill and the absorbed decode
# --------------------------------------------------------------------------

def _attn_params(jp, tp, dense=True):
    group = "dense_blocks" if dense else "blocks"
    return (jax.tree.map(lambda t: t[0], jp[group]["attn"]),
            layers.tree_map(lambda t: t[0], tp[group]["attn"]))


def test_mla_forward_and_absorbed_decode_match_jax(models):
    """`mla_forward` on S = 32 against JAX's; then the absorbed decode,
    token by token into a cache of 32 from position 0 (a () position),
    against JAX's `mla_decode` (outputs and the cache) and against the
    port's own forward at each position (`tests/test_attention.py`'s
    check); then one step with per-lane positions past the end of one
    lane (its write dropped)."""
    variant, jcfg, cfg, jp, tp = models
    ja, ta = _attn_params(jp, tp)
    S = 32
    jdecode = jax.jit(jattn.mla_decode, static_argnums=1)
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)[None]
    want = jattn.mla_forward(ja, jcfg, x, pos)
    full = attention.mla_forward(ta, cfg, _t(x), torch.tensor(pos))
    _close(full, want)

    m = cfg.mla
    jc = jnp.zeros((B, S, m.kv_lora + m.rope_head_dim))
    tc = torch.zeros((B, S, m.kv_lora + m.rope_head_dim))
    for t in range(S):
        jo, jc = jdecode(ja, jcfg, x[:, t:t + 1], jc, jnp.int32(t))
        to, tc = attention.mla_decode(ta, cfg, _t(x[:, t:t + 1]), tc,
                                      torch.tensor(t, dtype=torch.int32))
        _close(to, jo)
        _close(to, full[:, t:t + 1], 2e-4)       # JAX's own decode bar
    _close(tc, jc)
    lanes = np.array([5, S], np.int32)           # lane 1 past the end
    jo, jc2 = jdecode(ja, jcfg, x[:, :1], jc, jnp.asarray(lanes))
    to, tc2 = attention.mla_decode(ta, cfg, _t(x[:, :1]), tc.clone(),
                                   torch.tensor(lanes))
    _close(to, jo)
    _close(tc2, jc2)
    _equal(tc2[1].numpy(), tc[1].numpy())


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _moe_params(jp, tp):
    return (jax.tree.map(lambda t: t[0], jp["blocks"]["moe"]),
            layers.tree_map(lambda t: t[0], tp["blocks"]["moe"]))


@pytest.mark.parametrize("capacity_factor,drops", [(8.0, False),
                                                   (0.5, True)])
def test_moe_apply_matches_jax(routes, capacity_factor, drops):
    """`moe_apply` on 2 × 32 tokens of N(0, 1), with ample capacity (no
    pair dropped: then Σ_k p_k · expert_k(x) over the chosen experts, as
    `tests/test_moe_rwkv_ssm.py` checks JAX) and with a quarter of it
    (pairs dropped, among them pairs whose expert's slot 0 holds a kept
    pair), at f32: the output, the aux loss and the routing."""
    jcfg, cfg = _configs(memory=False)
    jp, tp = _moe_params(*_weights(jcfg))
    jm = dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor)
    tm = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    jcfg, cfg = (dataclasses.replace(jcfg, moe=jm),
                 dataclasses.replace(cfg, moe=tm))
    x = np.random.default_rng(7).standard_normal((B, 32, 128)).astype(
        np.float32)
    want, jaux = jmoe.moe_apply(jp, jcfg, x, "silu")
    got, aux = moe.moe_apply(tp, cfg, _t(x), "silu")
    _close(got, want, TOL)
    _close(aux, jaux, TOL)
    _assert_router_margins(routes)
    probs, k = routes[0]
    _, top_e = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
    _equal(moe.top_k(probs, k)[1].numpy(), np.asarray(top_e))
    C = moe.capacity(cfg, B * 32)
    per_expert = np.bincount(np.asarray(top_e).reshape(-1), minlength=4)
    assert (per_expert.max() > C) == drops, (per_expert, C)
    if not drops:
        xt = _t(x).reshape(-1, 128)
        p, e = moe.top_k(torch.softmax(xt @ tp["router"], -1), k)
        p = p / p.sum(-1, keepdim=True)
        every = torch.stack([layers.mlp_apply(
            {w: tp[w][i] for w in ("w1", "w2", "w3")}, xt[None], "silu")[0]
            for i in range(4)], 1)                         # (T, E, d)
        dense = (every[torch.arange(xt.shape[0])[:, None], e]
                 * p[..., None]).sum(1)
        shared = layers.mlp_apply(tp["shared"], xt[None], "silu")[0]
        _close(got.reshape(-1, 128), dense + shared, TOL)


@pytest.mark.parametrize("E,pairs", [(4, 256), (160, 6 * 512), (3, 1)])
def test_moe_rank_is_the_running_count(E, pairs):
    """A pair's rank within its expert equals JAX's running count of the
    one-hot (`repro/models/moe.py:66-72`), token-major."""
    flat_e = np.random.default_rng(E).integers(0, E, pairs).astype(np.int32)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    want = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1,
                               jnp.asarray(flat_e)[:, None], axis=1)[:, 0]
    got = moe._rank_in_expert(torch.tensor(flat_e).long(), E)
    _equal(got.numpy(), np.asarray(want))


def test_moe_router_tie_goes_to_the_lowest_expert():
    """Experts 1 and 3 with the same router column: every token's
    probabilities tie exactly between them, and both sides route to
    expert 1 (`jax.lax.top_k`'s order: the lowest index first) and give
    the same output; `moe.top_k` equals `jax.lax.top_k` on ties."""
    jcfg, cfg = _configs(memory=False)
    jp, _ = _moe_params(*_weights(jcfg))
    jm = dataclasses.replace(jcfg.moe, top_k=1)
    jcfg, cfg = (dataclasses.replace(jcfg, moe=jm),
                 dataclasses.replace(cfg, moe=dataclasses.replace(
                     cfg.moe, top_k=1)))
    router = np.asarray(jp["router"]).copy()
    router[:, 1] = router[:, 3] = np.abs(router).max(1) * 4.0
    jp = dict(jp, router=jnp.asarray(router))
    tp = convert.lm_params_from_jax(
        {"embed": {}, "blocks": jax.tree.map(np.asarray, jp),
         "final_norm": np.zeros(1, np.float32)}, device="cpu")["blocks"]
    x = np.abs(np.random.default_rng(8).standard_normal(
        (B, 8, 128))).astype(np.float32)
    probs = torch.softmax(_t(x).reshape(-1, 128) @ tp["router"], -1)
    assert torch.equal(probs[:, 1], probs[:, 3])
    assert bool((probs[:, 1] > probs[:, [0, 2]].max(-1).values).all())
    _, idx = moe.top_k(probs, 1)
    assert bool((idx == 1).all())
    want, _ = jmoe.moe_apply(jp, jcfg, x, "silu")
    got, _ = moe.moe_apply(tp, cfg, _t(x), "silu")
    _close(got, want, TOL)
    ties = np.array([[0.5, 0.25, 0.5, 0.25, 0.5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(ties), 4)
    tv, ti = moe.top_k(torch.tensor(ties), 4)
    _equal(ti.numpy(), np.asarray(ji))
    _equal(tv.numpy(), np.asarray(jv))


def test_moe_weights_sum_in_f32_as_jax():
    """JAX sums a token's k weighted bf16 outputs in f32 (`jnp.sum`
    upcasts bf16) and rounds once: `moe._sum_choices` then a bf16 cast
    gives JAX's bits, where a bf16 running sum does not; and the whole
    layer at bf16 against JAX within two bf16 ulps."""
    rng = np.random.default_rng(9)
    got = rng.standard_normal((64, 6, 32)).astype(np.float32)
    jb = jnp.asarray(got, jnp.bfloat16)
    want = np.asarray(jb.sum(axis=1).astype(jnp.float32))
    tb = torch.tensor(got).bfloat16()
    mine = moe._sum_choices(tb).bfloat16().float().numpy()
    _equal(mine, want)
    running = tb[:, 0]
    for j in range(1, 6):
        running = running + tb[:, j]
    assert not np.array_equal(running.float().numpy(), want)

    jcfg, cfg = _configs(memory=False)
    jp, tp = _moe_params(*_weights(jcfg))
    x = rng.standard_normal((B, 16, 128)).astype(np.float32)
    jo, _ = jmoe.moe_apply(jax.tree.map(lambda t: t.astype(jnp.bfloat16),
                                        jp), jcfg,
                           jnp.asarray(x, jnp.bfloat16), "silu")
    to, _ = moe.moe_apply(layers.tree_map(lambda t: t.bfloat16(), tp), cfg,
                          _t(x).bfloat16(), "silu")
    assert to.dtype == torch.bfloat16
    _close(to, jo, 2 ** -6)


# --------------------------------------------------------------------------
# The blocks
# --------------------------------------------------------------------------

def test_dense_and_moe_blocks_match_jax(models, routes):
    """The dense block and the first MoE block: `block_forward` (with the
    aux loss) on S = 32, then 6 `block_decode` steps with per-lane
    positions against JAX's, the ckv cache too."""
    variant, jcfg, cfg, jp, tp = models
    x = np.random.default_rng(11).standard_normal(
        (B, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(32)[None]
    m = cfg.mla
    jforward = jax.jit(jtfm.block_forward, static_argnums=1,
                       static_argnames="moe_layer")
    jdecode = jax.jit(jtfm.block_decode, static_argnums=1,
                      static_argnames="moe_layer")
    for group, moe_layer in (("dense_blocks", False), ("blocks", True)):
        jblk = jax.tree.map(lambda t: t[0], jp[group])
        tblk = layers.tree_map(lambda t: t[0], tp[group])
        want, jaux = jforward(jblk, jcfg, x, pos, moe_layer=moe_layer)
        got, aux = transformer.block_forward(tblk, cfg, _t(x),
                                             torch.tensor(pos))
        _close(got, want)
        _close(aux, jaux, TOL)
        assert (float(aux) > 0) == moe_layer
        jc = {"ckv": jnp.zeros((B, 16, m.kv_lora + m.rope_head_dim))}
        tc = {"ckv": torch.zeros((B, 16, m.kv_lora + m.rope_head_dim))}
        lanes = np.array([0, 3], np.int32)
        for t in range(6):
            jo, jc = jdecode(jblk, jcfg, x[:, t:t + 1], jc,
                             jnp.asarray(lanes + t), moe_layer=moe_layer)
            to, tc = transformer.block_decode(tblk, cfg, _t(x[:, t:t + 1]),
                                              tc, torch.tensor(lanes + t))
            _close(to, jo)
        _close(tc["ckv"], jc["ckv"])
    _assert_router_margins(routes)


# --------------------------------------------------------------------------
# The whole slice
# --------------------------------------------------------------------------

# The prefill's token seed: the first of 0-11 whose reads hold no
# near-tie at K in both variants (a fresh memory's rows tie: ROADMAP §C);
# DECODE_SEED and UNEVEN_SEED the same for the decodes and the four-layer
# config.
PREFILL_SEED, DECODE_SEED, MEMORY_SEED, UNEVEN_SEED = 6, 0, 2, 0


def test_forward_and_prefill_match_jax(models, reads, routes):
    """`forward`'s hidden states and aux loss and `prefill`'s logits on
    64 tokens (one query block, two memory segments), with the memory and
    without (every block runs); the weights converted leaf for leaf."""
    variant, jcfg, cfg, jp, tp = models
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        _equal(node.numpy(), np.asarray(want))
    toks = _tokens(PREFILL_SEED, 64)
    batch = {"tokens": toks}
    jh, jaux = jlm.forward(jp, jcfg, batch)
    jl = jlm.prefill(jp, jcfg, batch)
    th, aux = lm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    tl = lm.prefill(tp, cfg, {"tokens": torch.tensor(toks)})
    assert th.shape == (B, 64, 128) and tl.shape == (B, 1, 512)
    _close(th, jh)
    _close(tl, jl)
    _close(aux, jaux, TOL)
    assert len(reads) == len(jlm.init_memory_states(jcfg, 1)) * 2 * 2
    _assert_read_margins(reads)
    if variant == "jax":                 # per = 0: no MoE block ran
        assert float(aux) == 0.0 and not routes
    else:
        assert float(aux) > 0.0
        _assert_router_margins(routes)
    jcfg0, cfg0 = (dataclasses.replace(c, memory=None) for c in (jcfg, cfg))
    tp0 = {k: v for k, v in tp.items() if k != "memory"}
    jp0 = {k: v for k, v in jp.items() if k != "memory"}
    jh, jaux = jlm.forward(jp0, jcfg0, batch)
    th, aux = lm.forward(tp0, cfg0, {"tokens": torch.tensor(toks)})
    _close(th, jh)
    _close(aux, jaux, TOL)
    assert float(aux) > 0.0
    _assert_router_margins(routes)


def test_decode_scan_with_memory_matches_jax(models, reads, routes):
    """12 tokens with memory states (filled) into a cache of max_len 16:
    the logits, the ckv cache, the position and every memory state. In
    JAX's reduced variant, whose cache shrinks to the layers that ran,
    JAX's `decode_scan` raises (ROADMAP §C), so an eager loop of its
    `decode_step` stands in."""
    variant, jcfg, cfg, jp, tp = models
    toks = _tokens(DECODE_SEED, 12)
    jm = filled_memory_states(jcfg, MEMORY_SEED)
    tm = _port_states(jm)
    jc = jlm.init_cache(jcfg, B, 16)
    if variant == "wide":
        jl, jc, jm = jlm.decode_scan(jp, jcfg, jc, toks, mem_states=jm)
    else:
        step = jax.jit(jlm.decode_step, static_argnums=1)
        for t in range(toks.shape[1]):
            jl, jc, jm = step(jp, jcfg, jc, toks[:, t:t + 1], jm)
    tl, tc, tm = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 16,
                                                       device="cpu"),
                                torch.tensor(toks), mem_states=tm)
    _close(tl, jl)
    # JAX's cache keeps the layers that ran (ROADMAP §C): all of them in
    # the wide variant; the dense layer alone in JAX's reduced one.
    ran = jc["ckv"].shape[0]
    assert ran == (cfg.num_layers if variant == "wide" else 1)
    _close(tc["ckv"][:ran], jc["ckv"])
    assert not tc["ckv"][ran:].any()
    _equal(tc["pos"], jc["pos"])
    _assert_states_match(tm, jm)
    assert len(reads) == len(tm) * 12
    _assert_read_margins(reads)
    if variant == "wide":
        _assert_router_margins(routes)


def test_serve_greedy_tokens_match_jax(models, routes):
    """`serve`: an 8-token prompt and 8 greedy tokens (no memory states,
    as JAX's driver: every block runs)."""
    variant, jcfg, cfg, jp, tp = models
    kw = dict(batch=B, prompt_len=8, gen_len=8, max_len=16, seed=0)
    want = jserve._serve(jcfg, **kw)["tokens"]
    prompt = jax.random.randint(jax.random.PRNGKey(0), (B, 8), 1,
                                jcfg.vocab_size)
    got = tserve._serve(cfg, **kw, device="cpu", params=tp,
                        prompt=torch.tensor(np.asarray(prompt)))
    _equal(got["tokens"], want)
    _assert_router_margins(routes)


def test_engine_matches_jax(routes):
    """The engine on 2 lanes of max_len 16 in the wide variant (JAX's
    engine cannot take the reduced one's shrinking cache): a returning
    user u at position 5 (a filled session, its ckv rows random) asks for
    2 prompt tokens and 6 new, a neighbour from position 0 for 4; both
    sides from the same sessions: JAX's tokens and both final sessions."""
    jcfg, cfg = _configs("wide")
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(2)
    m = jcfg.mla
    sessions = {}
    for user, pos in (("u", 5), ("noise", 0)):
        mem = tuple(filled_state(st, rng, [pos]) for st in
                    jlm.init_memory_states(jcfg, 1, per_lane_step=True))
        ckv = np.zeros((jcfg.num_layers, 1, 16,
                        m.kv_lora + m.rope_head_dim), np.float32)
        ckv[:, :, :pos] = rng.standard_normal(ckv[:, :, :pos].shape)
        sessions[user] = {"cache": {"ckv": ckv},
                          "pos": np.array([pos], np.int32),
                          "counter": pos, "mem": mem}
    prompts = {u: rng.integers(1, 512, 2).tolist() for u in sessions}

    def requests(R):
        return [R(user="u", prompt=prompts["u"], max_new_tokens=6),
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
        _close(port["cache"]["ckv"], ref_sess["cache"]["ckv"])
        _equal(port["pos"], ref_sess["pos"])
        _assert_states_match(port["mem"], ref_sess["mem"])
        if user == "u":                  # 5 + 2 + 6 - 1
            _equal(port["pos"], [12])
    _assert_router_margins(routes)


def test_bf16_ckv_session_spills_and_restores_bit_for_bit(tmp_path):
    """At bf16 compute the engine's sessions carry a bf16 ckv leaf: user u
    served 6 tokens uninterrupted against 3 + 3 across two engines
    sharing a store of one hot session, u spilled to disk (the JAX
    package's checkpoint format) between them with other neighbours: the
    tokens, and u's session (ckv in bf16) bit for bit."""
    from repro_torch.launch.engine import SessionStore

    jcfg, cfg = _configs("wide")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    tp = layers.tree_map(lambda t: t.bfloat16(), _weights(jcfg)[1])
    rng = np.random.default_rng(4)
    P, Pn, Po = (rng.integers(1, 512, 4).tolist() for _ in range(3))

    def u(prompt, n):
        return Request(user="u", prompt=prompt, max_new_tokens=n,
                       greedy=False, sample_seed=42)

    def others(*users):
        return [Request(user=o, prompt=p, max_new_tokens=4)
                for o, p in zip(users, (Pn, Po))]

    def engine(store=None):
        return ServeEngine(cfg, params=tp, device="cpu", lanes=2, max_len=16,
                           session_store=store)

    def tokens(results):
        return [r for r in results if r["user"] == "u"][0]["tokens"]

    e1 = engine()
    full = tokens(e1.run([u(P, 6)] + others("noise")))
    sess_full = e1.sessions.take("u")
    store = SessionStore(num_slots=cfg.memory.num_slots, capacity=1,
                         spill_dir=str(tmp_path / "spill"))
    first = tokens(engine(store).run([u(P, 3)] + others("noise")))
    assert store.spills == 1
    split = first + tokens(engine(store).run(
        [u([first[-1]], 3)] + others("other")))
    assert store.restores == 1 and split == full
    got = store.take("u")
    assert got["cache"]["ckv"].dtype == torch.bfloat16
    assert torch.equal(got["cache"]["ckv"], sess_full["cache"]["ckv"])
    assert torch.equal(got["pos"], sess_full["pos"])
    for a, b in zip(got["mem"], sess_full["mem"], strict=True):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# --------------------------------------------------------------------------
# The reference's grouping with a leading dense layer (ROADMAP §C)
# --------------------------------------------------------------------------

def test_uneven_groups_with_a_dense_layer_skip_trailing_blocks(reads,
                                                               routes):
    """4 layers, the first dense, a memory group every 2: JAX makes 2
    groups of (4 - 1) // 2 = 1 block and runs MoE block 2 (layer 3)
    nowhere (as `deepseek_v2_236b_sam` runs 45 of its 59 MoE blocks).
    Both forwards are unchanged by that block's weights and equal each
    other; a loop of JAX's `decode_step` with memory states (its cache
    shrinks to 1 + 2 layers) equals the port's `decode_scan`, whose layer
    3 stays zero; JAX's `decode_scan` with memory states raises, the
    port's does not. Without memory states every block runs."""
    jcfg, cfg = _configs(num_layers=4, every=2)
    jp, tp = _weights(jcfg)
    assert jp["blocks"]["ln1"].shape[0] == 3 and len(
        jlm.init_memory_states(jcfg, 1)) == 2
    jp0 = dict(jp, blocks=jax.tree.map(lambda t: t.at[2:].set(0.0),
                                       jp["blocks"]))
    tp0 = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp0),
                                     device="cpu")
    toks = _tokens(UNEVEN_SEED, 32)
    jforward = jax.jit(jlm.forward, static_argnums=1)
    jh, _ = jforward(jp, jcfg, {"tokens": toks})
    jh0, _ = jforward(jp0, jcfg, {"tokens": toks})
    th, _ = lm.forward(tp, cfg, {"tokens": torch.tensor(toks)})
    th0, _ = lm.forward(tp0, cfg, {"tokens": torch.tensor(toks)})
    _equal(np.asarray(jh0), np.asarray(jh))
    _equal(th0.numpy(), th.numpy())
    _close(th, jh)

    toks = _tokens(DECODE_SEED, 3)
    jm = filled_memory_states(jcfg, MEMORY_SEED)
    tm = _port_states(jm)
    jc = jlm.init_cache(jcfg, B, 8)
    step = jax.jit(jlm.decode_step, static_argnums=1)
    for t in range(toks.shape[1]):
        jl, jc, jm = step(jp, jcfg, jc, toks[:, t:t + 1], jm)
    assert jc["ckv"].shape[0] == 3
    tl, tc, tm = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 8,
                                                       device="cpu"),
                                torch.tensor(toks), mem_states=tm)
    _close(tl, jl)
    _close(tc["ckv"][:3], jc["ckv"])
    assert not tc["ckv"][3:].any()
    _assert_states_match(tm, jm)
    with pytest.raises(TypeError):
        jlm.decode_scan(jp, jcfg, jlm.init_cache(jcfg, B, 8), toks,
                        mem_states=filled_memory_states(jcfg, MEMORY_SEED))
    jl, jc = jlm.decode_scan(jp, jcfg, jlm.init_cache(jcfg, B, 8), toks)
    tl, tc = lm.decode_scan(tp, cfg, lm.init_cache(cfg, B, 8, device="cpu"),
                            torch.tensor(toks))
    _close(tl, jl)
    assert tc["ckv"][3].any() and jc["ckv"].shape[0] == 4
    _assert_read_margins(reads)
    _assert_router_margins(routes)


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_refusals():
    """Hymba's config loads; the converter refuses a cache mixing k/v with
    ckv. (`tests/test_torch_train_moe.py` and
    `tests/test_torch_train_recurrent.py` hold the training of MLA, MoE
    and Hymba against JAX.)"""
    assert get_config("hymba_1_5b_sam").ssm is not None
    with pytest.raises(ValueError, match="cache keys"):
        convert.lm_cache_from_jax({"ckv": 0, "k": 0, "pos": 0})
