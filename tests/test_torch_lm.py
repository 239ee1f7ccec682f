"""The port's LM serving forward (`repro_torch.models`, `configs`,
`launch/serve.py`) and the plain version of its attention kernel against
the JAX package, on the CPU, at the reduced StarCoder2-7B + SAM config
(2 layers, d 128, 4 heads over 2 kv heads, head_dim 32, a memory of 64
slots of 16 with K = 4, a memory group per layer, segments of 32).

Inputs come from numpy seeds; the weights from JAX's `init_params`, carried
across by `convert.lm_params_from_jax`. The JAX memory ops run under their
default backend, ``ref``; the JAX attention kernel in interpret mode.

Tolerances. The JAX init draws a stacked weight with fan_in = its
stacked axis (2 layers here), so the weights have std 0.71: attention
scores have a standard deviation near 64 and the residual stream reaches
a few hundred, where one f32 ulp is 3e-5. Floats are therefore held
against max(1, max |JAX value|):
- the plain attention against `flash_attention(interpret=True)` and
  `chunked_attention`: f32 within 2e-5 and bf16 within 5e-2, the JAX
  suite's bars (`tests/test_flash_sparse_attention.py`), on its unit
  normal inputs;
- layers, one block (its input taken from JAX) and the memory layer at
  f32 compute: within 1e-5 of that scale (torch and XLA sum in other
  orders);
- the whole slice at f32 compute: within `SLICE_TOL` = 1e-4 of that
  scale (3.2e-5 measured, in the final hidden state). The blocks' errors
  compound through the softmax of those large scores: a score moved by
  one ulp moves a weight p by p(1-p) times it, which the heads and the
  output projection carry into the stream;
- integers (read and write rows, usage, steps, positions, tokens) exact.
  Rows written from zero by one head in one step are parallel, so their
  similarities to any query differ only through the 1e-6 inside the norm
  (4e-8 apart in this run), and torch and XLA may order them either way.
  So a read's rows are compared as a set, each with its weight, and every
  read the port runs is checked: no row within `READ_MARGIN` of the K-th
  similarity (f64) can trade places across the K boundary, so the set is
  the same on both sides; inside the top K, rows out of order lie within
  `READ_MARGIN` of each other;
- bf16 compute: the dtype of every output equals JAX's. The forward,
  the prefill and a decode without memory lie within `BF16_BOUND` = 0.1
  of the scale (0.051 measured): the two round bf16 products and
  activations at other places. The decode with memory, the path the card
  serves, is held op by op (`test_lm_bf16_decode_with_memory_matches_jax`):
  every block, memory access and head the port runs is run again by JAX
  on the same inputs. A block or the head within `BF16_OP` = 2^-6 of the
  scale, two bf16 ulps (4.1e-3 measured): each side rounds its bf16
  intermediates once, after sums in other orders. A memory access against
  JAX's ``pallas-interpret`` backend, which upcasts q and β to f32 as the
  port does (JAX's ``ref`` normalizes q in bf16): integers exact, floats
  within `TOL`. End to end the two decodes part from the first token on:
  a block's one-ulp differences move the rows a head writes, rows written
  by one head in one step tie within 1e-6 (above), and the reads that
  follow pick other rows (0.14 of the scale in the logits after 8 tokens).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import sam_layer as jsam
from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import attention, layers, lm, sam_layer, transformer

TOL = 1e-5
SLICE_TOL = 1e-4
FLASH_TOL = 2e-5
FLASH_BF16_TOL = 5e-2
READ_MARGIN = 1e-6
BF16_BOUND = 0.1
BF16_OP = 2.0 ** -6
B, S = 2, 64
ARCH = "starcoder2_7b_sam"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if str(getattr(x, "dtype", "")) == "bfloat16" else np.asarray(x)


def _close(a, b, tol=TOL):
    """|a - b| <= tol · max(1, max |b|), elementwise."""
    a = a.float().numpy() if isinstance(a, torch.Tensor) else _np(a)
    b = _np(b).astype(np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def _equal(a, b):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def _configs(compute_dtype):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)),
                               compute_dtype=compute_dtype)
    cfg = dataclasses.replace(reduced(get_config(ARCH)),
                              compute_dtype=compute_dtype)
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs("float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def tokens():
    # Near-ties at a read's K boundary are structural in this small layer
    # (N = 64, K = 4): rows written from zero by one head in one step are
    # parallel, and rows written with equal weights are equal. Of the
    # token seeds 0-39, only 35 gives an f32 slice whose 24 reads all
    # have a set the drift cannot change (asserted, `_assert_read_margins`).
    return np.random.default_rng(35).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.fixture
def reads(monkeypatch):
    """Every read the port runs, as (q, memory, k, valid_n, rows)."""
    seen = []
    fused_read = ops.fused_read

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        out = fused_read(q, mem, beta, k, valid_n=valid_n)
        seen.append((q.clone(), mem.clone(), k, valid_n, out[2].clone()))
        return out

    monkeypatch.setattr(ops, "fused_read", record)
    return seen


def _assert_read_margins(reads):
    """Every read: its set of K rows is one that the torch-XLA drift cannot
    change, and its order is right up to READ_MARGIN. With v the K-th best
    similarity (f64), the rows within READ_MARGIN of v either all lie in
    the top K, or all have exactly v (equal rows: both sides order them by
    index)."""
    assert reads
    for q, mem, k, valid_n, idx in reads:
        qn = ref._normalize(q.double())
        mn = ref._normalize(mem[:, :valid_n].double())
        sims = torch.einsum("bhw,bnw->bhn", qn, mn)
        v = sims.sort(dim=-1, descending=True).values[..., k - 1:k]
        band = (sims - v).abs() <= READ_MARGIN
        straddles = (sims > v + READ_MARGIN).sum(-1) + band.sum(-1) > k
        inexact = (band & (sims != v)).any(-1)
        assert not (straddles & inexact).any(), "a read near-tie at K"
        picked = torch.gather(sims, -1, idx.long())
        assert (picked[..., :-1] - picked[..., 1:] >= -READ_MARGIN).all()


def _sorted_reads(idx, w):
    """A read's rows by index, each with its weight."""
    idx = torch.tensor(np.array(idx))
    order = idx.argsort(dim=-1)
    return (torch.gather(idx, -1, order),
            torch.gather(torch.as_tensor(_np(w)), -1, order))


# --------------------------------------------------------------------------
# The attention kernel's plain version
# --------------------------------------------------------------------------

def _qkv(seed, B_, S_, H, Hkv, D, dead_heads=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B_, S_, H, D)).astype(np.float32)
    k = rng.standard_normal((B_, S_, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B_, S_, Hkv, D)).astype(np.float32)
    if dead_heads:              # the last heads of each group: zero queries
        G = H // Hkv
        q.reshape(B_, S_, Hkv, G, D)[:, :, :, G - dead_heads:] = 0.0
    return q, k, v


@pytest.mark.parametrize("B_,S_,H,Hkv,D,qb,kb,dead", [
    (1, 64, 2, 1, 16, 16, 16, 0),       # the JAX suite's three shapes
    (2, 128, 4, 2, 32, 32, 64, 0),
    (1, 128, 8, 8, 16, 64, 32, 0),
    (1, 64, 8, 2, 32, 32, 32, 1),       # padded groups: 3 of 4 heads real
])
def test_flash_attention_plain_matches_jax(B_, S_, H, Hkv, D, qb, kb, dead):
    """The plain version against the Pallas kernel and JAX's
    `chunked_attention`, which the JAX LM's forward runs. The two JAX
    functions agree only where q_block == kv_block: with causal skipping,
    `chunked_attention` drops the kv blocks j > i by block index, which
    leaves out keys of a q block wider than a kv block (the 128-row case
    with blocks 64 and 32; ROADMAP §C)."""
    q, k, v = _qkv(S_ + H, B_, S_, H, Hkv, D, dead)
    want = jax_flash(q, k, v, q_block=qb, kv_block=kb, interpret=True)
    chunked = jattn.chunked_attention(q, k, v, q_block=qb, kv_block=kb)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v))
    _close(got, want, FLASH_TOL)
    _close(ops.flash_attention(_t(q), _t(k), _t(v)), want, FLASH_TOL)
    if qb == kb:
        _close(got, chunked, FLASH_TOL)


def test_flash_attention_plain_bf16_and_ragged():
    q, k, v = _qkv(7, 1, 64, 2, 2, 16)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = jax_flash(*bf, q_block=32, kv_block=32, interpret=True)
    got = ref.flash_attention_ref(*(_t(x).bfloat16() for x in (q, k, v)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, FLASH_BF16_TOL)
    # Any S: a ragged length against the masked softmax written out.
    q, k, v = _qkv(8, 2, 37, 4, 2, 16)
    s = np.einsum("bqhgd,bkhd->bhgqk", q.reshape(2, 37, 2, 2, 16), k) / 4.0
    s = np.where(np.tril(np.ones((37, 37), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    naive = np.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(2, 37, 4, 16)
    _close(ref.flash_attention_ref(_t(q), _t(k), _t(v)), naive, FLASH_TOL)


def _bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the magnitude max |x| (`chip_smoke.py`'s bar)."""
    _, e = torch.frexp(x.float().abs().max())
    return 2.0 ** (int(e) - 8)


def _flash_bf16_emulated(q, k, v, tile=64):
    """The arithmetic of `csrc/flash_attention.cu`'s bf16 instantiation,
    in torch on the CPU, before the output's rounding: scores from bf16 q
    and k summed in f32, the online softmax over key tiles of 64 with the
    scale folded into exp2, l the f32 sum of the f32 p, and p·v as
    p_hi·v + p_lo·v in f32 with p_hi = bf16(p), p_lo = bf16(p - p_hi)."""
    B_, S_, H, D = q.shape
    Hkv = k.shape[2]
    c = D ** -0.5 * np.log2(np.e)
    qg = q.float().reshape(B_, S_, Hkv, H // Hkv, D)
    s_all = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    m = torch.full(s_all.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(s_all.shape[:-1] + (D,))
    rows = torch.arange(S_)[:, None]
    for k0 in range(0, S_, tile):
        keys = torch.arange(k0, min(k0 + tile, S_))[None, :]
        s = torch.where(keys <= rows, s_all[..., k0:k0 + tile],
                        torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        vt = v[:, k0:k0 + tile].float()
        acc = acc * corr + (torch.einsum("bhgqk,bkhd->bhgqd", p_hi, vt)
                            + torch.einsum("bhgqk,bkhd->bhgqd", p_lo, vt))
        m = m_new
    o = acc / l.clamp_min(1e-20)
    return o.permute(0, 3, 1, 2, 4).reshape(B_, S_, H, D)


@pytest.mark.parametrize("S_", [130, 1000])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("scale", [1.0, 3.5, 12.0])
def test_flash_attention_bf16_split_p_within_one_ulp(S_, D, scale):
    """The bf16 kernel's design, proven on the CPU: keeping p at f32
    precision as p_hi + p_lo holds the output within one bf16 ulp (at the
    output's largest magnitude, the bar of `chip_smoke.py` and the CUDA
    tests) of `ref.flash_attention_ref`, at score scales x1, x3.5 and x12
    (scores of std up to ~144, as the LM's), D = 64 and 128 and S ragged
    against the 64-key tile. Measured on these inputs: at most 0.25 ulp
    after the output's rounding and 0.0015 ulp before it. Rounding p once
    to bf16 instead reached 1.0 ulp, the bar itself (D = 128, scale x1),
    and 0.09-0.18 ulp before the rounding. So the unrounded output is also
    held within 1/64 ulp of the plain version's f32, which a single
    rounding of p does not meet."""
    rng = np.random.default_rng(S_ + D + int(scale * 2))
    q, k, v = (torch.tensor(rng.standard_normal((1, S_, h, D)),
                            dtype=torch.float32) for h in (4, 2, 2))
    q, k, v = (q * scale).bfloat16(), (k * scale).bfloat16(), v.bfloat16()
    want = ref.flash_attention_ref(q, k, v)
    got = _flash_bf16_emulated(q, k, v)
    ulp = _bf16_ulp(want)
    assert (got.bfloat16().float() - want.float()).abs().max().item() <= ulp
    plain32 = ref.flash_attention_ref(q.float(), k.float(), v.float())
    assert (got - plain32).abs().max().item() <= ulp / 64


def test_flash_attention_has_no_gradient():
    """The TPU kernel has no gradient (JAX differentiates
    `chunked_attention`); the port's op has one since LM training was
    ported: its plain blockwise backward equals autograd through the plain
    version (`tests/test_torch_lm_train.py` holds it against JAX)."""
    q, k, v = (_t(x).requires_grad_() for x in _qkv(0, 1, 16, 2, 1, 16))
    got = torch.autograd.grad(ops.flash_attention(q, k, v, q_block=8).sum(),
                              (q, k, v))
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v).sum(),
                               (q, k, v))
    for a, b in zip(got, want):
        _close(a, b, FLASH_TOL)


# --------------------------------------------------------------------------
# Layers, blocks and the memory layer, at f32
# --------------------------------------------------------------------------

def test_layers_match_jax(weights):
    jp, tp = weights
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, 128)).astype(np.float32) * 3.0
    scale = rng.standard_normal(128).astype(np.float32) * 0.1
    _close(layers.rms_norm(_t(x), _t(scale)), jlayers.rms_norm(x, scale))
    qh = rng.standard_normal((B, S, 4, 32)).astype(np.float32)
    pos = np.arange(S)[None]
    _close(layers.rope(_t(qh), torch.arange(S)[None], 1e5),
           jlayers.rope(qh, pos, 1e5))
    mlp = jax.tree.map(lambda t: t[0], jp["blocks"]["mlp"])
    tmlp = {k: v[0] for k, v in tp["blocks"]["mlp"].items()}
    _close(layers.mlp_apply(tmlp, _t(x)), jlayers.mlp_apply(mlp, x, "gelu"))


def test_block_forward_and_decode_match_jax(weights):
    jp, tp = weights
    jcfg, cfg = _configs("float32")
    jblk = jax.tree.map(lambda t: t[1], jp["blocks"])
    tblk = layers.tree_map(lambda t: t[1], tp["blocks"])
    x = np.random.default_rng(2).standard_normal((B, S, 128)).astype(
        np.float32)
    pos = np.arange(S)[None]
    want, aux = jtfm.block_forward(jblk, jcfg, x, pos)
    got, taux = transformer.block_forward(tblk, cfg, _t(x),
                                          torch.arange(S)[None])
    _close(got, want)
    assert float(aux) == float(taux) == 0.0   # only MoE blocks make one
    # Decode 5 tokens, the last at a per-lane position.
    shape = (B, 8, 2, 32)
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    for t in range(5):
        jpos = jnp.int32(t) if t < 4 else jnp.array([4, 2], jnp.int32)
        tpos = torch.tensor(jpos, dtype=torch.int32)
        jo, jc = jtfm.block_decode(jblk, jcfg, x[:, t:t + 1], jc, jpos)
        to, tc = transformer.block_decode(tblk, cfg, _t(x[:, t:t + 1]), tc,
                                          tpos)
        _close(to, jo)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


def _assert_states_match(got, want, tol=TOL):
    """Memory states: floats within ``tol``, usage and steps exact, each
    read's rows as a set with their weights."""
    for g, w in zip(got, want):
        _close(g.memory, w.memory, tol)
        _equal(g.last_access, w.last_access)
        _equal(g.step, w.step)
        g_idx, g_w = _sorted_reads(g.read_idx, g.read_w)
        w_idx, w_w = _sorted_reads(w.read_idx, w.read_w)
        _equal(g_idx, w_idx)
        _close(g_w, w_w, tol)


def test_memory_access_matches_jax_ref(weights, reads):
    """Six accesses of one memory group from its initial state, each held
    against JAX ``ref``: integers exact, floats within 1e-5."""
    jp, tp = weights
    jcfg, cfg = _configs("float32")
    jmp = jax.tree.map(lambda t: t[0], jp["memory"])
    tmp = layers.tree_map(lambda t: t[0], tp["memory"])
    pooled = np.random.default_rng(3).standard_normal((6, B, 128)).astype(
        np.float32)
    jst = jsam.init_memory_state(jcfg, B)
    tst = sam_layer.init_memory_state(cfg, B, device="cpu")
    for t in range(6):
        jst, jout = jsam.memory_access(jmp, jcfg, pooled[t], jst)
        tst, tout = sam_layer.memory_access(tmp, cfg, _t(pooled[t]), tst)
        _close(tout, jout)
        _assert_states_match([tst], [jst])
    assert tst.memory[:, 64].eq(0).all() and tst.last_access[:, 64].eq(
        2 ** 31 - 1).all()
    _assert_read_margins(reads)


# --------------------------------------------------------------------------
# The whole slice
# --------------------------------------------------------------------------

def _run_jax(jp, jcfg, toks, steps=8):
    hidden, _ = jlm.forward(jp, jcfg, {"tokens": toks})
    logits = jlm.prefill(jp, jcfg, {"tokens": toks})
    cache = jlm.init_cache(jcfg, B, 16)
    mem = jlm.init_memory_states(jcfg, B)
    dlogits, cache, mem = jlm.decode_scan(jp, jcfg, cache, toks[:, :steps],
                                          mem_states=mem)
    return hidden, logits, dlogits, cache, mem


def _run_port(tp, cfg, toks, steps=8):
    tt = torch.tensor(toks)
    hidden, _ = lm.forward(tp, cfg, {"tokens": tt})
    logits = lm.prefill(tp, cfg, {"tokens": tt})
    cache = lm.init_cache(cfg, B, 16, device="cpu")
    mem = lm.init_memory_states(cfg, B, device="cpu")
    dlogits, cache, mem = lm.decode_scan(tp, cfg, cache, tt[:, :steps],
                                         mem_states=mem)
    return hidden, logits, dlogits, cache, mem


def test_lm_f32_matches_jax(weights, tokens, reads):
    jp, tp = weights
    jcfg, cfg = _configs("float32")
    jh, jl, jdl, jc, jm = _run_jax(jp, jcfg, tokens)
    th, tl, tdl, tc, tm = _run_port(tp, cfg, tokens)
    for got, want in ((th, jh), (tl, jl), (tdl, jdl), (tc["k"], jc["k"]),
                      (tc["v"], jc["v"])):
        assert str(got.dtype)[6:] == str(want.dtype)
        _close(got, want, SLICE_TOL)
    _equal(tc["pos"], jc["pos"])
    _assert_states_match(tm, jm, SLICE_TOL)
    # forward, prefill: 2 groups × 2 segments each; decode: 2 × 8 tokens.
    assert len(reads) == 2 * 4 + 16
    _assert_read_margins(reads)


def test_decode_per_lane_matches_jax(weights, tokens, reads):
    """The serving engine's call: per-lane positions and memory steps
    (lanes admitted at different times), 4 tokens at f32 compute, from
    memories a session has filled (random rows, usage and read history:
    a fresh memory's parallel rows would tie)."""
    jp, tp = weights
    jcfg, cfg = _configs("float32")
    jc = jlm.init_cache(jcfg, B, 16, per_lane_pos=True)
    jc["pos"] = jnp.array([0, 3], jnp.int32)
    rng = np.random.default_rng(9)

    def filled(st):
        N = jcfg.memory.num_slots
        mem = rng.standard_normal(st.memory.shape).astype(np.float32)
        mem[:, N] = 0.0
        la = np.asarray(st.last_access).copy()
        la[:, :N] = -rng.permuted(np.tile(np.arange(N), (B, 1)), axis=1)
        idx = np.stack([rng.choice(N, st.read_idx.shape[1:], replace=False)
                        for _ in range(B)]).astype(np.int32)
        w = rng.random(st.read_w.shape).astype(np.float32)
        return st._replace(memory=jnp.asarray(mem), last_access=jnp.asarray(
            la), read_idx=jnp.asarray(idx), read_w=jnp.asarray(
            w / w.sum(-1, keepdims=True)),
            step=jnp.array([[0], [5]], jnp.int32))

    jm = tuple(filled(st) for st in
               jlm.init_memory_states(jcfg, B, per_lane_step=True))
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    tm = convert.lm_memory_states_from_jax(jax.tree.map(np.asarray, jm),
                                           device="cpu")
    jl, jc, jm = jlm.decode_scan(jp, jcfg, jc, tokens[:, :4], mem_states=jm)
    tl, tc, tm = lm.decode_scan(tp, cfg, tc, torch.tensor(tokens[:, :4]),
                                mem_states=tm)
    _close(tl, jl, SLICE_TOL)
    for key in ("k", "v"):
        _close(tc[key], jc[key], SLICE_TOL)
    _equal(tc["pos"], jc["pos"])
    _assert_states_match(tm, jm, SLICE_TOL)
    assert len(reads) == 2 * 4
    _assert_read_margins(reads)


def test_lm_without_memory_matches_jax(weights, tokens):
    """The stack with no memory layer (StarCoder2-7B itself) at f32."""
    jp, tp = weights
    jcfg, cfg = (dataclasses.replace(c, memory=None) for c in
                 _configs("float32"))
    no_mem = {k: v for k, v in jp.items() if k != "memory"}
    want, _ = jlm.forward(no_mem, jcfg, {"tokens": tokens})
    got, aux = lm.forward({k: v for k, v in tp.items() if k != "memory"},
                          cfg, {"tokens": torch.tensor(tokens)})
    _close(got, want, SLICE_TOL)
    assert float(aux) == 0.0


def test_lm_bf16_dtypes_match_jax(weights, tokens):
    """At the default bf16 compute every output has JAX's dtype; forward,
    prefill and a memoryless decode lie within BF16_BOUND of JAX."""
    jp, tp = weights
    jcfg, cfg = _configs("bfloat16")
    want = _run_jax(jp, jcfg, tokens)
    got = _run_port(tp, cfg, tokens)
    assert got[0].dtype == torch.float32        # promoted by the memory
    assert got[1].dtype == torch.float32
    assert got[2].dtype == torch.bfloat16       # decode casts back
    for g, w in zip(got[:3], want[:3]):
        assert str(g.dtype)[6:] == str(w.dtype)
    _close(got[0], want[0], BF16_BOUND)
    _close(got[1], want[1], BF16_BOUND)
    for key in ("k", "v"):
        assert str(got[3][key].dtype)[6:] == str(want[3][key].dtype)
    for g, w in zip(got[4], want[4]):
        for f in ("memory", "last_access", "read_idx", "read_w", "step"):
            assert str(getattr(g, f).dtype)[6:] == str(getattr(w, f).dtype)
    jc = jlm.init_cache(jcfg, B, 16)
    jl, jc = jlm.decode_scan(jp, jcfg, jc, tokens[:, :8])
    tc = lm.init_cache(cfg, B, 16, device="cpu")
    tl, tc = lm.decode_scan(tp, cfg, tc, torch.tensor(tokens[:, :8]))
    assert tl.dtype == tc["k"].dtype == torch.bfloat16
    for g, w in ((tl, jl), (tc["k"], jc["k"]), (tc["v"], jc["v"])):
        _close(g, w, BF16_BOUND)


def _jx(t):
    """A port tensor as a JAX array of the same dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def test_lm_bf16_decode_with_memory_matches_jax(weights, tokens, reads,
                                                 monkeypatch):
    """8 tokens of the bf16 decode with memory states (the engine's call),
    op by op: each `block_decode`, `memory_access` and the head of every
    step, run by JAX on the inputs the port gave it (see the module's
    note for why the whole decode is not compared end to end)."""
    jp, tp = weights
    jcfg, cfg = _configs("bfloat16")
    jcfg = dataclasses.replace(jcfg, memory=dataclasses.replace(
        jcfg.memory, backend="pallas-interpret"))
    ops_run = []
    block0, access0 = transformer.block_decode, sam_layer.memory_access

    def clone(x):
        return layers.tree_map(lambda t: t.clone(), x) \
            if isinstance(x, dict) else type(x)(*(t.clone() for t in x))

    def block_decode(p, cfg_, x, cache, pos):
        args = (p, x.clone(), clone(cache), pos.clone())
        out, new = block0(p, cfg_, x, cache, pos)
        ops_run.append(("block", args, (out.clone(), clone(new))))
        return out, new

    def memory_access(p, cfg_, pooled, state):
        args = (p, pooled.clone(), clone(state))
        new, out = access0(p, cfg_, pooled, state)
        ops_run.append(("memory", args, (clone(new), out.clone())))
        return new, out

    def rms_norm(x, scale, eps):
        ops_run.append(("head", (x.clone(), scale), None))
        return layers.rms_norm(x, scale, eps)

    monkeypatch.setattr(transformer, "block_decode", block_decode)
    monkeypatch.setattr(sam_layer, "memory_access", memory_access)
    monkeypatch.setattr(lm, "rms_norm", rms_norm)
    cache = lm.init_cache(cfg, B, 16, device="cpu")
    mem = lm.init_memory_states(cfg, B, device="cpu")
    head_w = _jx(lm._head_weight(tp, cfg))
    for t in range(8):
        logits, cache, mem = lm.decode_step(
            tp, cfg, cache, torch.tensor(tokens[:, t:t + 1]), mem_states=mem)
        assert logits.dtype == torch.bfloat16
        kind, (x, scale), _ = ops_run[-1]
        assert kind == "head"
        want = jlayers.rms_norm(_jx(x), _jx(scale), jcfg.norm_eps) @ head_w
        assert want.dtype == jnp.bfloat16
        _close(logits, want, BF16_OP)
    for kind, args, got in ops_run:
        if kind == "block":
            p, x, c, pos = args
            want, wc = jtfm.block_decode(
                layers.tree_map(_jx, p), jcfg, _jx(x),
                {k: _jx(v) for k, v in c.items()}, _jx(pos))
            assert str(got[0].dtype)[6:] == str(want.dtype)
            _close(got[0], want, BF16_OP)
            for key in ("k", "v"):
                assert str(got[1][key].dtype)[6:] == str(wc[key].dtype)
                _close(got[1][key], wc[key], BF16_OP)
        elif kind == "memory":
            p, pooled, st = args
            assert pooled.dtype == torch.bfloat16
            jst, jout = jsam.memory_access(
                layers.tree_map(_jx, p), jcfg, _jx(pooled),
                jsam.MemoryState(**{f: _jx(getattr(st, f))
                                    for f in st._fields}))
            assert str(got[1].dtype)[6:] == str(jout.dtype)
            _close(got[1], jout)
            _assert_states_match([got[0]], [jst])
    assert [k for k, _, _ in ops_run].count("memory") == len(reads) == 16
    _assert_read_margins(reads)


def test_serve_greedy_tokens_match_jax(weights):
    jp, tp = weights
    jcfg, cfg = _configs("float32")
    kw = dict(batch=B, prompt_len=8, gen_len=8, max_len=32, seed=0)
    want = jserve._serve(jcfg, **kw)["tokens"]
    prompt = jax.random.randint(jax.random.PRNGKey(0), (B, 8), 1,
                                jcfg.vocab_size)
    got = tserve._serve(cfg, **kw, device="cpu", params=tp,
                        prompt=torch.tensor(np.asarray(prompt)))
    _equal(got["tokens"], want)
    assert got["decode_tok_per_s"] > 0


def test_prefill_decode_consistency():
    """Decoding a sequence token by token reproduces the prefill
    attention position by position (the JAX suite's test, its 1e-4)."""
    cfg = dataclasses.replace(reduced(get_config("starcoder2_7b")),
                              num_layers=1, d_model=32, num_heads=4,
                              num_kv_heads=2, head_dim=16, q_block=16,
                              kv_block=16, compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = layers.init_from_defs(attention.attn_defs(cfg), gen, torch.float32,
                              "cpu")
    x = torch.randn((1, 16, 32), generator=gen)
    full = attention.gqa_forward(p, cfg, x, torch.arange(16)[None])
    kc = torch.zeros((1, 16, 2, 16))
    vc = torch.zeros_like(kc)
    outs = []
    for t in range(16):
        o, kc, vc = attention.gqa_decode(p, cfg, x[:, t:t + 1], kc, vc,
                                         torch.tensor(t, dtype=torch.int32))
        outs.append(o)
    torch.testing.assert_close(full, torch.cat(outs, 1), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# Configs, converters and refusals
# --------------------------------------------------------------------------

def test_configs_match_jax():
    for name in (ARCH, "starcoder2_7b", "h2o_danube_3_4b_sam",
                 "h2o_danube_3_4b"):
        for tcfg, jcfg in ((get_config(name), jax_get_config(name)),
                           (reduced(get_config(name)),
                            jax_reduced(jax_get_config(name)))):
            want = dataclasses.asdict(jcfg)
            got = dataclasses.asdict(tcfg)
            if want["memory"] is not None:
                want["memory"].pop("backend")
            assert got == want
            assert tcfg.padded_heads == jcfg.padded_heads
    full = get_config(ARCH)
    assert (full.padded_heads, full.q_heads_per_kv) == (48, 9)
    for name in ("yi_34b", "mistral_large_123b_sam"):
        with pytest.raises(ValueError, match="ROADMAP item A9c"):
            get_config(name)
    assert get_config("hymba_1_5b").block == "hybrid"


def test_param_tree_matches_jax(weights):
    jp, tp = weights
    jcfg, cfg = _configs("float32")
    jshapes = jax.tree.map(lambda t: tuple(t.shape), jp)
    tshapes = layers.tree_map(lambda t: tuple(t.shape),
                              lm.init_params(cfg, device="cpu"))
    assert tshapes == jshapes
    assert lm.cache_shapes(cfg, B, 16) == jlm.cache_shapes(jcfg, B, 16)
    assert sam_layer.memory_state_shapes(cfg, B) == \
        jsam.memory_state_shapes(jcfg, B)
    # Stacked normal leaves draw with fan_in = the leading (stacked) axis.
    w = lm.init_params(cfg, device="cpu")["blocks"]["attn"]["wq"]
    assert abs(w.std().item() - 2 ** -0.5) < 0.05


def test_converters_carry_cache_and_memory():
    jcfg, cfg = _configs("bfloat16")
    jc = jlm.init_cache(jcfg, B, 16, per_lane_pos=True)
    jc["k"] = jc["k"].at[1, 0, 3].set(1.5)
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    assert tc["k"].dtype == torch.bfloat16 and tc["k"][1, 0, 3].eq(1.5).all()
    assert tc["pos"].shape == (B,)
    jm = jlm.init_memory_states(jcfg, B, per_lane_step=True)
    tm = convert.lm_memory_states_from_jax(jax.tree.map(np.asarray, jm),
                                           device="cpu")
    ref_m = lm.init_memory_states(cfg, B, per_lane_step=True, device="cpu")
    assert len(tm) == len(ref_m) == 2
    for got, want in zip(tm, ref_m):
        for f in ("memory", "last_access", "read_idx", "read_w", "step"):
            assert torch.equal(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError, match="groups"):
        convert.lm_params_from_jax({"embed": {}, "blocks": {}, "other": 1})
    with pytest.raises(ValueError, match="cache keys"):
        convert.lm_cache_from_jax({"k": 0, "v": 0, "pos": 0, "ckv": 0})


def test_refusals():
    cfg = dataclasses.replace(reduced(get_config(ARCH)),
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    bf = dataclasses.replace(cfg, memory=dataclasses.replace(
        cfg.memory, mem_dtype="bfloat16"))
    with pytest.raises(ValueError, match="A9c"):
        sam_layer.init_memory_state(bf, B, device="cpu")
    # A hybrid block needs an SSM and the gated SiLU MLP.
    with pytest.raises(ValueError, match="A9c"):
        lm.param_defs(dataclasses.replace(cfg, block="hybrid"))
    # The sparse top-K decode is ported: its cache holds the block sums.
    sparse = dataclasses.replace(cfg, sparse_decode_blocks=4)
    assert lm.param_defs(sparse).keys() == lm.param_defs(cfg).keys()
    assert lm.cache_shapes(sparse, B, 256)["ksum"] == (
        cfg.num_layers, B, 256 // sparse.sparse_decode_block,
        cfg.num_kv_heads, cfg.head_dim)
    p = lm.init_params(cfg, device="cpu")
    x = torch.randn((B, 48, 128), generator=gen)
    with pytest.raises(ValueError, match="segment"):
        sam_layer.memory_layer_seq(
            layers.tree_map(lambda t: t[0], p["memory"]), cfg, x,
            sam_layer.init_memory_state(cfg, B, device="cpu"))
    with pytest.raises(ValueError, match="multiple"):
        lm.forward(p, cfg, {"tokens": torch.zeros((B, 96), dtype=torch.long)})
