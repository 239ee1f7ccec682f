"""The sparse top-K block decode (`attention.gqa_decode_sparse`: SAM's
sparse read applied to the KV cache) against the JAX package's, on the
CPU, at the three configs of `tests/test_flash_sparse_attention.py`:

- ``full``: 4 heads over 2 of head dim 8 (d 32), blocks of 4 and 4 of
  them read, so every written block is read and the decode equals the
  dense one;
- ``select``: the same widths, 2 blocks read of 4, rope θ = 1e9 (almost
  no rotation, so the centroids keep the keys' content);
- ``lm``: the reduced `yi_34b` (2 layers, d 128, 4 heads over 2 of head
  dim 32, the gated SiLU MLP, rope θ 5e6) with 2 blocks of 8 read, through
  `lm.decode_scan`. The port has no registry entry for Yi-34B (one card
  does not hold it): its config is JAX's reduced one, field for field.

The attention weights come from JAX's `init_from_defs(PRNGKey(0))` (the
LM's from `init_params(PRNGKey(0))`), carried across as numpy; every
input is made with numpy. Tolerances (`tests/test_torch_hymba.py`'s):
f32 within `TOL` = 1e-5 of max(1, |JAX value|) a step (`SLICE_TOL` =
1e-4 for the LM's logits and caches), bf16 within `BF16_OP` = 2^-6 of it
(two bf16 ulps); positions exact.

`jax.lax.top_k` keeps the lower index among equal scores and
`torch.topk` promises no order, so the port sorts: a case with blocks
whose scores tie exactly pins JAX's order end to end, and
`top_k_indices` is held against `lax.top_k` on bf16 scores full of ties.
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
from repro.launch import engine as jengine
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.layers import init_from_defs
from repro_torch import convert
from repro_torch.launch.engine import Request, ServeEngine
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

TOL = 1e-5
SLICE_TOL = 1e-4
BF16_OP = 2.0 ** -6
# The configs of tests/test_flash_sparse_attention.py (module docstring).
SMALL = dict(name="t", num_layers=1, d_model=32, num_heads=4,
             num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64)
CASES = {"full": dict(sparse_decode_blocks=4, sparse_decode_block=4),
         "select": dict(sparse_decode_blocks=2, sparse_decode_block=4,
                        rope_theta=1e9)}
LM_SPARSE = dict(sparse_decode_blocks=2, sparse_decode_block=8)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, tol):
    """|a - b| <= tol · max(1, max |b|), elementwise."""
    a, b = _np(a), _np(b)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def _to_torch(x, dtype):
    t = torch.tensor(np.asarray(x, np.float32))
    return t.bfloat16() if dtype == "bfloat16" else t


def _to_jax(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32),
                       jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _small(case):
    """(JAX config, port config, JAX attention weights as numpy)."""
    jcfg = JaxModelConfig(**SMALL, **CASES[case])
    cfg = ModelConfig(**SMALL, **CASES[case])
    jp = init_from_defs(jax.random.PRNGKey(0), jattn.attn_defs(jcfg),
                        jnp.float32)
    return jcfg, cfg, jax.tree.map(np.asarray, jp)


def _lm_configs():
    """JAX's reduced `yi_34b` with the sparse decode, and the port's config
    of the same fields."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("yi_34b")),
                               compute_dtype="float32", **LM_SPARSE)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    assert jcfg.memory is None and jcfg.ssm is None and jcfg.moe is None
    return jcfg, ModelConfig(**fields)


def _steps(case, dtype, B, S, x, state=None):
    """S decode steps of both sides from zero caches (or ``state``: numpy
    k, v, ksum and the first position): per step the port's output, k, v
    and ksum against JAX's. Returns the port's outputs."""
    jcfg, cfg, p = _small(case)
    jp = jax.tree.map(lambda t: _to_jax(t, dtype), p)
    tp = {k: _to_torch(v, dtype) for k, v in p.items()}
    if state is None:
        z = np.zeros((B, S, 2, 8), np.float32)
        state = (z, z, np.zeros((B, S // 4, 2, 8), np.float32), 0)
    kc, vc, ks, start = state
    jk, jv, jks = (_to_jax(t, dtype) for t in (kc, vc, ks))
    tk, tv, tks = (_to_torch(t, dtype) for t in (kc, vc, ks))
    tol = TOL if dtype == "float32" else BF16_OP
    outs = []
    for t in range(start, S):
        jx = _to_jax(x[:, t:t + 1], dtype)
        want, jk, jv, jks = jattn.gqa_decode_sparse(jp, jcfg, jx, jk, jv,
                                                    jks, jnp.int32(t))
        got, tk, tv, tks = attn.gqa_decode_sparse(
            tp, cfg, _to_torch(x[:, t:t + 1], dtype), tk, tv, tks,
            torch.tensor(t, dtype=torch.int32))
        assert str(got.dtype)[6:] == str(want.dtype)
        for g, w in ((got, want), (tk, jk), (tv, jv), (tks, jks)):
            _close(g, w, tol)
        outs.append(got)
    return outs


# --------------------------------------------------------------------------
# The decode against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,dtype", [("full", "float32"),
                                        ("select", "float32"),
                                        ("full", "bfloat16")])
def test_sparse_decode_matches_jax(case, dtype):
    """16 steps of `gqa_decode_sparse` from zero caches on x of N(0, 1):
    the output, k and v caches and block sums of every step. With every
    written block read (``full``) the port's output equals its own dense
    `gqa_decode`'s within TOL (JAX's test: `test_sparse_decode_full_
    blocks_equals_dense`)."""
    B = 2 if case == "full" else 1
    x = np.random.default_rng(0).standard_normal((B, 16, 32)).astype(
        np.float32)
    outs = _steps(case, dtype, B, 16, x)
    if case != "full" or dtype != "float32":
        return
    _, cfg, p = _small(case)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    kc, vc = torch.zeros((B, 16, 2, 8)), torch.zeros((B, 16, 2, 8))
    for t in range(16):
        dense, kc, vc = attn.gqa_decode(tp, cfg, torch.tensor(x[:, t:t + 1]),
                                        kc, vc, torch.tensor(t))
        _close(outs[t], dense, TOL)


def test_lm_decode_with_sparse_blocks_matches_jax():
    """The reduced `yi_34b` with 2 blocks of 8 read (JAX's `test_lm_
    decode_with_sparse_blocks`), through `lm.decode_scan` of 24 tokens into
    a cache of 32 (4 blocks, so the later steps read 2 of 3 or 4): the
    logits, k, v and ksum, and the position."""
    jcfg, cfg = _lm_configs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    toks = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(
        np.int32)
    jc = jlm.init_cache(jcfg, 2, 32)
    tc = lm.init_cache(cfg, 2, 32, device="cpu")
    assert set(tc) == set(jc) == {"k", "v", "ksum", "pos"}
    assert tc["ksum"].shape == jc["ksum"].shape == (2, 2, 4, 2, 32)
    jl, jc = jax.jit(jlm.decode_scan, static_argnums=1)(jp, jcfg, jc, toks)
    tl, tc = lm.decode_scan(tp, cfg, tc, torch.tensor(toks))
    _close(tl, jl, SLICE_TOL)
    for key in ("k", "v", "ksum"):
        _close(tc[key], jc[key], SLICE_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 24
    # The converter takes the sparse decode's cache.
    back = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                     device="cpu")
    assert set(back) == set(tc)


# --------------------------------------------------------------------------
# The tie order
# --------------------------------------------------------------------------

def test_top_k_indices_is_lax_top_k():
    """`top_k_indices` against `jax.lax.top_k`'s indices on bf16 scores
    drawn from 5 values (ties everywhere, the masked blocks' -1e30 among
    them), k from 1 to the whole row."""
    rng = np.random.default_rng(2)
    vals = np.array([-1e30, -1.0, 0.0, 0.5, 1e9], np.float32)
    x = vals[rng.integers(0, 5, (3, 4, 16))]
    for k in (1, 3, 8, 16):
        _, want = jax.lax.top_k(jnp.asarray(x, jnp.bfloat16), k)
        got = attn.top_k_indices(torch.tensor(x).bfloat16(), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tied_blocks_read_the_lower_one():
    """``select`` (2 blocks read of 4) at position 12 with blocks 0-2
    summing to zero keys: their scores tie at 0, the current block 3 is
    read and so is block 0, the lowest, on both sides; the k and v of
    blocks 0-2 are distinct draws, so reading block 1 or 2 instead would
    move the output by O(1). Swapping blocks 0 and 1 of the caches moves
    the output on both sides alike."""
    rng = np.random.default_rng(3)
    kc = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    ks = np.zeros((1, 4, 2, 8), np.float32)
    x = rng.standard_normal((1, 16, 32)).astype(np.float32)
    base = _steps("select", "float32", 1, 13, x, (kc, vc, ks, 12))[0]
    sw = [1, 0, 2, 3]
    kc2 = kc.reshape(1, 4, 4, 2, 8)[:, sw].reshape(1, 16, 2, 8)
    vc2 = vc.reshape(1, 4, 4, 2, 8)[:, sw].reshape(1, 16, 2, 8)
    swapped = _steps("select", "float32", 1, 13, x, (kc2, vc2, ks, 12))[0]
    assert (swapped - base).abs().max() > 1e-2


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_decode_step_refuses_per_lane_positions():
    """A (B,) position with the sparse decode raises NotImplementedError
    in `decode_step`, as JAX's, and so the engine refuses the config on
    its first step on both sides; the sharded form raises, naming ROADMAP
    A11 item 4."""
    jcfg, cfg = _lm_configs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    toks = np.ones((2, 1), np.int32)
    with pytest.raises(NotImplementedError, match="per-lane"):
        jlm.decode_step(jp, jcfg, jlm.init_cache(jcfg, 2, 32, True), toks)
    with pytest.raises(NotImplementedError, match="per-lane"):
        lm.decode_step(tp, cfg, lm.init_cache(cfg, 2, 32, True,
                                              device="cpu"),
                       torch.tensor(toks))
    je = jengine.ServeEngine(jcfg, lanes=2, max_len=32)
    je.params = jp
    te = ServeEngine(cfg, params=tp, device="cpu", lanes=2, max_len=32)
    for eng, R in ((je, jengine.Request), (te, Request)):
        eng.submit(R(user="u", prompt=[1, 2], max_new_tokens=2))
        with pytest.raises(NotImplementedError, match="per-lane"):
            eng.step()
    with pytest.raises(ValueError, match="A11, item 4"):
        attn.gqa_decode_sparse_sharded(tp, cfg)
