"""Training on bf16 and int8 memory rows in the port, against the JAX
package on the CPU: the port's counterparts of `tests/test_int8_memory.py`
(the SAM cell's sparse and chunked BPTT against naive on int8 rows, exact
and LSH, and the bit-exact rollback; the SDNC on bf16 rows), the SDNC
trained on bf16 rows against JAX's, the plain versions of the row scatter
on bf16 and int8 rows against JAX's oracles, and the scale's gradient.

Sizes are `tests/test_int8_memory.py`'s: N = 32, W = 16, H = 2, K = 2,
B = 2, T = 4, hidden 16. Weights come from the JAX init and carry across
by `repro_torch.convert`; Pallas kernels run in interpret mode
(``backend="pallas-interpret"``).

Tolerances, each with its reason:
* int8 gradients: JAX's own bar between its modes, atol 2e-5
  (`tests/test_int8_memory.py:276-279`), losses within 1e-5;
* bf16 gradients: within twice JAX's own spread on the same inputs, the
  largest gap between two of its runs, naive and sparse under ``ref`` and
  ``pallas-interpret`` (`_sdnc_bar`): XLA keeps bf16 sums in f32 within a
  fusion, so JAX's two modes round alike (their gap is 5e-6 here), while
  the port rounds each add into its one bf16 cotangent in j order and
  JAX's Pallas bf16 write rounds otherwise (ROADMAP §C);
* rollbacks, int8 codes, scales of a restore and bf16 scatters: bit for
  bit; the scale's gradient and the oracles' floats within 1e-6 (the
  eager JAX quantizer divides by 127 where the port multiplies by
  fl(1/127), ROADMAP §C).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import dnc as jdnc
from repro.core import quant as jquant
from repro.core import sam as jsam
from repro.core import unroll as junroll
from repro.core.cell import SAMCell as JaxSAMCell
from repro.core.cell import SDNCCell as JaxSDNCCell
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import dnc, quant, sam
from repro_torch.core import unroll as unroll_lib
from repro_torch.core.cell import SAMCell, SDNCCell
from repro_torch.core.types import ControllerConfig, MemoryConfig
from repro_torch.kernels import ops, ref

N, W, H, K, B, T, D = 32, 16, 2, 2, 2, 4, 6
BACKENDS = ["ref", "pallas-interpret"]
LSH = dict(lsh_tables=2, lsh_bits=3, lsh_bucket_size=8)
ATOL = 2e-5


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _mem(mem_dtype, ann="exact", backend=None):
    kw = dict(num_slots=N, word_size=W, num_heads=H, k=K, ann=ann,
              mem_dtype=mem_dtype, **LSH)
    if backend is None:
        return MemoryConfig(**kw)
    return JaxMemoryConfig(backend=backend, **kw)


def _sam_cells(mem_dtype, ann, backend):
    return (JaxSAMCell(jsam.SAMConfig(_mem(mem_dtype, ann, backend),
                                      JaxControllerConfig(D, 16, D))),
            SAMCell(sam.SAMConfig(_mem(mem_dtype, ann),
                                  ControllerConfig(D, 16, D))))


def _xs():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(1), (T, B, D)))


# --------------------------------------------------------------------------
# The SAM cell on int8 rows (`tests/test_int8_memory.py:260-305`)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_int8_grads(ann, backend):
    jcell, _ = _sam_cells("int8", ann, backend)
    params = jcell.init_params(jax.random.PRNGKey(0))
    xs = jnp.asarray(_xs())

    def loss(p):
        _, ys = junroll.unroll(jcell, p, jcell.init_state(B), xs,
                               mode="naive")
        return (ys ** 2).sum()

    val, grads = jax.value_and_grad(loss)(params)
    return _numpy(params), float(val), _numpy(grads)


def _port_int8_grads(ann, mode, chunk, jparams):
    _, cell = _sam_cells("int8", ann, "ref")
    params = convert.params_from_jax(jparams, device="cpu")
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.requires_grad_() for p in leaves]
    state = cell.init_state(B, device="cpu")
    assert state.memory.dtype == torch.int8
    assert state.mem_scale.dtype == quant.SCALE_DTYPE
    _, ys = unroll_lib.unroll(cell, pytree.tree_unflatten(leaves, spec),
                              state, torch.tensor(_xs()), mode=mode,
                              chunk=chunk)
    loss = (ys ** 2).sum()
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    return loss.item(), pytree.tree_unflatten(grads, spec)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ann", ["exact", "lsh"])
def test_sam_int8_sparse_bptt_matches_naive(ann, backend):
    """The port's sparse and chunked (C = 2) unrolls against its naive one,
    and all three against `jax.grad` of JAX's naive unroll: losses within
    1e-5, every gradient leaf within atol 2e-5; the LSH planes get none."""
    jparams, j_loss, j_grads = _jax_int8_grads(ann, backend)
    ln, gn = _port_int8_grads(ann, "naive", None, jparams)
    np.testing.assert_allclose(ln, j_loss, atol=1e-5, rtol=1e-5)
    for mode, chunk in [("sparse", None), ("chunked", 2)]:
        ls, gs = _port_int8_grads(ann, mode, chunk, jparams)
        np.testing.assert_allclose(ln, ls, atol=1e-5)
        for a, b in zip(pytree.tree_leaves(gn), pytree.tree_leaves(gs)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
        for grads in (gn, gs):
            for group, leaves in j_grads.items():
                if group == "lsh_planes":
                    assert (grads[group] == 0).all()
                    continue
                for name, want in leaves.items():
                    np.testing.assert_allclose(grads[group][name].numpy(),
                                               want, atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_rollback_bit_exact(dtype, backend):
    """§3.4 rollback: the recorded raw bits (int8 codes and the pre-write
    scales, or bf16 rows) restore the logical rows bit for bit, and the
    rows JAX's rollback gives back. Two steps first, so the memory is not
    all zero before the rolled-back one."""
    jcell, cell = _sam_cells(dtype, "exact", backend)
    jparams = jcell.init_params(jax.random.PRNGKey(0))
    params = convert.params_from_jax(_numpy(jparams), device="cpu")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, D)))
    js0 = jcell.init_state(B)
    js1, _, _ = jsam.sam_step(jparams, jcell.cfg, js0, jnp.asarray(x),
                              collect_deltas=True)
    js2, _, jd2 = jsam.sam_step(jparams, jcell.cfg, js1,
                                jnp.asarray(x * 0.5), collect_deltas=True)
    j_back = jcell.rollback(js2, jcell.residual_state(js1), jd2)
    with torch.no_grad():
        s = cell.init_state(B, device="cpu")
        s, _ = cell.step(params, s, torch.tensor(x))
        s1 = s._replace(memory=s.memory.clone(), mem_scale=(
            None if s.mem_scale is None else s.mem_scale.clone()))
        prev = cell.residual_state(s)
        s2, _, d2 = cell.step(params, s, torch.tensor(x * 0.5),
                              collect_deltas=True)
        assert d2.old_rows.dtype == getattr(torch, dtype)
        assert (d2.old_scale is not None) == (dtype == "int8")
        assert not torch.equal(_bits(s2.memory), _bits(s1.memory))
        back = cell.rollback(s2, prev, d2)
    assert torch.equal(_bits(back.memory), _bits(s1.memory))
    if dtype == "int8" or backend == "ref":    # the Pallas bf16 write rounds
        np.testing.assert_array_equal(         # otherwise (ROADMAP §C)
            _bits(back.memory).numpy(),
            _bits(convert.memory_from_jax(j_back.memory,
                                          device="cpu")).numpy())
    if dtype == "int8":
        assert torch.equal(back.mem_scale, s1.mem_scale)
        np.testing.assert_allclose(back.mem_scale.numpy(),
                                   np.asarray(j_back.mem_scale), rtol=1e-6)


# --------------------------------------------------------------------------
# The SDNC on bf16 rows (`tests/test_int8_memory.py:362-374`), trained
# --------------------------------------------------------------------------

def _sdnc_cfgs(mem_dtype, backend="ref"):
    return (jdnc.DNCConfig(_mem(mem_dtype, backend=backend),
                           JaxControllerConfig(D, 16, D), k_l=4, sparse=True),
            dnc.DNCConfig(_mem(mem_dtype), ControllerConfig(D, 16, D),
                          k_l=4, sparse=True))


def test_sdnc_honors_bf16_mem_dtype():
    """A step on bf16 rows: the memory stays bf16, the output is finite
    and JAX's on the same weights; int8 rows are refused, as in JAX."""
    jcfg, cfg = _sdnc_cfgs("bfloat16")
    jparams = jdnc.init_params(jax.random.PRNGKey(0), jcfg)
    cell = SDNCCell(cfg)
    state = cell.init_state(B, device="cpu")
    assert state.memory.dtype == torch.bfloat16
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, D)))
    j_st, j_y = JaxSDNCCell(jcfg).step(jparams, JaxSDNCCell(jcfg).init_state(B),
                                       jnp.asarray(x))
    with torch.no_grad():
        st, y = cell.step(convert.params_from_jax(_numpy(jparams),
                                                  device="cpu"), state,
                          torch.tensor(x))
    assert st.memory.dtype == torch.bfloat16
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), atol=1e-5)
    np.testing.assert_array_equal(
        _bits(st.memory).numpy(),
        _bits(convert.memory_from_jax(j_st.memory, device="cpu")).numpy())
    with pytest.raises(ValueError, match="int8"):
        SDNCCell(_sdnc_cfgs("int8")[1]).init_state(B, device="cpu")


def _sdnc_inputs():
    """JAX's weights, a random bf16 initial memory, xs and the loss's
    weights."""
    rng = np.random.default_rng(3)
    jcfg, _ = _sdnc_cfgs("bfloat16")
    jparams = _numpy(jdnc.init_params(jax.random.PRNGKey(2), jcfg))
    js = _numpy(jdnc.init_state(B, jcfg))
    mem = rng.standard_normal(js.memory.shape).astype(np.float32)
    mem[:, N] = 0.0
    mem = np.asarray(jnp.asarray(mem).astype(jnp.bfloat16))
    xs = rng.standard_normal((T, B, D)).astype(np.float32)
    r_mem = rng.standard_normal(mem.shape).astype(np.float32)
    return jparams, js, mem, xs, r_mem


def _sdnc_loss(final, ys, r_mem, f32):
    return ((ys ** 2).sum() + (f32(final.memory) * r_mem).sum()
            + (final.n_mat.vals ** 2).sum() + (final.read_words ** 2).sum())


@functools.lru_cache(maxsize=None)
def _jax_sdnc_grads(backend, mode):
    """(loss, grads: the parameters in `jax.tree.leaves` order, the
    initial memory, xs) of JAX's SDNC `unroll` on bf16 rows."""
    jparams, js, mem, xs, r_mem = _sdnc_inputs()
    jcfg, _ = _sdnc_cfgs("bfloat16", backend)
    cell = JaxSDNCCell(jcfg)

    def loss(p, m, x):
        final, ys = junroll.unroll(cell, p, js._replace(memory=m), x,
                                   mode=mode)
        return _sdnc_loss(final, ys, r_mem, lambda t: t.astype(jnp.float32))

    val, (gp, gm, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        jparams, mem, xs)
    return float(val), [np.asarray(g, np.float32)
                        for g in [*jax.tree.leaves(gp), gm, gx]]


def _gap(got, want) -> float:
    return max(float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
               for a, b in zip(got, want))


@functools.lru_cache(maxsize=None)
def _sdnc_bar() -> float:
    """Twice JAX's own spread: the largest gap between two of its four
    runs (naive and sparse, ``ref`` and ``pallas-interpret``)."""
    runs = [_jax_sdnc_grads(be, mode) for be in BACKENDS
            for mode in ("naive", "sparse")]
    return 2 * max(_gap([np.float32(a[0]), *a[1]], [np.float32(b[0]), *b[1]])
                   for i, a in enumerate(runs) for b in runs[i + 1:])


@pytest.mark.parametrize("mode,chunk", [("naive", None), ("sparse", None),
                                        ("chunked", 2)])
def test_sdnc_bf16_unroll_grads_match_jax(mode, chunk):
    """The SDNC trained on bf16 rows: the port's loss and gradients
    (parameters, the initial bf16 memory, xs) in each mode against JAX's
    naive and sparse unrolls under both backends, within `_sdnc_bar`; the
    memory's gradient is bf16; the rollback gives the memory, N_t and P_t
    back bit for bit."""
    jparams, js, mem, xs, r_mem = _sdnc_inputs()
    _, cfg = _sdnc_cfgs("bfloat16")
    params = convert.params_from_jax(jparams, device="cpu")
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.requires_grad_() for p in leaves]
    m0 = convert.memory_from_jax(mem, device="cpu").requires_grad_()
    x = torch.tensor(xs, requires_grad=True)
    s0 = convert.dnc_state_from_jax(js, device="cpu")._replace(
        memory=m0.clone())
    links = [t.clone() for t in (*s0.n_mat, *s0.p_mat)]
    final, ys = unroll_lib.unroll(SDNCCell(cfg),
                                  pytree.tree_unflatten(leaves, spec), s0, x,
                                  mode=mode, chunk=chunk)
    loss = _sdnc_loss(final, ys, torch.tensor(r_mem), torch.Tensor.float)
    inputs = [*leaves, m0, x]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(i) if g is None else g
             for i, g in zip(inputs, grads)]
    assert grads[-2].dtype == torch.bfloat16
    if mode != "naive":
        assert torch.equal(_bits(s0.memory), _bits(m0.detach()))
        for t, t0 in zip((*s0.n_mat, *s0.p_mat), links):
            assert torch.equal(t, t0)
    g_params = pytree.tree_unflatten(
        [g.numpy() for g in grads[:len(leaves)]], spec)
    got = [np.asarray(g) for g in jax.tree.leaves(g_params)] + [
        g.float().numpy() for g in grads[len(leaves):]]
    for backend in BACKENDS:
        for j_mode in ("naive", "sparse"):
            j_loss, j_grads = _jax_sdnc_grads(backend, j_mode)
            assert len(got) == len(j_grads)
            if backend == "ref":
                np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
            assert _gap([np.float32(loss.item()), *got],
                        [np.float32(j_loss), *j_grads]) <= _sdnc_bar()


# --------------------------------------------------------------------------
# The plain versions of the row scatter on bf16 and int8 rows
# --------------------------------------------------------------------------

def _scatter_case(dups, seed=0, J=12):
    rng = np.random.default_rng(seed)
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    hi = 3 if dups == "heavy" else N
    idx = rng.integers(0, hi, (B, J)).astype(np.int32)
    idx[:, 7] = idx[:, 2]                  # a row named twice, at least
    rows = (3 * rng.standard_normal((B, J, W))).astype(np.float32)
    return mem, idx, rows


@pytest.mark.parametrize("mode", ["add", "set"])
@pytest.mark.parametrize("dups", ["some", "heavy"])
def test_bf16_scatter_rows_matches_jax_oracle(dups, mode):
    """bf16 rows: each column rounded to bf16 and added in j order,
    rounding after each add (the oracle's scatter-add), or the last column
    set; bit for bit, f32 rows cast first as JAX casts them."""
    mem, idx, rows = _scatter_case(dups)
    jm = jnp.asarray(mem).astype(jnp.bfloat16)
    want = jref.scatter_rows_ref(jm, jnp.asarray(idx), jnp.asarray(rows),
                                 mode)
    got = convert.memory_from_jax(jm, device="cpu")
    out = ops.scatter_rows(got, torch.tensor(idx), torch.tensor(rows), mode)
    assert out is got and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits(got).numpy(),
        _bits(convert.memory_from_jax(want, device="cpu")).numpy())


@pytest.mark.parametrize("case", ["restore", "set_float", "add"])
@pytest.mark.parametrize("dups", ["some", "heavy"])
def test_int8_scatter_rows_matches_jax_oracle(dups, case):
    """`ref.scatter_rows_q_ref` against `scatter_rows_q_ref`: a restore of
    recorded int8 (row, scale) pairs bit for bit (the last duplicate
    wins); float rows quantized once ('set') or accumulated in f32 and
    quantized once ('add'), codes exact and scales within 1e-6; untouched
    rows keep their bits."""
    mem, idx, rows = _scatter_case(dups, seed=1)
    jq, js = jax.jit(jquant.quantize_rows)(jnp.asarray(mem))
    kw, mode = {}, "add" if case == "add" else "set"
    if case == "restore":
        rq, rs = jax.jit(jquant.quantize_rows)(jnp.asarray(rows))
        rows, kw = np.asarray(rq), {"rows_scale": np.asarray(rs)}
    want_q, want_s = jax.jit(functools.partial(
        jref.scatter_rows_q_ref, mode=mode))(
        jq, js, jnp.asarray(idx), jnp.asarray(rows),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    q, s = torch.tensor(np.asarray(jq)), torch.tensor(np.asarray(js))
    out = ops.scatter_rows(q, torch.tensor(idx), torch.tensor(rows), mode,
                           mem_scale=s, **{k: torch.tensor(v)
                                           for k, v in kw.items()})
    assert out[0] is q and out[1] is s
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    if case == "restore":
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    else:
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-6,
                                   atol=0)
    untouched = np.ones(N + 1, bool)
    for b in range(B):
        mask = untouched.copy()
        mask[idx[b]] = False
        np.testing.assert_array_equal(q[b, mask].numpy(),
                                      np.asarray(jq)[b, mask])


def test_int8_scatter_rows_refuses_what_it_cannot_do():
    mem, idx, rows = _scatter_case("some")
    q, s = quant.quantize_rows(torch.tensor(mem))
    with pytest.raises(ValueError, match="rows_scale"):
        ops.scatter_rows(q, torch.tensor(idx), q[:, :12].clone(), "set",
                         mem_scale=s)
    with pytest.raises(ValueError, match="no gradient"):
        ops.scatter_rows(q, torch.tensor(idx),
                         torch.tensor(rows, requires_grad=True), "add",
                         mem_scale=s)


# --------------------------------------------------------------------------
# The scale's gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "zero"])
def test_scale_vjp_matches_jax(case):
    """`quant.scale_vjp` against `jax.vjp` of JAX's quantizer's scale: the
    cotangent split evenly among tied maxima of |x|, times the derivative
    of |x|, which JAX takes as +1 at 0: a zero row's W elements share it."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 7, W)).astype(np.float32)
    if case == "ties":
        x[:, :, 3] = np.abs(x).max(-1) + 1.0
        x[:, :, 9] = -x[:, :, 3]           # |x| tied, opposite signs
        x[:, 2, 11] = x[:, 2, 3]           # three ties in one row
    elif case == "zero":
        x[:, ::2] = 0.0
    g = rng.standard_normal((5, 7)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jquant.quantize_rows(v)[1], jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    got = quant.scale_vjp(torch.tensor(x), torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                               rtol=1e-6)
    if case == "zero":
        np.testing.assert_allclose(got[:, ::2].numpy(), np.broadcast_to(
            g[:, ::2, None] * quant.INV_QMAX / W, got[:, ::2].shape),
            rtol=1e-6)
        return
    # And against autograd through the port's own quantizer (torch's |x|
    # has derivative 0 at 0, so not on the zero rows).
    xt = torch.tensor(x, requires_grad=True)
    auto, = torch.autograd.grad(quant.quantize_rows(xt)[1], xt,
                                torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), auto.numpy(), atol=1e-7,
                               rtol=1e-6)
