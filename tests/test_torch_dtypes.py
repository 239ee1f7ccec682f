"""bf16 and int8 memory rows in the port (`MemoryConfig.mem_dtype`) against
the JAX package, on the CPU: the quantizer, the int8 and bf16 writes, both
reads on bf16 and int8 rows, the 6-step SAM unroll (exact and LSH read),
int8 ``collect_deltas``, the converter, and the refusal to train on such
rows.

Sizes: B = 2, W = 16 (int8 rows take W % 16 on the card), H = 2 to 4,
K = 4, N = 128 to 1024, hidden 16, the copy task with max_len 2 (T = 6).
Inputs come from a numpy seed; bf16 rows and int8 codes and scales are
made on the JAX side and carried across by `repro_torch.convert`. Pallas
kernels run in interpret mode (``backend="pallas-interpret"``).

Tolerances, each with its reason:
* the quantizer and the writes, on the same inputs: bit for bit against
  the compiled JAX code (``jax.jit``: XLA turns ``max / 127`` into a
  product with fl(1/127), and contracts `_kernel_q`'s ``acc + w·a`` into
  an FMA; the port does both). The JAX int8 oracle adds a row's columns
  with an einsum and then to the old row, so against it the codes are
  exact and the scales within rtol 1e-6 (a few ulp);
* the reads: indices exact, floats within 1e-5 (another summation order);
* the unroll: integers exact (bf16 row bits, int8 codes, usage, buckets,
  cursors), outputs within 1e-5, int8 scales within rtol 1e-6: the
  controller's f32 sums differ in the last bits between torch and XLA
  (the f32 unroll's memory differs in its last bit too), and a scale
  carries that. bf16 against the ``ref`` backend only: JAX's Pallas bf16
  write rounds w·a and each add otherwise (ROADMAP §C).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import quant as jquant
from repro.core import sam as jsam
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sparse_write import sparse_write_update as jax_write
from repro_torch import convert
from repro_torch.core import quant, sam, training
from repro_torch.core import unroll as unroll_lib
from repro_torch.core.cell import SAMCell
from repro_torch.core.types import ControllerConfig, LSTMState, MemoryConfig
from repro_torch.data.tasks import copy_task
from repro_torch.kernels import ops, ref

TOL = 1e-5
SCALE_RTOL = 1e-6
B, W, HIDDEN, BITS, MAX_LEN = 2, 16, 16, 4, 2
LSH = dict(ann="lsh", lsh_tables=2, lsh_bits=3, lsh_bucket_size=8)


def _t(x):
    """numpy/JAX array -> CPU tensor (bf16 through `convert`)."""
    if str(np.asarray(x).dtype) == "bfloat16":
        return convert.memory_from_jax(x, device="cpu")
    return torch.tensor(np.asarray(x))


def _storage(mem_f32, dtype):
    """f32 rows -> the JAX storage: (rows, scales or None)."""
    if dtype == "bfloat16":
        return jnp.asarray(mem_f32).astype(jnp.bfloat16), None
    return jax.jit(jquant.quantize_rows)(jnp.asarray(mem_f32))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# --------------------------------------------------------------------------
# The quantizer
# --------------------------------------------------------------------------

def _quant_rows(case):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 7, W)) * 3).astype(np.float32)
    if case == "halves":
        # A power-of-two scale: row / scale hits k + 1/2 exactly.
        s = np.float32(2.0 ** -3)
        x[:] = s * np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                             -3.5, 4.5, 0, 126.5, -126.5, 5.5, 6.5, -127],
                            np.float32)
    elif case == "clip":
        x[:, :, 0] = 1e30                  # the max; the rest round to 0
        x[:, :, 1] = -1e30
    elif case == "zero":
        x[:, ::2] = 0.0
    return x


@pytest.mark.parametrize("case", ["random", "halves", "clip", "zero"])
def test_quantize_rows_matches_jax(case):
    x = _quant_rows(case)
    jq, js = jax.jit(jquant.quantize_rows)(jnp.asarray(x))
    q, s = quant.quantize_rows(torch.tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # Eager JAX divides by 127 and may differ in a scale's last bit; its
    # codes are the same.
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jquant.quantize_rows(jnp.asarray(x))[0]))
    deq = quant.dequantize_rows(q, s)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jax.jit(jquant.dequantize_rows)(jq, js)))
    if case == "halves":                   # half to even
        assert q[0, 0, :4].tolist() == [127, 0, 2, 2]
    if case == "zero":
        assert (s[:, ::2] == 0).all() and (deq[:, ::2] == 0).all()
        assert not torch.signbit(deq[:, ::2]).any()


# --------------------------------------------------------------------------
# The writes
# --------------------------------------------------------------------------

def _write_case(dups, N=300, H=4, K=4, seed=0, width=W):
    rng = np.random.default_rng(seed)
    J = H * (K + 1)
    mem = rng.standard_normal((B, N + 1, width)).astype(np.float32)
    la = rng.integers(-50, 50, (B, N + 1)).astype(np.int32)
    hi = N if dups == "some" else 3
    widx = rng.integers(0, hi, (B, H, K + 1)).astype(np.int32)
    if dups == "some":
        widx[:, 1, 0] = widx[:, 0, 2]      # a duplicate across heads
        widx[:, 1, K] = widx[:, 0, 1]      # an LRA row that was also read
    lra = widx[:, :, K].copy()
    ww = rng.random((B, J)).astype(np.float32)
    ww[:, 3] = 0.001                       # below delta: no usage stamp
    a = rng.standard_normal((B, H, width)).astype(np.float32)
    return mem, la, widx.reshape(B, J), ww, a, lra


def _step(lane):
    return (np.array([60, 7], np.int32) if lane == "per_lane"
            else np.int32(60))


@pytest.mark.parametrize("lane", ["scalar", "per_lane"])
@pytest.mark.parametrize("dups", ["some", "heavy"])
def test_int8_write_matches_kernel_q_and_oracle(dups, lane):
    mem, la, widx, ww, a, lra = _write_case(dups)
    N = mem.shape[1] - 1
    step = _step(lane)
    jq, js = _storage(mem, "int8")
    args = [jnp.asarray(x) for x in (la, widx, ww, a, lra)]
    k_mem, k_la, k_s = jax_write(jq, *args, jnp.asarray(step), delta=0.005,
                                 interpret=True, scratch_row=N, mem_scale=js)
    o_mem, o_la, o_s = jref.sparse_write_update_q_ref(
        jq, js, args[0], *args[1:], jnp.asarray(step), 0.005)
    q, s, l = _t(jq), _t(js), _t(la)
    out = ops.sparse_write_update(q, l, *(_t(x) for x in (widx, ww, a, lra)),
                                  torch.tensor(step), delta=0.005,
                                  mem_scale=s)
    assert out[0] is q and out[1] is l and out[2] is s      # in place
    # The TPU kernel in interpret mode, bit for bit.
    np.testing.assert_array_equal(q.numpy(), np.asarray(k_mem))
    np.testing.assert_array_equal(s.numpy(), np.asarray(k_s))
    np.testing.assert_array_equal(l.numpy(), np.asarray(k_la))
    # The oracle: codes exact, scales within a few ulp.
    np.testing.assert_array_equal(q.numpy(), np.asarray(o_mem))
    np.testing.assert_array_equal(l.numpy(), np.asarray(o_la))
    np.testing.assert_allclose(s.numpy(), np.asarray(o_s), rtol=SCALE_RTOL,
                               atol=0)
    assert torch.equal(q[:, N], _t(jq)[:, N])              # scratch row
    assert torch.equal(s[:, N], _t(js)[:, N])


@pytest.mark.parametrize("width,K", [(24, 4), (16, 8), (24, 8)])
@pytest.mark.parametrize("lane", ["scalar", "per_lane"])
def test_int8_write_matches_kernel_q_at_other_shapes(width, K, lane):
    """The int8 write's plain version against `_kernel_q` in interpret mode,
    codes, scales and usage bit for bit, at the CUDA kernel's other edge
    shapes: W = 24 (not a multiple of 16: its single-code path) and J = 36
    (K = 8, the LM's columns)."""
    mem, la, widx, ww, a, lra = _write_case("some", K=K, seed=width + K,
                                            width=width)
    N = mem.shape[1] - 1
    step = _step(lane)
    jq, js = _storage(mem, "int8")
    args = [jnp.asarray(x) for x in (la, widx, ww, a, lra)]
    k_mem, k_la, k_s = jax_write(jq, *args, jnp.asarray(step), delta=0.005,
                                 interpret=True, scratch_row=N, mem_scale=js)
    q, s, l = _t(jq), _t(js), _t(la)
    ops.sparse_write_update(q, l, *(_t(x) for x in (widx, ww, a, lra)),
                            torch.tensor(step), delta=0.005, mem_scale=s)
    np.testing.assert_array_equal(q.numpy(), np.asarray(k_mem))
    np.testing.assert_array_equal(s.numpy(), np.asarray(k_s))
    np.testing.assert_array_equal(l.numpy(), np.asarray(k_la))
    assert torch.equal(q[:, N], _t(jq)[:, N])              # scratch row


@pytest.mark.parametrize("lane", ["scalar", "per_lane"])
@pytest.mark.parametrize("dups", ["some", "heavy"])
def test_bf16_write_matches_oracle(dups, lane):
    mem, la, widx, ww, a, lra = _write_case(dups, seed=1)
    step = _step(lane)
    jm, _ = _storage(mem, "bfloat16")
    o_mem, o_la = jref.sparse_write_update_ref(     # a per-lane step as (B, 1)
        jm, *(jnp.asarray(x) for x in (la, widx, ww, a, lra)),
        jnp.asarray(step).reshape(-1, 1) if step.ndim else step, 0.005)
    m, l = _t(jm), _t(la)
    assert m.dtype == torch.bfloat16
    ops.sparse_write_update(m, l, *(_t(x) for x in (widx, ww, a, lra)),
                            torch.tensor(step), delta=0.005)
    assert m.dtype == torch.bfloat16
    assert torch.equal(_bits(m), _bits(_t(o_mem)))
    np.testing.assert_array_equal(l.numpy(), np.asarray(o_la))


# --------------------------------------------------------------------------
# The reads
# --------------------------------------------------------------------------

def _read_case(dtype, read, N=1024, H=2, C=24, seed=2):
    rng = np.random.default_rng(seed)
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    mem[:, 5] = mem[:, 9]                  # a tie
    mem[:, 11] = 0.0                       # a zero row
    q = rng.standard_normal((B, H, W)).astype(np.float32)
    beta = (1.0 + rng.random((B, H))).astype(np.float32)
    jm, js = _storage(mem, dtype)
    cand = None
    if read == "cand":
        c = rng.integers(-1, N, (B, H, C)).astype(np.int32)
        c[:, :, 3] = c[:, :, 0]            # a duplicate, deduped below
        cand = ref.dedup(torch.tensor(c)).numpy()
    return q, jm, js, beta, cand


@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
@pytest.mark.parametrize("read", ["exact", "cand"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reads_match_jax(dtype, read, backend):
    q, jm, js, beta, cand = _read_case(dtype, read)
    N = jm.shape[1] - 1
    kw = {} if cand is None else {"cand_idx": jnp.asarray(cand)}
    if cand is None:
        kw["valid_n"] = N
    j_read, j_w, j_idx = jops.fused_read(
        jnp.asarray(q), jm, jnp.asarray(beta), 4, backend=backend,
        mem_scale=js, **kw)
    kw = {"valid_n": N} if cand is None else {"cand_idx": _t(cand)}
    read_, w, idx = ops.fused_read(_t(q), _t(jm), _t(beta), 4,
                                   mem_scale=None if js is None else _t(js),
                                   **kw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(read_.numpy(), np.asarray(j_read), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("read", ["exact", "cand"])
def test_all_zero_int8_memory_reads_exact_zero(read):
    q, jm, js, beta, cand = _read_case("int8", read, N=64)
    mem = torch.zeros(_t(jm).shape, dtype=torch.int8)
    scale = torch.zeros(mem.shape[:2])
    kw = ({"valid_n": 64} if cand is None
          else {"cand_idx": torch.tensor(cand)})
    read_, w, _ = ops.fused_read(_t(q), mem, _t(beta), 4, mem_scale=scale,
                                 **kw)
    assert read_.eq(0).all() and not torch.signbit(read_).any()
    assert torch.isfinite(w).all()


# --------------------------------------------------------------------------
# The SAM cell
# --------------------------------------------------------------------------

def _sam_configs(dtype, ann, backend, N=128, H=2, K=4):
    extra = LSH if ann == "lsh" else {}
    jcfg = jsam.SAMConfig(
        JaxMemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K,
                        backend=backend, mem_dtype=dtype, **extra),
        JaxControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                            output_size=BITS))
    cfg = sam.SAMConfig(
        MemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K,
                     mem_dtype=dtype, **extra),
        ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                         output_size=BITS))
    return jcfg, cfg


def _xs():
    seq = np.random.default_rng(0).integers(0, 2, (B, MAX_LEN, BITS))
    inputs, _, _ = copy_task(B, MAX_LEN, MAX_LEN, BITS, seq=seq, device="cpu")
    return inputs.transpose(0, 1).contiguous()                 # (T, B, D)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_state_matches(state, jstate):
    np.testing.assert_array_equal(_bits(state.memory).numpy(),
                                  np.asarray(_bits(_t(jstate.memory))))
    np.testing.assert_array_equal(state.last_access.numpy(),
                                  np.asarray(jstate.last_access))
    if jstate.mem_scale is None:
        assert state.mem_scale is None
    else:
        np.testing.assert_allclose(state.mem_scale.numpy(),
                                   np.asarray(jstate.mem_scale),
                                   rtol=SCALE_RTOL, atol=0)
        assert state.mem_scale[:, -1].eq(0).all()
    if jstate.ann is not None:
        np.testing.assert_array_equal(state.ann.buckets.numpy(),
                                      np.asarray(jstate.ann.buckets))
        np.testing.assert_array_equal(state.ann.cursor.numpy(),
                                      np.asarray(jstate.ann.cursor))


@pytest.mark.parametrize("dtype,ann,backend", [
    ("bfloat16", "exact", "ref"), ("bfloat16", "lsh", "ref"),
    ("int8", "exact", "ref"), ("int8", "exact", "pallas-interpret"),
    ("int8", "lsh", "ref"), ("int8", "lsh", "pallas-interpret")])
def test_sam_unroll_matches_jax_every_step(dtype, ann, backend):
    jcfg, cfg = _sam_configs(dtype, ann, backend)
    jparams = jsam.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jsam.init_state(B, jcfg)
    params = convert.params_from_jax(_numpy(jparams), device="cpu")
    state = convert.state_from_jax(_numpy(jstate), device="cpu")
    assert state.memory.dtype == getattr(torch, dtype)
    fresh = sam.init_state(B, cfg, device="cpu")
    assert fresh.memory.dtype == state.memory.dtype
    assert (fresh.mem_scale is None) == (state.mem_scale is None)
    xs = _xs()
    step = jax.jit(lambda p, s, x: jsam.sam_step(p, jcfg, s, x))
    for x in xs:
        jstate, jy = step(jparams, jstate, jnp.asarray(x.numpy()))
        state, y = sam.sam_step(params, cfg, state, x)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_array_equal(state.read.indices.numpy(),
                                      np.asarray(jstate.read.indices))
        _assert_state_matches(state, jstate)
    # The forward entry points run the same steps.
    model = sam.SAM(cfg, params, device="cpu")
    final, ys = model(convert.state_from_jax(
        _numpy(jsam.init_state(B, jcfg)), device="cpu"), xs)
    j_final, j_ys = jax.jit(lambda p, s, x: jsam.sam_unroll(p, jcfg, s, x))(
        jparams, jsam.init_state(B, jcfg), jnp.asarray(xs.numpy()))
    np.testing.assert_allclose(ys.numpy(), np.asarray(j_ys), atol=TOL,
                               rtol=TOL)
    _assert_state_matches(final, j_final)


@pytest.mark.parametrize("ann", ["exact", "lsh"])
def test_int8_collect_deltas_match_jax(ann):
    jcfg, cfg = _sam_configs("int8", ann, "ref")
    jparams = jsam.init_params(jax.random.PRNGKey(1), jcfg)
    jstate = jsam.init_state(B, jcfg)
    params = convert.params_from_jax(_numpy(jparams), device="cpu")
    state = convert.state_from_jax(_numpy(jstate), device="cpu")
    step = jax.jit(lambda p, s, x: jsam.sam_step(p, jcfg, s, x,
                                                 collect_deltas=True))
    for x in _xs()[:4]:
        jstate, _, jd = step(jparams, jstate, jnp.asarray(x.numpy()))
        with torch.no_grad():
            state, _, d = sam.sam_step(params, cfg, state, x,
                                       collect_deltas=True)
        np.testing.assert_array_equal(d.write_idx.numpy(),
                                      np.asarray(jd.write_idx))
        assert d.old_rows.dtype == torch.int8
        np.testing.assert_array_equal(d.old_rows.numpy(),
                                      np.asarray(jd.old_rows))
        np.testing.assert_allclose(d.old_scale.numpy(),
                                   np.asarray(jd.old_scale),
                                   rtol=SCALE_RTOL, atol=0)
        np.testing.assert_array_equal(d.read_idx.numpy(),
                                      np.asarray(jd.read_idx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_state_from_jax_keeps_dtype_and_bits(dtype):
    jcfg, cfg = _sam_configs(dtype, "lsh", "ref", N=32)
    jstate = jsam.init_state(B, jcfg)
    rng = np.random.default_rng(3)
    rows = rng.standard_normal(jstate.memory.shape).astype(np.float32)
    if dtype == "int8":
        mem, scale = _storage(rows, "int8")
        jstate = jstate._replace(memory=mem, mem_scale=scale)
    else:
        jstate = jstate._replace(memory=jnp.asarray(rows).astype(dtype))
    state = convert.state_from_jax(_numpy(jstate), device="cpu")
    assert state.memory.dtype == getattr(torch, dtype)
    want = np.asarray(jstate.memory)
    if dtype == "bfloat16":                # compare the 16-bit patterns
        want = want.view(np.int16)
    np.testing.assert_array_equal(_bits(state.memory).numpy(), want)
    if dtype == "int8":
        assert state.mem_scale.dtype == torch.float32
        np.testing.assert_array_equal(state.mem_scale.numpy(),
                                      np.asarray(jstate.mem_scale))
    else:
        assert state.mem_scale is None
    with torch.inference_mode():           # it steps as a state of its cfg
        sam.sam_step(convert.params_from_jax(
            _numpy(jsam.init_params(jax.random.PRNGKey(0), jcfg)),
            device="cpu"), cfg, state, _xs()[0])


# --------------------------------------------------------------------------
# What is not ported is refused
# --------------------------------------------------------------------------

def test_mem_dtype_is_checked():
    with pytest.raises(ValueError, match="mem_dtype='float16'"):
        MemoryConfig(mem_dtype="float16")
    _, cfg = _sam_configs("bfloat16", "exact", "ref", N=32)
    _, cfg8 = _sam_configs("int8", "exact", "ref", N=32)
    params = sam.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    x = _xs()[0]
    for c, s in ((cfg, sam.init_state(B, cfg8, device="cpu")),
                 (cfg8, sam.init_state(B, cfg, device="cpu"))):
        with pytest.raises(ValueError, match="mem_scale"):
            sam.sam_step(params, c, s, x)


# --------------------------------------------------------------------------
# Training on bf16 and int8 rows (ROADMAP.md A6b), against JAX
# --------------------------------------------------------------------------

TRAIN_N, TRAIN_H, TRAIN_K, TRAIN_T = 32, 2, 2, 5
BACKENDS = ("ref", "pallas-interpret")
# Gradients on int8 rows: the JAX suite's own bar between its modes
# (`tests/test_int8_memory.py:276-279`, atol 2e-5), taken of the leaf's
# max(1, |g|), with the port's rtol 1e-5. The initial scales' gradient,
# Σ_w g_w·code_w with codes up to 127, reaches 1e2 here and cancels to ~1
# in places, where the f32 drift of g_w between torch and XLA, times the
# codes, reaches 4e-5 (`_int8_close`).
INT8_ATOL, INT8_RTOL = 2e-5, 1e-5


def _int8_close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=INT8_RTOL,
        atol=INT8_ATOL * max(1.0, float(np.abs(want).max())))


def _train_configs(dtype, backend="ref", ann="exact"):
    return _sam_configs(dtype, ann, backend, N=TRAIN_N, H=TRAIN_H,
                        K=TRAIN_K)


def _train_inputs(dtype, ann="exact", seed=0):
    """Weights from the JAX init; a random initial memory (bf16 rows, or
    int8 codes and scales quantized by the compiled JAX quantizer; scratch
    row zero), controller state and previous read; xs and the loss's
    weights from numpy. The float leaves that get a gradient: the bf16
    memory or the int8 scales, h, c, the read words and weights. An LSH
    cell's index is JAX's `ann_build` of the initial memory."""
    from repro.core import ann as jann
    rng = np.random.default_rng(seed)
    jcfg, _ = _train_configs(dtype, ann=ann)
    jparams = _numpy(jsam.init_params(jax.random.PRNGKey(seed), jcfg))
    jstate = _numpy(jsam.init_state(B, jcfg))
    mem = rng.standard_normal((B, TRAIN_N + 1, W)).astype(np.float32)
    mem[:, TRAIN_N] = 0.0
    rows, scale = _storage(mem, dtype)
    floats = {"mem_scale": np.asarray(scale)} if dtype == "int8" else \
        {"memory": np.asarray(rows)}
    if dtype == "int8":
        jstate = jstate._replace(memory=np.asarray(rows))
    floats.update(
        h=0.5 * rng.standard_normal((B, HIDDEN)).astype(np.float32),
        c=0.5 * rng.standard_normal((B, HIDDEN)).astype(np.float32),
        words=rng.standard_normal((B, TRAIN_H, W)).astype(np.float32),
        weights=rng.dirichlet(np.ones(TRAIN_K),
                              (B, TRAIN_H)).astype(np.float32))
    if ann == "lsh":
        jstate = jstate._replace(ann=_numpy(jann.ann_build(
            jnp.asarray(jparams["lsh_planes"]), jnp.asarray(rows),
            jcfg.memory, partitions=1)))
    xs = rng.integers(0, 2, (TRAIN_T, B, BITS + 2)).astype(np.float32)
    r = rng.standard_normal((B, TRAIN_N + 1) + ((W,) if dtype != "int8"
                                                 else ())).astype(np.float32)
    return jparams, jstate, floats, xs, r


def _buffer(dtype):
    return "mem_scale" if dtype == "int8" else "memory"


def _train_loss(final, ys, r, dtype, f32):
    """Reads the outputs, the final controller state and the final
    memory (int8: its scales), made f32 by ``f32``."""
    return ((ys ** 2).sum() + (final.ctrl.h ** 2).sum()
            + (f32(getattr(final, _buffer(dtype))) * r).sum())


def _jax_with(jstate, f):
    from repro.core.types import LSTMState as JaxLSTMState
    s = jstate._replace(ctrl=JaxLSTMState(h=f["h"], c=f["c"]),
                        read=jstate.read._replace(words=f["words"],
                                                  weights=f["weights"]))
    return s._replace(**{k: f[k] for k in ("memory", "mem_scale") if k in f})


@functools.lru_cache(maxsize=None)
def _jax_train_grads(dtype, backend, mode, ann="exact"):
    """(loss, grads as a flat list of f32 numpy arrays: the parameters in
    `jax.tree.leaves` order, the float leaves, xs) of JAX's `unroll`."""
    from repro.core import unroll as junroll
    from repro.core.cell import SAMCell as JaxSAMCell
    jparams, jstate, floats, xs, r = _train_inputs(dtype, ann)
    jcfg, _ = _train_configs(dtype, backend, ann)
    cell = JaxSAMCell(jcfg)

    def loss(p, f, x):
        final, ys = junroll.unroll(cell, p, _jax_with(jstate, f), x,
                                   mode=mode)
        return _train_loss(final, ys, r, dtype,
                           lambda t: t.astype(jnp.float32))

    val, (gp, gf, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        jparams, floats, xs)
    return float(val), [np.asarray(g, np.float32) for g in
                        [*jax.tree.leaves(gp), *(gf[k] for k in floats), gx]]


def _port_train_grads(dtype, mode, ann="exact"):
    """The port's (loss, grads in `_jax_train_grads`' order, the initial
    state the unroll ran from, the initial float leaves)."""
    jparams, jstate, floats, xs, r = _train_inputs(dtype, ann)
    _, cfg = _train_configs(dtype, ann=ann)
    params = convert.params_from_jax(jparams, device="cpu")
    p_leaves, p_spec = pytree.tree_flatten(params)
    p_leaves = [p.requires_grad_() for p in p_leaves]
    f = {k: _t(v).requires_grad_() for k, v in floats.items()}
    x = torch.tensor(xs, requires_grad=True)
    s0 = convert.state_from_jax(jstate, device="cpu")
    buf = _buffer(dtype)
    # The unroll updates the memory (or the scales) in place: a copy.
    s0 = s0._replace(ctrl=LSTMState(h=f["h"], c=f["c"]),
                     read=s0.read._replace(words=f["words"],
                                           weights=f["weights"]),
                     **{buf: f[buf].clone()})
    final, ys = unroll_lib.unroll(SAMCell(cfg),
                                  pytree.tree_unflatten(p_leaves, p_spec),
                                  s0, x, mode=mode, chunk=2)
    loss = _train_loss(final, ys, torch.tensor(r), dtype, torch.Tensor.float)
    inputs = [*p_leaves, *f.values(), x]
    grads = [torch.zeros_like(i) if g is None else g for i, g in zip(
        inputs, torch.autograd.grad(loss, inputs, allow_unused=True))]
    g_params = pytree.tree_unflatten(
        [g.float().numpy() for g in grads[:len(p_leaves)]], p_spec)
    return (loss.item(),
            [np.asarray(g) for g in jax.tree.leaves(g_params)]
            + [g.float().numpy() for g in grads[len(p_leaves):]], s0, f)


def _gap(got, want) -> float:
    """The largest |got - want| over max(1, |want|), element by element,
    over every leaf."""
    return max(float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
               for a, b in zip(got, want))


def _spread(runs) -> float:
    """The largest `_gap` between two of JAX's runs (loss, grads)."""
    return max(_gap([np.float32(a[0]), *a[1]], [np.float32(b[0]), *b[1]])
               for i, a in enumerate(runs) for b in runs[i + 1:])


@functools.lru_cache(maxsize=None)
def _bf16_bar(ann="exact") -> float:
    """Twice JAX's own spread on the same inputs: the largest gap between
    two of its four runs, naive and sparse under ``ref`` and
    ``pallas-interpret``. Its sparse-against-naive gap alone can be 0
    (under ``ref`` both modes round alike: XLA keeps bf16 sums in f32
    within a fusion), while the port rounds each add into its one bf16
    cotangent in j order and JAX's Pallas bf16 write rounds otherwise
    (ROADMAP §C)."""
    return 2 * _spread([_jax_train_grads("bfloat16", be, mode, ann)
                        for be in BACKENDS for mode in ("naive", "sparse")])


def _check_train_grads(dtype, mode, ann="exact"):
    loss, grads, s0, f = _port_train_grads(dtype, mode, ann)
    buf = _buffer(dtype)
    if mode != "naive":
        # The rollback gave the buffer back bit for bit.
        assert torch.equal(_bits(getattr(s0, buf)), _bits(f[buf].detach()))
    for backend in BACKENDS:
        for j_mode in ("naive", "sparse"):
            j_loss, j_grads = _jax_train_grads(dtype, backend, j_mode, ann)
            assert len(grads) == len(j_grads)
            if dtype == "int8":
                np.testing.assert_allclose(loss, j_loss, rtol=TOL)
                for g, want in zip(grads, j_grads):
                    _int8_close(g, want)
                continue
            # bf16: the forward is the oracle's bit for bit (ROADMAP.md §C:
            # the Pallas bf16 write rounds otherwise).
            if backend == "ref":
                np.testing.assert_allclose(loss, j_loss, rtol=TOL)
            assert _gap([np.float32(loss), *grads],
                        [np.float32(j_loss), *j_grads]) <= _bf16_bar(ann)
    if dtype == "int8" and mode != "naive":
        for g, want in zip(grads, _port_train_grads(dtype, "naive", ann)[1]):
            _int8_close(g, want)


def _acc_like(jparams, rng):
    return jax.tree.map(
        lambda p: (0.01 + rng.random(p.shape)).astype(np.float32) * 1e-3,
        jparams)


def _check_three_train_steps(dtype):
    """Three RMSProp steps of ``sam`` on the copy task, the port and JAX
    from the same weights, optimizer state and batches: losses, bit
    errors, weights and accumulators."""
    from repro.core.training import ModelSpec as JaxModelSpec
    from repro.core.training import make_task_train_step as jax_train_step
    from repro.optim import optimizers as jopt
    jcfg, cfg = _train_configs(dtype)
    rng = np.random.default_rng(7)
    j_init, _, j_step = jax_train_step(
        JaxModelSpec("sam", jcfg.memory, jcfg.controller), 1e-3)
    _, _, step = training.make_task_train_step(
        training.ModelSpec("sam", cfg.memory, cfg.controller), 1e-3,
        device="cpu")
    jparams = _numpy(j_init(jax.random.PRNGKey(3)))
    j_opt = jopt.RMSPropState(acc=_acc_like(jparams, rng))
    params = convert.params_from_jax(jparams, device="cpu")
    opt_state = convert.opt_state_from_jax(j_opt, device="cpu")
    j_step = jax.jit(j_step)
    for n in (MAX_LEN, 1, MAX_LEN):
        seq = rng.integers(0, 2, (B, MAX_LEN, BITS))
        batch = copy_task(B, n, MAX_LEN, BITS, seq=seq, device="cpu")
        jparams, j_opt, j_loss, j_err = j_step(
            jparams, j_opt, *(jnp.asarray(t.numpy()) for t in batch))
        params, opt_state, loss, err = step(params, opt_state, *batch)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL)
        assert err.item() == float(j_err)
        for got, want in ((params, jparams), (opt_state.acc, j_opt.acc)):
            for group, leaves in _numpy(want).items():
                for name, leaf in leaves.items():
                    np.testing.assert_allclose(got[group][name].numpy(),
                                               leaf, atol=TOL, rtol=TOL)


def _check_build_model(dtype):
    """`build_model` on the rows: the state's dtypes, and its unroll's
    outputs and final state against JAX's `build_model`'s from the same
    weights (bf16 rows, int8 codes and usage bit for bit)."""
    from repro.core.training import ModelSpec as JaxModelSpec
    from repro.core.training import build_model as jax_build_model
    jcfg, cfg = _train_configs(dtype)
    j_init, j_state, j_unroll = jax_build_model(
        JaxModelSpec("sam", jcfg.memory, jcfg.controller))
    init_p, init_s, run = training.build_model(
        training.ModelSpec("sam", cfg.memory, cfg.controller), device="cpu")
    state = init_s(B)
    assert state.memory.dtype == getattr(torch, dtype)
    assert (state.mem_scale is not None) == (dtype == "int8")
    jparams = _numpy(j_init(jax.random.PRNGKey(4)))
    xs = _xs()
    j_final, j_ys = jax.jit(j_unroll)(jparams, j_state(B),
                                      jnp.asarray(xs.numpy()))
    final, ys = run(convert.params_from_jax(jparams, device="cpu"), state, xs)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(j_ys),
                               atol=TOL, rtol=TOL)
    _assert_state_matches(final, j_final)


def _op_case(dtype, seed=5):
    """A read's and a write's inputs on the rows of ``dtype`` (bf16 rows
    or int8 codes and scales from the compiled JAX quantizer), with rows
    that two heads both read and duplicate write columns, and
    cotangents."""
    rng = np.random.default_rng(seed)
    mem, la, widx, ww, a, lra = _write_case("some", N=64, H=2, K=4,
                                            seed=seed)
    rows, scale = _storage(mem, dtype)
    idx_rows = rng.integers(0, 64, (B, 2, 4)).astype(np.int32)
    q = rng.standard_normal((B, 2, W)).astype(np.float32)
    q[:, 1] = np.asarray(rows, np.float32)[:, 7] if dtype != "int8" else \
        mem[:, 7]                          # both heads read row 7
    q[:, 0] = q[:, 1] + 0.01 * q[:, 0]
    beta = (1.0 + rng.random((B, 2))).astype(np.float32)
    g_mem = rng.standard_normal(mem.shape).astype(np.float32)
    return dict(rows=rows, scale=scale, la=la, widx=widx, ww=ww, a=a,
                lra=lra, q=q, beta=beta, idx_rows=idx_rows,
                g_mem=g_mem, g_scale=rng.standard_normal(mem.shape[:2]).astype(
                    np.float32),
                g_read=rng.standard_normal((B, 2, W)).astype(np.float32),
                g_w=rng.standard_normal((B, 2, 4)).astype(np.float32))


def _vjps(port_fn, jax_fn, primals, cts):
    """(the port's VJP through its autograd Functions, JAX's `jax.vjp`) of
    the same function, at ``primals`` (numpy or JAX arrays) and ``cts``."""
    leaves = [_t(p).requires_grad_() for p in primals]
    outs = port_fn(*[x.clone() for x in leaves])
    got = torch.autograd.grad(outs, leaves, [_t(c) for c in cts])
    _, vjp = jax.vjp(jax_fn, *[jnp.asarray(p) for p in primals])
    want = vjp(tuple(jnp.asarray(c) for c in cts) if len(cts) > 1
               else jnp.asarray(cts[0]))
    return got, want


def _check_op_vjp(op, dtype):
    """The read's and the write's closed-form VJPs on the rows against
    `jax.vjp` of the JAX ops under both backends: on bf16 rows the
    memory's gradient is bf16, on int8 rows the scales' is held (the codes
    carry none)."""
    d = _op_case(dtype)
    N = d["rows"].shape[1] - 1
    q8 = dtype == "int8"
    codes = d["rows"] if q8 else None
    for backend in BACKENDS:
        if op == "read":
            primals = (d["q"], d["scale"] if q8 else d["rows"], d["beta"])
            cts = (d["g_read"], d["g_w"])

            def port(q, m, b):
                mem, s = (_t(codes), m) if q8 else (m, None)
                return ops.fused_read(q, mem, b, 4, valid_n=N,
                                      mem_scale=s)[:2]

            def jax_fn(q, m, b, backend=backend):
                mem, s = (jnp.asarray(codes), m) if q8 else (m, None)
                return jops.fused_read(q, mem, b, 4, backend=backend,
                                       block_n=16, valid_n=N,
                                       mem_scale=s)[:2]
        else:
            primals = (d["scale"] if q8 else d["rows"], d["ww"], d["a"])
            cts = (d["g_scale"] if q8 else
                   np.asarray(jnp.asarray(d["g_mem"]).astype(jnp.bfloat16)),)
            step = np.int32(9)

            def port(m, w, a):
                out = ops.sparse_write_update(
                    _t(codes).clone() if q8 else m, _t(d["la"]),
                    _t(d["widx"]), w, a, _t(d["lra"]), torch.tensor(step),
                    delta=0.005, mem_scale=m if q8 else None)
                return out[2] if q8 else out[0]

            def jax_fn(m, w, a, backend=backend):
                out = jops.sparse_write_update(
                    jnp.asarray(codes) if q8 else m, jnp.asarray(d["la"]),
                    jnp.asarray(d["widx"]), w, a, jnp.asarray(d["lra"]),
                    step, delta=0.005, backend=backend, scratch_row=N,
                    mem_scale=m if q8 else None)
                return out[2] if q8 else out[0]
        got, want = _vjps(port, jax_fn, primals, cts)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == _t(np.asarray(w)).dtype
            assert np.abs(np.asarray(w, np.float32)).max() > 0
            _int8_close(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("what", [
    "build_model", "make_task_train_step", "unroll_naive", "unroll_sparse",
    "unroll_chunked", "autograd_read", "autograd_write"])
def test_training_on_bf16_or_int8_rows_is_refused(what, dtype):
    """Once refused (ROADMAP.md A6b), each of these training paths now runs
    on bf16 and int8 rows and is held against JAX: `build_model`'s unroll;
    three `make_task_train_step` RMSProp steps; the naive, sparse and
    chunked (C = 2) unrolls' gradients against `jax.grad` of JAX's naive
    and sparse unrolls under ``ref`` and ``pallas-interpret`` (int8: within
    atol 2e-5 of the leaf's max(1, |g|) / rtol 1e-5, and sparse and
    chunked against the port's naive so too, the rollback bit for bit;
    bf16: within twice JAX's own spread across its modes and backends,
    `_bf16_bar`);
    the read's and the write's VJPs against `jax.vjp`."""
    if what == "build_model":
        _check_build_model(dtype)
    elif what == "make_task_train_step":
        _check_three_train_steps(dtype)
    elif what.startswith("unroll"):
        _check_train_grads(dtype, what.split("_")[1])
    else:
        _check_op_vjp(what.split("_")[1], dtype)
