"""The port's LSH read (`repro_torch.core.ann`, the candidate read of
`repro_torch.core.addressing` and the ``ann="lsh"`` branch of
`repro_torch.core.sam`) against the JAX package, on the CPU.

Index: B = 2, N = 32 or 128, W = 8, T = 2 tables of 3 bits, bucket size 8
(tiny, so buckets fill and rings wrap). The SAM cell: B = 2, N = 128,
W = 8, H = 2, K = 4, hidden 16, the copy task with max_len 2 (T = 6 steps).
Inputs from a numpy seed; weights, planes and states come from the JAX
side through `repro_torch.convert`. The JAX cell runs under the ``ref``
and the ``pallas-interpret`` backends.

Tolerances: integers exact (bucket ids, buckets, cursors, read indices,
usage tables); floats within 1e-5 at f32; gradients within atol 1e-5 /
rtol 1e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import addressing as jaddr
from repro.core import ann as jann
from repro.core import sam as jsam
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import addressing as addr
from repro_torch.core import ann, sam
from repro_torch.core.types import ControllerConfig, MemoryConfig
from repro_torch.data.tasks import copy_task
from repro_torch.kernels import ops

TOL = 1e-5
B, W, TABLES, BITS_LSH, BUCKET = 2, 8, 2, 3, 8
N_SAM, H, K, HIDDEN, BITS, MAX_LEN = 128, 2, 4, 16, 4, 2
LSH = dict(ann="lsh", lsh_tables=TABLES, lsh_bits=BITS_LSH,
           lsh_bucket_size=BUCKET)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _index_cfgs(n):
    return (JaxMemoryConfig(num_slots=n, word_size=W, **LSH),
            MemoryConfig(num_slots=n, word_size=W, **LSH))


def _planes(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (TABLES, BITS_LSH, W)).astype(np.float32)


def _assert_index_equal(got, want):
    np.testing.assert_array_equal(got.buckets.numpy(),
                                  np.asarray(want.buckets))
    np.testing.assert_array_equal(got.cursor.numpy(), np.asarray(want.cursor))


def _prefilled(jcfg, planes, rng, n, inserts):
    """The same index on both sides after ``inserts`` single-row inserts,
    so cursors start at arbitrary ring phases and rings have wrapped."""
    jstate = jann.ann_init(B, jcfg, partitions=1)
    for _ in range(inserts):
        idx = rng.integers(0, n, (B, 1)).astype(np.int32)
        rows = rng.standard_normal((B, 1, W)).astype(np.float32)
        jstate = jann.ann_insert(jnp.asarray(planes), jstate, jnp.asarray(idx),
                                 jnp.asarray(rows), jcfg)
    return jstate, convert.ann_from_jax(_numpy(jstate), device="cpu")


def test_ann_init_matches_jax_and_refuses_partitions():
    jcfg, cfg = _index_cfgs(32)
    _assert_index_equal(ann.ann_init(B, cfg, device="cpu"),
                        jann.ann_init(B, jcfg, partitions=1))
    with pytest.raises(ValueError, match="P = 1"):
        ann.ann_init(B, cfg, partitions=2, device="cpu")
    with pytest.raises(ValueError, match="P = 1"):
        convert.ann_from_jax(_numpy(jann.ann_init(B, jcfg, partitions=2)),
                             device="cpu")


def test_ring_ranks_match_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 3, (B, 9, TABLES)).astype(np.int32)
    group = np.ones((B, 9, 9), bool)
    got = ann.ring_ranks(torch.tensor(ids), torch.tensor(group))
    want = jann.ring_ranks(jnp.asarray(ids), jnp.asarray(group))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prefill", [0, 30], ids=["empty", "prefilled"])
@pytest.mark.parametrize("case", ["distinct", "duplicate-slots"])
def test_ann_insert_matches_jax(case, prefill):
    """One batched insert of J = 7 rows: buckets and cursors bit for bit.
    A row written twice in one step (two heads read it) is inserted twice;
    equal rows hash to one bucket, so a bucket takes several entries."""
    n = 32
    jcfg, cfg = _index_cfgs(n)
    planes = _planes()
    rng = np.random.default_rng(prefill + len(case))
    jstate, state = _prefilled(jcfg, planes, rng, n, prefill)
    idx = rng.integers(0, n, (B, 7)).astype(np.int32)
    rows = rng.standard_normal((B, 7, W)).astype(np.float32)
    if case == "duplicate-slots":
        idx[:, 4], rows[:, 4] = idx[:, 1], rows[:, 1]
        idx[:, 6], rows[:, 6] = idx[:, 1], rows[:, 1]
        rows[:, 5] = 2.0 * rows[:, 2]       # another row, the same buckets
    got = ann.ann_insert(torch.tensor(planes), state, torch.tensor(idx),
                         torch.tensor(rows), cfg)
    want = jann.ann_insert(jnp.asarray(planes), jstate, jnp.asarray(idx),
                           jnp.asarray(rows), jcfg)
    _assert_index_equal(got, want)
    # The input index is left as it was (the chunked unroll keeps it).
    _assert_index_equal(state, jstate)


@pytest.mark.parametrize("seed", range(6))
def test_batched_insert_equals_sequential(seed):
    """The property of `tests/test_ann_properties.py` for P = 1: with
    J <= d entries per bucket in one call, one batched insert equals J
    single-row inserts, buckets and cursors, from a prefilled index."""
    n = 32
    _, cfg = _index_cfgs(n)
    rng = np.random.default_rng(seed)
    planes = torch.tensor(_planes(seed))
    state = ann.ann_init(B, cfg, device="cpu")
    for _ in range(int(rng.integers(0, 3 * BUCKET))):
        state = ann.ann_insert(
            planes, state, torch.tensor(rng.integers(0, n, (B, 1)),
                                        dtype=torch.int32),
            torch.tensor(rng.standard_normal((B, 1, W)), dtype=torch.float32),
            cfg)
    j = int(rng.integers(1, BUCKET + 1))
    idx = torch.tensor(rng.integers(0, n, (B, j)), dtype=torch.int32)
    rows = torch.tensor(rng.standard_normal((B, j, W)), dtype=torch.float32)
    batched = ann.ann_insert(planes, state, idx, rows, cfg)
    seq = state
    for t in range(j):
        seq = ann.ann_insert(planes, seq, idx[:, t:t + 1], rows[:, t:t + 1],
                             cfg)
    assert torch.equal(batched.buckets, seq.buckets)
    assert torch.equal(batched.cursor, seq.cursor)


def test_ann_query_and_candidates_match_jax():
    n = 32
    jcfg, cfg = _index_cfgs(n)
    planes = _planes(2)
    rng = np.random.default_rng(2)
    jstate, state = _prefilled(jcfg, planes, rng, n, 40)
    q = rng.standard_normal((B, H, W)).astype(np.float32)
    extra = rng.integers(0, n, (B, 5)).astype(np.int32)
    got_q = ann.ann_query(torch.tensor(planes), state, torch.tensor(q), cfg)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(jann.ann_query(
        jnp.asarray(planes), jstate, jnp.asarray(q), jcfg)))
    got = ann.ann_candidates(torch.tensor(planes), state, torch.tensor(q),
                             torch.tensor(extra), cfg)
    want = jann.ann_candidates(jnp.asarray(planes), jstate, jnp.asarray(q),
                               jnp.asarray(extra), jcfg)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (B, H, cfg.candidates + 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [64, 61], ids=["N%d==0", "ragged"])
def test_ann_build_matches_jax(n):
    """The closed-form rebuild against JAX's chunked `lax.scan` of inserts,
    bit for bit, on a (B, N+1, W) buffer (the scratch row not indexed) with
    N a multiple of d and not; duplicate rows crowd a bucket past d."""
    jcfg, cfg = _index_cfgs(n)
    planes = _planes(3)
    mem = np.random.default_rng(3).standard_normal(
        (B, n + 1, W)).astype(np.float32)
    mem[:, 10:30] = mem[:, 5:6]              # 21 rows in one bucket per table
    mem[:, n] = 100.0                        # the scratch row
    got = ann.ann_build(torch.tensor(planes), torch.tensor(mem), cfg)
    want = jann.ann_build(jnp.asarray(planes), jnp.asarray(mem), jcfg,
                          partitions=1)
    _assert_index_equal(got, want)


# --------------------------------------------------------------------------
# The candidate read
# --------------------------------------------------------------------------

def _cand_case(seed, C=12):
    rng = np.random.default_rng(seed)
    mem = rng.standard_normal((B, N_SAM + 1, W)).astype(np.float32)
    q = rng.standard_normal((B, H, W)).astype(np.float32)
    beta = (1.0 + rng.random((B, H))).astype(np.float32)
    cand = rng.integers(0, 20, (B, H, C)).astype(np.int32)   # repeats
    cand[0, 1, ::2] = -1
    return q, mem, beta, cand


@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
def test_candidate_read_forward_and_gradients_match_jax(backend):
    """`select_and_read_candidates` (dedup, one fused read) against JAX's:
    forward, signed selection, and the gradients of the candidate
    Function (q, memory, beta) against `jax.grad`."""
    q, mem, beta, cand = _cand_case(5)
    rng = np.random.default_rng(6)
    r_read = rng.standard_normal((B, H, W)).astype(np.float32)
    r_w = rng.standard_normal((B, H, K)).astype(np.float32)

    def port(q_, m_, b_):
        sr, sel = addr.select_and_read_candidates(q_, m_, b_, K,
                                                  torch.tensor(cand))
        return (sr.words * torch.tensor(r_read)).sum() + (
            sr.weights * torch.tensor(r_w)).sum(), sr, sel

    def jax_side(q_, m_, b_):
        sr, sel = jaddr.select_and_read_candidates(
            q_, m_, b_, K, jnp.asarray(cand), backend=backend)
        return (sr.words * r_read).sum() + (sr.weights * r_w).sum(), (sr, sel)

    leaves = [torch.tensor(x, requires_grad=True) for x in (q, mem, beta)]
    loss, sr, sel = port(*leaves)
    grads = torch.autograd.grad(loss, leaves)
    (j_loss, (j_sr, j_sel)), j_grads = jax.value_and_grad(
        jax_side, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(x) for x in (q, mem, beta)))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(j_sel))
    np.testing.assert_array_equal(sr.indices.numpy(), np.asarray(j_sr.indices))
    _close(sr.words.detach(), j_sr.words)
    _close(sr.weights.detach(), j_sr.weights)
    _close(loss.item(), float(j_loss))
    for g, w in zip(grads, j_grads):
        _close(g, w)
    # The composed pair (select, then the tail) gives the same read.
    composed = addr.sparse_read_candidates(*(torch.tensor(x) for x in
                                             (q, mem, beta)), K,
                                           torch.tensor(cand))
    assert torch.equal(composed.indices, sr.indices)
    _close(composed.words, sr.words.detach())


def test_cold_candidate_index_reads_zero_with_zero_grad():
    """Every candidate invalid (a cold index): weight exactly 0, read
    exactly 0, signed selection -1, and no gradient into row 0 through the
    clamp (`tests/test_fused_read.py`)."""
    q, mem, beta, _ = _cand_case(7)
    cand = torch.full((B, H, 12), -1, dtype=torch.int32)
    m = torch.tensor(mem, requires_grad=True)
    read, w, sel = ops.fused_read(torch.tensor(q), m, torch.tensor(beta), K,
                                  cand_idx=cand)
    assert (w == 0).all() and (read == 0).all() and (sel < 0).all()
    g, = torch.autograd.grad(read.sum() + w.sum(), m)
    assert (g == 0).all()


# --------------------------------------------------------------------------
# The SAM cell with the LSH read
# --------------------------------------------------------------------------

def _sam_configs(backend):
    jcfg = jsam.SAMConfig(
        JaxMemoryConfig(num_slots=N_SAM, word_size=W, num_heads=H, k=K,
                        backend=backend, **LSH),
        JaxControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                            output_size=BITS))
    cfg = sam.SAMConfig(
        MemoryConfig(num_slots=N_SAM, word_size=W, num_heads=H, k=K, **LSH),
        ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                         output_size=BITS))
    return jcfg, cfg


@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
def test_lsh_sam_unroll_matches_jax_every_step(backend):
    """Six steps from a cold index: y, memory, the read, the usage table
    and the index (buckets and cursors, bit for bit) after every step, and
    the signed selections the step records."""
    jcfg, cfg = _sam_configs(backend)
    jparams = jsam.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jsam.init_state(B, jcfg)
    params = convert.params_from_jax(_numpy(jparams), device="cpu")
    state = convert.state_from_jax(_numpy(jstate), device="cpu")
    seq = np.random.default_rng(0).integers(0, 2, (B, MAX_LEN, BITS))
    inputs, _, _ = copy_task(B, MAX_LEN, MAX_LEN, BITS, seq=seq, device="cpu")
    xs = inputs.transpose(0, 1).contiguous()                   # (T, B, D)
    step = jax.jit(lambda p, s, x: jsam.sam_step(p, jcfg, s, x,
                                                 collect_deltas=True))
    invalid = 0
    for t, x in enumerate(xs):
        jstate, jy, jdeltas = step(jparams, jstate, jnp.asarray(x.numpy()))
        state, y, deltas = sam.sam_step(params, cfg, state, x,
                                        collect_deltas=True)
        _close(y, jy)
        _close(state.memory, jstate.memory)
        _close(state.read.words, jstate.read.words)
        _close(state.read.weights, jstate.read.weights)
        for got, want in ((state.read.indices, jstate.read.indices),
                          (deltas.read_idx, jdeltas.read_idx),
                          (deltas.write_idx, jdeltas.write_idx),
                          (state.last_access, jstate.last_access)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_index_equal(state.ann, jstate.ann)
        invalid += int((deltas.read_idx < 0).sum())
        assert int(state.step) == t + 1
    assert invalid > 0            # the cold steps selected invalid entries
    # The module's forward is the same unroll from the same weights.
    model = sam.SAM(cfg, params, device="cpu")
    assert "lsh_planes" not in dict(model.named_parameters())
    final, ys = model(convert.state_from_jax(
        _numpy(jsam.init_state(B, jcfg)), device="cpu"), xs)
    _close(final.memory, state.memory)
    assert torch.equal(final.ann.buckets, state.ann.buckets)


def test_fresh_lsh_state_first_read_has_no_row0_gradient():
    """On the first step the index is empty: a selection beyond the
    freshly written rows has weight 0, so the memory's gradient reaches
    only the rows the step touched (`tests/test_core_sam.py`)."""
    _, cfg = _sam_configs("ref")
    params = sam.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (B, BITS + 2)), dtype=torch.float32)
    state = sam.init_state(B, cfg, device="cpu")
    _, _, deltas = sam.sam_step(params, cfg, state, x, collect_deltas=True)
    assert (deltas.read_idx < 0).any()
    touched = set(deltas.write_idx.flatten().tolist())
    m = sam.init_state(B, cfg, device="cpu").memory.requires_grad_()
    _, y = sam.sam_step(params, cfg, sam.init_state(B, cfg, device="cpu")
                        ._replace(memory=m.clone()), x)
    g, = torch.autograd.grad((y ** 2).sum(), m)
    untouched = sorted(set(range(N_SAM)) - touched)
    assert g[:, untouched].abs().max() == 0.0


def test_lsh_init_params_draws_the_planes_last():
    """An LSH cell's weights from a seed are the exact cell's; the planes
    (T, bits, W) come after them. A state without an index is refused."""
    _, cfg = _sam_configs("ref")
    exact = sam.SAMConfig(MemoryConfig(num_slots=N_SAM, word_size=W,
                                       num_heads=H, k=K), cfg.controller)
    p_lsh = sam.init_params(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    p_exact = sam.init_params(torch.Generator().manual_seed(1), exact,
                              device="cpu")
    assert p_lsh.keys() - p_exact.keys() == {"lsh_planes"}
    for group in p_exact:
        for name in p_exact[group]:
            assert torch.equal(p_lsh[group][name], p_exact[group][name])
    assert tuple(p_lsh["lsh_planes"].shape) == (TABLES, BITS_LSH, W)
    state = sam.init_state(B, cfg, device="cpu")
    assert tuple(state.ann.buckets.shape) == (B, TABLES, 2 ** BITS_LSH, 1,
                                              BUCKET)
    with pytest.raises(ValueError, match="LSH index"):
        sam.sam_step(p_lsh, cfg, state._replace(ann=None),
                     torch.zeros((B, BITS + 2)))
