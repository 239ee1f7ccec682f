"""The port's plain kernel versions (`repro_torch.kernels.ref`, through the
CPU dispatch of `repro_torch.kernels.ops`) against the JAX oracles
(`repro.kernels.ref`) and the Pallas kernels in interpret mode, called with
small blocks so that the multi-tile merge runs.

Inputs are made from a numpy seed and passed to both sides as numpy.
Tolerances: integers exact; floats within 1e-5 at f32 (the two sides sum
in other orders)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import addressing as jaddr
from repro.kernels import ref as jref
from repro.kernels.fused_read import \
    fused_read_candidates as pallas_read_cand
from repro.kernels.fused_read import fused_read_sweep as pallas_read
from repro.kernels.lsh_hash import lsh_hash as pallas_hash
from repro.kernels.scatter_rows import first_occurrence as jax_first
from repro.kernels.scatter_rows import scatter_rows as pallas_scatter
from repro.kernels.sparse_write import sparse_write_update as pallas_write
from repro.kernels.usage_argmin import lra_topn as pallas_topn
from repro_torch.core import quant
from repro_torch.core.types import LA_SCRATCH
from repro_torch.kernels import lsh_hash as hash_k
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_read import (MAX_SMEM, WARPS, bank_ways,
                                            smem_bytes, sweep_plan)
from repro_torch.kernels.fused_read_candidates import (LOADS, MAX_TILE,
                                                       cand_plan, cand_smem)
from repro_torch.kernels.lsh_hash import hash_plan
from repro_torch.kernels.sparse_write import MAX_SMEM as MAX_SMEM_Q
from repro_torch.kernels.sparse_write import (MAX_A_WORDS, MAX_COLUMNS,
                                              MAX_Q_THREADS, MAX_THREADS,
                                              MIN_WORDS, PIECES, Q_STAGE,
                                              q_plan, q_smem, write_plan)
from repro_torch.kernels.usage_argmin import (ARGMIN_THREADS, ARGMIN_VEC,
                                              BLOCKS_PER_SM, TOPN_THREADS,
                                              grid_plan)

TOL = 1e-5
B, N, W, H, K = 2, 128, 8, 2, 4


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


def _read_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    q = rng.standard_normal((B, H, W)).astype(np.float32)
    if case == "zero":
        mem[:] = 0.0
    elif case == "dup":
        # Rows 50 and 90 copy row 10, and the queries point at it: three
        # exactly tied similarities, ordered by index.
        mem[:, 50] = mem[:, 10]
        mem[:, 90] = mem[:, 10]
        q = mem[:, 10][:, None, :] + 0.01 * q
    beta = (1.0 + rng.random((B, H))).astype(np.float32)
    return q, mem, beta


@pytest.mark.parametrize("case", ["rand", "zero", "dup"])
def test_fused_read_matches_jax_ref_and_pallas(case):
    q, mem, beta = _read_inputs(case)
    got = ops.fused_read(torch.tensor(q), torch.tensor(mem),
                         torch.tensor(beta), K, valid_n=N)
    want_ref = jref.fused_read_ref(jnp.asarray(q), jnp.asarray(mem),
                                   jnp.asarray(beta), K, valid_n=N)
    want_pl = pallas_read(jnp.asarray(q), jnp.asarray(mem), jnp.asarray(beta),
                          k=K, block_n=32, interpret=True, valid_n=N)
    for want in (want_ref, want_pl):
        _close(got[0], want[0])
        _close(got[1], want[1])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if case == "zero":      # all N similarities tie at 0: rows 0..K-1
        np.testing.assert_array_equal(
            got[2].numpy(), np.broadcast_to(np.arange(K), (B, H, K)))
    if case == "dup":
        np.testing.assert_array_equal(got[2].numpy()[:, :, :3],
                                      np.broadcast_to([10, 50, 90], (B, H, 3)))


def test_topk_read_and_tail_match_jax():
    q, mem, beta = _read_inputs("dup", seed=1)
    vals, idx = ref.topk_read_ref(torch.tensor(q), torch.tensor(mem[:, :N]), K)
    j_vals, j_idx = jref.topk_read_ref(jnp.asarray(q), jnp.asarray(mem[:, :N]),
                                       K)
    _close(vals, j_vals)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    read, w = ref.sparse_read_tail(torch.tensor(q), torch.tensor(mem),
                                   torch.tensor(beta), idx)
    j_read, j_w = jref.sparse_read_tail(jnp.asarray(q), jnp.asarray(mem),
                                        jnp.asarray(beta), j_idx)
    _close(read, j_read)
    _close(w, j_w)


@pytest.mark.parametrize("case", ["ties", "stagger", "wide"])
@pytest.mark.parametrize("n", [2, 4])
def test_lra_topn_matches_jax_ref_and_pallas(case, n):
    rng = np.random.default_rng(n)
    if case == "ties":          # equal usage stamps everywhere
        la = rng.integers(-2, 2, (B, N + 1)).astype(np.int32)
    elif case == "stagger":     # init_scratch_last_access: N-1, N-2, ...
        la = np.broadcast_to(-np.arange(N + 1, dtype=np.int32),
                             (B, N + 1)).copy()
    else:
        la = rng.integers(-10 ** 6, 10 ** 6, (B, N + 1)).astype(np.int32)
    la[:, N] = LA_SCRATCH
    got = ops.lra_topn(torch.tensor(la), n, valid_n=N).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.lra_topn_ref(jnp.asarray(la[:, :N]), n)))
    np.testing.assert_array_equal(
        got, np.asarray(pallas_topn(jnp.asarray(la), n=n, block_n=32,
                                    interpret=True, valid_n=N)))
    if case == "stagger":
        np.testing.assert_array_equal(got[0], N - 1 - np.arange(n))


def _write_inputs(seed=0):
    rng = np.random.default_rng(seed)
    J = H * (K + 1)
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    la = rng.integers(-50, 50, (B, N + 1)).astype(np.int32)
    la[:, N] = LA_SCRATCH
    widx = rng.integers(0, N, (B, H, K + 1)).astype(np.int32)
    widx[:, 1, 0] = widx[:, 0, 2]           # a row duplicated across heads
    widx[:, 1, 2] = widx[:, 0, 2]           # ... three times
    widx[:, 1, K] = widx[:, 0, 1]           # an LRA row that was also read
    lra = widx[:, :, K].copy()
    ww = rng.random((B, J)).astype(np.float32)
    ww[:, 2] = 0.001                        # below delta: no usage stamp
    a = rng.standard_normal((B, H, W)).astype(np.float32)
    return mem, la, widx.reshape(B, J), ww, a, lra


@pytest.mark.parametrize("per_lane", [False, True])
def test_sparse_write_matches_jax_ref_and_pallas(per_lane):
    mem, la, widx, ww, a, lra = _write_inputs()
    step = np.array([60, 7], np.int32) if per_lane else np.int32(60)
    t_mem, t_la = torch.tensor(mem), torch.tensor(la)
    out_mem, out_la = ops.sparse_write_update(
        t_mem, t_la, torch.tensor(widx), torch.tensor(ww), torch.tensor(a),
        torch.tensor(lra), torch.tensor(step), delta=0.005)
    assert out_mem is t_mem and out_la is t_la            # in place
    args = [jnp.asarray(x) for x in (widx, ww, a, lra, step)]
    j_mem, j_la = jref.sparse_write_update_ref(
        jnp.asarray(mem[:, :N]), jnp.asarray(la[:, :N]), *args[:4],
        jref._lane_step(args[4], B), 0.005)
    p_mem, p_la = pallas_write(jnp.asarray(mem), jnp.asarray(la), *args,
                               delta=0.005, interpret=True, scratch_row=N)
    _close(t_mem[:, :N], j_mem)
    _close(t_mem, p_mem)
    np.testing.assert_array_equal(t_la[:, :N].numpy(), np.asarray(j_la))
    np.testing.assert_array_equal(t_la.numpy(), np.asarray(p_la))
    # Row N, the write-scratch row, is bit-identical after the write.
    np.testing.assert_array_equal(t_mem[:, N].numpy(), mem[:, N])
    assert (t_la[:, N] == LA_SCRATCH).all()


def _scatter_inputs(dups, rows_n, seed=0):
    rng = np.random.default_rng(seed)
    J = H * (K + 1)
    mem = rng.standard_normal((B, rows_n, W)).astype(np.float32)
    if dups == "heavy":                     # three rows, each named ~7 times
        idx = rng.integers(0, 3, (B, J)).astype(np.int32)
    else:
        idx = rng.integers(0, N, (B, J)).astype(np.int32)
        idx[:, 7] = idx[:, 2]               # a duplicate ...
        idx[:, 9] = idx[:, 2]               # ... three times
        idx[:, 4] = idx[:, 3]               # and a neighbouring pair
    rows = rng.standard_normal((B, J, W)).astype(np.float32)
    return mem, idx, rows


@pytest.mark.parametrize("scratch", [False, True], ids=["no-scratch", "scratch"])
@pytest.mark.parametrize("dups", ["some", "heavy"])
@pytest.mark.parametrize("mode", ["add", "set"])
def test_scatter_rows_matches_jax_ref_and_pallas(mode, dups, scratch):
    """'add' sums every column naming a row (j order here, a pre-summed
    einsum in the Pallas path): within 1e-5. 'set' keeps the last column:
    bit for bit. With the (B, N+1, W) scratch-row buffer the Pallas 'add'
    parks duplicates on row N (adding zeros); the port never touches it."""
    mem, idx, rows = _scatter_inputs(dups, N + 1 if scratch else N)
    t_mem = torch.tensor(mem)
    out = ops.scatter_rows(t_mem, torch.tensor(idx), torch.tensor(rows), mode)
    assert out is t_mem                                       # in place
    args = [jnp.asarray(x) for x in (mem, idx, rows)]
    want_ref = jref.scatter_rows_ref(*args, mode=mode)
    want_pl = pallas_scatter(*args, mode=mode, interpret=True,
                             scratch_row=N if scratch else None)
    for want in (want_ref, want_pl):
        if mode == "set":
            np.testing.assert_array_equal(t_mem.numpy(), np.asarray(want))
        else:
            _close(t_mem, want)
    untouched = np.ones(mem.shape[:2], bool)
    untouched[np.arange(B)[:, None], idx] = False
    np.testing.assert_array_equal(t_mem.numpy()[untouched], mem[untouched])
    # In j order: the duplicated row is ((m + r2) + r7) + r9, in f32.
    if mode == "add" and dups == "some":
        want = ((mem[0, idx[0, 2]] + rows[0, 2]) + rows[0, 7]) + rows[0, 9]
        np.testing.assert_array_equal(t_mem[0, idx[0, 2]].numpy(), want)


def test_scatter_rows_refuses_an_unknown_mode_and_device():
    mem, idx, rows = (torch.tensor(x) for x in _scatter_inputs("some", N))
    with pytest.raises(ValueError, match="unknown mode"):
        ops.scatter_rows(mem, idx, rows, "max")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.scatter_rows(mem.to("meta"), idx.to("meta"), rows.to("meta"))


def test_gather_rows_matches_jax():
    from repro.core.addressing import gather_rows as jax_gather
    from repro_torch.core.addressing import gather_rows
    _, mem, _ = _read_inputs("rand", seed=2)
    idx = np.random.default_rng(2).integers(0, N, (B, H, K)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_rows(torch.tensor(mem), torch.tensor(idx)).numpy(),
        np.asarray(jax_gather(jnp.asarray(mem), jnp.asarray(idx))))


def test_first_occurrence_matches_jax():
    idx = np.random.default_rng(3).integers(0, 5, (3, 10)).astype(np.int32)
    np.testing.assert_array_equal(ref.first_occurrence(torch.tensor(idx)).numpy(),
                                  np.asarray(jax_first(jnp.asarray(idx))))


def test_lane_step_shapes():
    assert ref._lane_step(5, 3, "cpu").tolist() == [5, 5, 5]
    assert ref._lane_step(torch.tensor([[1], [2]]), 2, "cpu").tolist() == [1, 2]
    with pytest.raises(ValueError, match="one entry per batch row"):
        ref._lane_step(torch.tensor([1, 2, 3]), 2, "cpu")


def test_ops_refuse_devices_without_a_kernel():
    la = torch.zeros((2, 9), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.lra_topn(la, 2, valid_n=8)


def test_scatter_rows_ref_raises_on_an_index_outside_the_buffer():
    """One contract for every index: [0, R). A -1 (an invalid LSH
    selection) would wrap to the scratch row; the plain version raises on
    it, and on R, before it touches the buffer."""
    mem, idx, rows = (torch.tensor(x) for x in _scatter_inputs("some", N + 1))
    before = mem.clone()
    for bad in (-1, N + 1):
        idx[1, 3] = bad
        for mode in ("add", "set"):
            with pytest.raises(ValueError, match="outside"):
                ops.scatter_rows(mem, idx, rows, mode)
    assert torch.equal(mem, before)


# --------------------------------------------------------------------------
# The LSH read's kernels: the signature hash and the candidate read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R,W_,T,bits", [(10, 16, 2, 4), (300, 64, 4, 8)])
def test_lsh_hash_matches_jax_ref_and_pallas(R, W_, T, bits):
    """Bucket ids bit for bit (the shapes of `tests/test_kernels.py::
    test_lsh_hash_sweep`); zero rows project to exactly 0 and hash to 0."""
    rng = np.random.default_rng(R)
    x = rng.standard_normal((R, W_)).astype(np.float32)
    x[:3] = 0.0
    planes = rng.standard_normal((T, bits, W_)).astype(np.float32)
    got = ops.lsh_hash(torch.tensor(x), torch.tensor(planes))
    assert got.dtype == torch.int32 and tuple(got.shape) == (R, T)
    for want in (jref.lsh_hash_ref(jnp.asarray(x), jnp.asarray(planes)),
                 pallas_hash(jnp.asarray(x), jnp.asarray(planes),
                             interpret=True)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:3] == 0).all() and (got < 2 ** bits).all()
    # Leading dimensions pass through, as in the JAX op.
    got3 = ops.lsh_hash(torch.tensor(x[:10]).reshape(2, 5, W_),
                        torch.tensor(planes))
    assert torch.equal(got3.reshape(10, T), got[:10])


# The hash's plan (kernels/lsh_hash.py::hash_plan) and its lanes
# (csrc/lsh_hash.cu), followed in Python: the CUDA kernel cannot run here.

@pytest.mark.parametrize("R", [32, 160, 1 << 23])
@pytest.mark.parametrize("W_", [4, 32, 128])
def test_hash_plan_regime_and_smem(R, W_):
    """The step's hashes (R = B·H = 32, B·J = 160) take a one-warp block
    per 8-row tile, so R = 160 spreads over 20 SMs; a rebuild's 2^23 rows
    stream through two persistent blocks an SM of 8 warps, at most one
    warp a tile. The shared memory fits the 227 KB a block may use, and
    the grid never has more warps than tiles."""
    sms = 132
    plan = hash_plan(hash_k.streams(R, sms), W_)
    tiles = -(-R // plan.tile)
    blocks = plan.blocks(R, sms)
    assert plan.tile % hash_k.PASS_ROWS == 0
    assert 1 <= plan.stages <= hash_k.MAX_STAGES
    assert 1 <= plan.warps <= hash_k.MAX_WARPS
    assert blocks * plan.warps <= tiles
    assert plan.smem(R, W_, sms) <= hash_k.MAX_SMEM
    if R < 1 << 23:
        assert not plan.streamed and (plan.tile, plan.warps) == (8, 1)
        assert blocks == tiles and plan.smem(R, W_, sms) == 32 * W_ + 8
    else:
        assert plan.streamed and plan.warps == hash_k.STREAM_WARPS
        assert blocks == hash_k.BLOCKS_PER_SM * sms
        if W_ <= 32:
            assert (plan.tile, plan.stages) == (hash_k.STREAM_TILE,
                                                hash_k.STREAM_STAGES)


@pytest.mark.parametrize("W_", [256, 1024, 2048])
def test_hash_plan_cuts_the_ring_to_fit(W_):
    """Wide rows: the streamed ring loses stages, then rows a tile, then
    warps, until it fits; rows too wide for two 8-row stages (streamed) or
    one 8-row tile are refused."""
    plan = hash_plan(True, W_)
    assert plan.smem(1 << 23, W_, 132) <= hash_k.MAX_SMEM
    assert plan.stages >= 2 and plan.tile >= hash_k.PASS_ROWS
    with pytest.raises(ValueError, match="shared memory"):
        hash_plan(True, 4096)
    with pytest.raises(ValueError, match="shared memory"):
        hash_plan(False, 1 << 14)


def _hash_by_lanes(proj, T, bits):
    """csrc/lsh_hash.cu's packing, lane by lane, from the sign of each
    projection proj (R, T·bits): groups of 32 // bits whole tables; lane i
    of half h votes planes i and i + 16 of the group for row 2j + h; the
    row's sign word is the low (h = 0) or high (h = 1) 16 bits of each
    vote; lane v of a pass writes table v % nt of row v // nt."""
    R = proj.shape[0]
    out = np.zeros((R, T), np.int64)
    per = 32 // bits
    pos = proj > 0
    for base in range(0, R, 8):
        for t0 in range(0, T, per):
            nt = min(per, T - t0)
            G = nt * bits
            for j in range(4):
                v0 = v1 = 0
                for lane in range(32):
                    h, i = lane >> 4, lane & 15
                    r = base + 2 * j + h
                    if r >= R:
                        continue
                    if i < G and pos[r, t0 * bits + i]:
                        v0 |= 1 << lane
                    if i + 16 < G and pos[r, t0 * bits + i + 16]:
                        v1 |= 1 << lane
                for h in (0, 1):
                    r = base + 2 * j + h
                    if r >= R:
                        continue
                    signs = ((v0 >> 16 * h) & 0xFFFF) | \
                        (((v1 >> 16 * h) & 0xFFFF) << 16)
                    for t in range(nt):
                        out[r, t0 + t] = (signs >> t * bits) & ((1 << bits) - 1)
    return out


@pytest.mark.parametrize("T,bits", [(4, 8), (2, 8), (8, 8), (1, 30), (3, 30),
                                    (1, 1), (5, 7), (7, 5)])
def test_hash_lanes_pack_as_the_plain_hash(T, bits):
    """The kernel's votes and packing give `ref.lsh_hash_ref`'s ids from the
    same signs, for T·bits below, at and above one group of 32 planes and
    for groups that do not fill 32 lanes; R = 13 ends in a partial pass."""
    rng = np.random.default_rng(T * 31 + bits)
    Wd, R = 8, 13
    x = torch.tensor(rng.standard_normal((R, Wd)).astype(np.float32))
    x[0] = 0.0
    planes = torch.tensor(rng.standard_normal((T, bits, Wd)).astype(np.float32))
    proj = torch.einsum("rw,tbw->rtb", x, planes).reshape(R, T * bits)
    np.testing.assert_array_equal(_hash_by_lanes(proj.numpy(), T, bits),
                                  ref.lsh_hash_ref(x, planes).numpy())


def test_dedup_matches_jax():
    rng = np.random.default_rng(4)
    idx = rng.integers(-1, 6, (3, 2, 17)).astype(np.int32)
    idx[0, 0] = -1                          # every entry invalid
    idx[1, 1] = 3                           # every entry one row
    got = ref.dedup(torch.tensor(idx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jaddr._dedup(jnp.asarray(idx))))
    np.testing.assert_array_equal(got[1, 1].numpy(), [3] + [-1] * 16)
    assert (got[0, 0] == -1).all()


def _cand_inputs(case, seed=0, C=12):
    """Candidates over rows [0, N) as the LSH read gets them: pre-deduped,
    -1 = invalid."""
    rng = np.random.default_rng(seed)
    q, mem, beta = _read_inputs("rand", seed)
    cand = rng.integers(0, N, (B, H, C)).astype(np.int32)
    if case == "cold":                     # fewer than K valid candidates
        cand[:] = -1
        cand[0, 0, [2, 7]] = [5, 9]
        cand[1, 1, 11] = 40
    elif case == "zero":                   # every similarity ties at 0
        mem[:] = 0.0
        cand[:, :, ::3] = -1
    elif case == "dup":                    # repeats, then dedup
        cand[:, :, 6:] = cand[:, :, :6]
        cand[:, :, 3] = -1
    cand = np.asarray(jaddr._dedup(jnp.asarray(cand)))
    return q, mem, beta, cand


@pytest.mark.parametrize("case", ["rand", "cold", "zero", "dup"])
def test_fused_read_candidates_matches_jax_ref_and_pallas(case):
    q, mem, beta, cand = _cand_inputs(case)
    got = ops.fused_read(torch.tensor(q), torch.tensor(mem),
                         torch.tensor(beta), K, cand_idx=torch.tensor(cand))
    args = [jnp.asarray(x) for x in (q, mem, beta)]
    want_ref = jref.fused_read_candidates_ref(*args, K, jnp.asarray(cand))
    want_pl = pallas_read_cand(*args, jnp.asarray(cand), k=K, interpret=True)
    for want in (want_ref, want_pl):
        _close(got[0], want[0])
        _close(got[1], want[1])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    valid = got[2] >= 0
    assert (got[1][~valid] == 0).all()
    if case == "cold":                     # the valid ones, then -1s
        assert sorted(got[2][0, 0, :2].tolist()) == [5, 9]
        assert (got[2][0, 0, 2:] == -1).all()
        np.testing.assert_array_equal(got[2][1, 1].numpy(), [40, -1, -1, -1])
        assert (got[0][0, 1] == 0).all() and (got[1][0, 1] == 0).all()
    if case == "zero":                     # ties at 0: the first K valid
        first = np.stack([[c[c >= 0][:K] for c in row] for row in cand])
        np.testing.assert_array_equal(got[2].numpy(), first)


# --------------------------------------------------------------------------
# The exact sweep's grid plan (kernels/fused_read.py::sweep_plan), which the
# CUDA kernel receives: the chunks, the candidate buffers, the lane layout.
# --------------------------------------------------------------------------

SMS = 132                                # the H100's SMs
PLAN_SHAPES = [                          # (B, valid_n, W, itemsize, H, K)
    (8, 1 << 20, 32, 4, 4, 4),           # the smoke's f32, bf16, int8 rows
    (8, 1 << 20, 32, 2, 4, 4),
    (8, 1 << 20, 32, 1, 4, 4),
    (4, 65536, 128, 4, 4, 8),            # the LM's memory layer
    (8, 1 << 18, 32, 4, 4, 4),           # a rank's block of the smoke
    (8, (1 << 18) + 1, 32, 4, 4, 4),
    (1, 4, 32, 4, 4, 4),                 # valid_n = K
    (1, 1, 16, 1, 1, 1),
    (4, 1000, 16, 1, 3, 4),              # int8's narrowest row
    (4, 1000, 16, 1, 8, 8),              # int8 at H > 4: 8-byte pieces
    (8, 4097, 128, 2, 8, 1),
    (1, 65536, 128, 1, 4, 8),
    (4, 4097, 16, 4, 1, 4),
    (8, 1000, 128, 4, 8, 8),
    (65535, 4097, 32, 4, 4, 4),          # the most batch rows
    (3, 4097, 48, 4, 2, 4),              # 12 pieces over 16 lanes
]


def _row_plan(B, n, W, itemsize, H, K, sms=SMS):
    return sweep_plan(B, n, W, itemsize, H, K, sms)


@pytest.mark.parametrize("B,n,W,itemsize,H,K", PLAN_SHAPES)
def test_sweep_plan_covers_the_rows_once_and_fills_the_card(B, n, W, itemsize,
                                                            H, K):
    p = _row_plan(B, n, W, itemsize, H, K)
    row_bytes = W * itemsize
    scaled = itemsize == 1
    # Chunk c sweeps [c·chunk_rows, min((c+1)·chunk_rows, n)): every chunk
    # holds a row, and together they hold [0, n) once.
    starts = [c * p.chunk_rows for c in range(p.chunks)]
    assert all(s < n for s in starts)
    assert p.chunks * p.chunk_rows >= n
    covered = sum(min(s + p.chunk_rows, n) - s for s in starts)
    assert covered == n
    # A block steps WARPS stages of tile_rows rows; a stage is whole rounds.
    round_rows = 32 * p.bt // p.lanes
    assert p.chunk_rows % (WARPS * p.tile_rows) == 0
    assert p.tile_rows % round_rows == 0 and p.tile_rows % 4 == 0
    assert p.stage_bytes == p.tile_rows * (row_bytes + 4 * scaled)
    assert p.stage_bytes % 16 == 0
    assert p.smem_bytes == smem_bytes(p.stage_bytes, H, K, W) <= MAX_SMEM
    # The candidate buffers hold what the blocks write: K per (b, h, chunk).
    assert p.candidates == p.chunks * K
    # A row's pieces, one a lane; lanes a power of two; bt divides them.
    pieces = row_bytes // p.piece
    assert p.piece == (8 if scaled and H > 4 else 16)
    assert pieces <= p.lanes < 2 * pieces or p.lanes == pieces == 1
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes % p.bt == 0
    # One wave of resident blocks fills the card unless the rows run out.
    steps = -(-n // (WARPS * p.tile_rows))
    assert B * p.chunks >= min(SMS, B * steps)
    if (B, n, W) == (4, 65536, 128):
        assert B * p.chunks >= SMS
    # Shared loads are conflict-free for rows of a power of two of pieces.
    if pieces & (pieces - 1) == 0:
        assert bank_ways(row_bytes, p.piece, p.lanes, p.bt, p.phi_shift) == 1


@pytest.mark.parametrize("B,n,W,itemsize,H,K", PLAN_SHAPES)
def test_sweep_plan_scores_a_row_the_same_anywhere(B, n, W, itemsize, H, K):
    """What sets a row's summation order (lanes, bt, piece and the stagger)
    comes from the row's width, dtype and H only: not from B, valid_n or
    the SM count."""
    keys = ("lanes", "bt", "piece", "phi_shift", "tile_rows")
    p = _row_plan(B, n, W, itemsize, H, K)
    for other in (_row_plan(1, 7 * n + 3, W, itemsize, H, 1, sms=16),
                  _row_plan(B + 5, max(K, n // 3), W, itemsize, H, 8,
                            sms=264)):
        assert all(getattr(p, k) == getattr(other, k) for k in keys)


@pytest.mark.parametrize("W,itemsize,H", [
    (16, 1, 4), (32, 1, 4), (16, 1, 8), (32, 1, 8), (32, 2, 4), (16, 4, 4),
    (32, 4, 4), (64, 4, 8), (128, 4, 4), (128, 2, 4), (128, 1, 8),
    (48, 4, 4)])
def test_sweep_lanes_sum_each_row_once(W, itemsize, H):
    """The kernel's round, followed piece by piece: lane j of group g loads
    piece j of row g·bt + (s ^ jh ^ phi) at slot s, the reduce-scatter adds
    slot s + m of lane ^ m·cc into slot s, a butterfly adds over the low
    bits. Every lane must end with all pieces of its row once, and the
    owners (jl = 0) must hold each row of the round once."""
    from collections import Counter
    p = _row_plan(8, 1 << 16, W, itemsize, H, 4)
    lanes, bt = p.lanes, p.bt
    cc, pieces = lanes // bt, W * itemsize // p.piece
    slots = []
    for lane in range(32):
        g, j = divmod(lane, lanes)
        phi = (g >> p.phi_shift) & (bt - 1)
        slots.append([Counter({(g * bt + (s ^ (j // cc) ^ phi), j): 1})
                      if j < pieces else Counter() for s in range(bt)])
    m = bt // 2
    while m:
        slots = [[slots[lane][s] + slots[lane ^ (m * cc)][s + m]
                  for s in range(m)] for lane in range(32)]
        m //= 2
    m = cc // 2
    while m:
        slots = [[slots[lane][0] + slots[lane ^ m][0]] for lane in range(32)]
        m //= 2
    owned = Counter()
    for lane in range(32):
        g, j = divmod(lane, lanes)
        row = g * bt + ((j // cc) ^ ((g >> p.phi_shift) & (bt - 1)))
        assert slots[lane][0] == Counter({(row, q): 1 for q in range(pieces)})
        if j % cc == 0:
            owned[row] += 1
    assert owned == Counter(range(32 * bt // lanes))


def test_sweep_plan_refuses_rows_it_cannot_spread():
    with pytest.raises(ValueError, match="pieces"):
        sweep_plan(2, 100, 256, 4, 4, 4, SMS)      # 1 KB rows
    with pytest.raises(ValueError, match="pieces"):
        sweep_plan(2, 100, 512, 1, 8, 4, SMS)      # 64 pieces of 8 bytes


# --------------------------------------------------------------------------
# The least-used sweeps' grid plan (kernels/usage_argmin.py::grid_plan),
# which the CUDA kernels receive, and the row scatter's owner rule
# (csrc/scatter_rows.cu), each followed as the kernel computes it.
# --------------------------------------------------------------------------

def _sweep_pieces(plan, valid_n, offset, per_thread):
    """The [lo, hi) entry ranges of one row that a kernel of
    csrc/usage_argmin.cu sweeps, for a row whose first entry lies
    ``offset`` entries past a 16-byte boundary: block 0's scalar head, the
    blocks' vectors, the last block's scalar tail. With ``per_thread``,
    `topn_kernel`'s vectors thread by thread (vectors start + t + k·T,
    k < count), else each block's range as one piece."""
    head = min((4 - offset) & 3, valid_n)
    nvec = (valid_n - head) >> 2
    tail0 = head + 4 * nvec
    pieces = [(0, head)]
    for c in range(plan.blocks):
        start, end = c * plan.per, min((c + 1) * plan.per, nvec)
        if not per_thread:
            pieces.append((head + 4 * start, head + 4 * max(start, end)))
            continue
        for t in range(TOPN_THREADS):
            count = (-(-(end - start - t) // TOPN_THREADS)
                     if end - start > t else 0)
            first = head + 4 * (start + t)
            pieces += [(first + 4 * TOPN_THREADS * k,
                        first + 4 * TOPN_THREADS * k + 4)
                       for k in range(count)]
    pieces.append((tail0, valid_n))
    return pieces


@pytest.mark.parametrize("kernel", ["lra_topn", "usage_argmin"])
@pytest.mark.parametrize("rows_n", [1000, 4097, 65536, 1 << 18, 1 << 20])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_grid_plan_covers_each_entry_once_in_one_wave(kernel, rows_n, batch):
    """The table is (B, N+1) with the scratch entry last, valid_n = N, so
    row b starts b·(N+1) entries past the table's start; the table itself
    may start at any 4-byte offset from a 16-byte boundary."""
    stride, valid_n = rows_n + 1, rows_n
    topn = kernel == "lra_topn"
    round_vecs = TOPN_THREADS if topn else ARGMIN_THREADS * ARGMIN_VEC
    plan = grid_plan(batch, valid_n, SMS, round_vecs)
    assert batch * plan.blocks <= BLOCKS_PER_SM * SMS          # one wave
    assert plan.blocks <= plan.slots                           # the scratch
    assert plan.per % round_vecs == 0
    assert plan.per * plan.blocks >= valid_n // 4
    if valid_n // 4 >= BLOCKS_PER_SM * SMS * round_vecs:
        # enough rows for the wave: it is at least half full
        assert 2 * batch * plan.blocks >= BLOCKS_PER_SM * SMS
    if (topn, rows_n, batch) == (False, 1 << 20, 8):
        assert (plan.blocks, plan.per) == (32, 8192)   # the source note's
    offsets = sorted({(base + b * stride) % 4 for base in range(4)
                      for b in range(batch)})
    for offset in offsets:
        pieces = sorted(r for r in _sweep_pieces(plan, valid_n, offset, topn)
                        if r[1] > r[0])
        assert pieces[0][0] == 0 and pieces[-1][1] == valid_n
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        head = min((4 - offset) & 3, valid_n)
        assert all((lo - head) % 4 == 0 and (hi - lo) % 4 == 0
                   for lo, hi in pieces[1:-1] if lo >= head)


def _match_any_owners(idx_row, n_rows, add):
    """csrc/scatter_rows.cu's groups for one batch row, followed lane by
    lane: warps of 32 columns grouped by equal index (__match_any_sync),
    the next column found in the warp or by a scan of the later warps, the
    first column by the earlier lanes and a scan of the earlier warps.
    Returns (owner, next) lists; skipped columns own nothing."""
    J = len(idx_row)
    owner, nxt = [False] * J, [-1] * J
    for base in range(0, J, 32):
        lanes = [idx_row[j] if j < J and 0 <= idx_row[j] < n_rows else -1
                 for j in range(base, base + 32)]
        for lane, row in enumerate(lanes):
            j = base + lane
            if row < 0:
                continue
            same = [m for m, r in enumerate(lanes) if r == row]
            above = [m for m in same if m > lane]
            if above:
                nxt[j] = base + above[0]
            else:
                later = [u for u in range(base + 32, J) if idx_row[u] == row]
                nxt[j] = later[0] if later else -1
            first = (not [m for m in same if m < lane]
                     and row not in list(idx_row[:base]))
            owner[j] = first if add else nxt[j] < 0
    return owner, nxt


def _scatter_by_groups(mem, idx, rows, mode):
    """The kernel's result, in numpy f32: each owner writes its row, 'add'
    from the row's old value plus its group's columns in j order."""
    out = mem.copy()
    for b in range(idx.shape[0]):
        owner, nxt = _match_any_owners(list(idx[b]), mem.shape[1],
                                       mode == "add")
        for j, own in enumerate(owner):
            if not own:
                continue
            if mode == "set":
                out[b, idx[b, j]] = rows[b, j]
                continue
            acc = mem[b, idx[b, j]] + rows[b, j]
            u = nxt[j]
            while u >= 0:
                acc = acc + rows[b, u]
                u = nxt[u]
            out[b, idx[b, j]] = acc
    return out


@pytest.mark.parametrize("J", [20, 36, 70])
@pytest.mark.parametrize("mode", ["add", "set"])
def test_scatter_owner_rule_matches_plain_on_heavy_duplicates(J, mode):
    """Three rows named by all J columns, so groups span warps at J > 32;
    bit for bit against `ref.scatter_rows_ref` (the same f32 adds in the
    same order). Columns outside [0, R), which the kernel skips, leave the
    result as if they were not there."""
    rng = np.random.default_rng(J)
    R, Wd, Bd = 9, 6, 3
    mem = rng.standard_normal((Bd, R, Wd)).astype(np.float32)
    idx = rng.integers(0, 3, (Bd, J)).astype(np.int32)
    idx[:, J - 1] = 7                      # a row named once, last
    rows = rng.standard_normal((Bd, J, Wd)).astype(np.float32)
    want = ref.scatter_rows_ref(torch.tensor(mem), torch.tensor(idx),
                                torch.tensor(rows), mode).numpy()
    np.testing.assert_array_equal(_scatter_by_groups(mem, idx, rows, mode),
                                  want)
    outside = idx.copy()
    outside[:, [1, J // 2]] = [-1, R]
    np.testing.assert_array_equal(
        _scatter_by_groups(mem, outside, rows, mode),
        ref.scatter_rows_ref(torch.tensor(mem),
                             torch.tensor(np.delete(idx, [1, J // 2], 1)),
                             torch.tensor(np.delete(rows, [1, J // 2], 1)),
                             mode).numpy())


# --------------------------------------------------------------------------
# The f32/bf16 write's plan (kernels/sparse_write.py::write_plan) and its
# groups (csrc/sparse_write.cu), followed in Python: the CUDA kernel cannot
# run here.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("J,W", [(20, 32), (36, 128), (20, 128), (36, 32),
                                 (72, 128), (20, 30)])
@pytest.mark.parametrize("vec", [1, 4, 8])
def test_write_plan_covers_each_word_once(J, W, vec):
    """Slices of ``words`` words, a multiple of the piece, cover W once;
    the slice of a fits its shared memory; a block has a thread a piece
    (up to the limit) in whole warps; step 21's (20, 32) takes one slice
    and the LM's (36, 128) four of 32 words."""
    H = 4
    if W % vec:
        with pytest.raises(ValueError, match="multiple of vec"):
            write_plan(J, W, H, vec)
        return
    plan = write_plan(J, W, H, vec)
    assert plan.vec == vec and plan.words % vec == 0
    assert (plan.slices - 1) * plan.words < W <= plan.slices * plan.words
    assert H * plan.words <= MAX_A_WORDS
    pieces = J * plan.words // vec
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    assert plan.threads >= min(pieces, MAX_THREADS)
    assert plan.threads < pieces + 32
    if J * (plan.words // vec) > PIECES:       # cut no narrower than allowed
        assert plan.slices == 1 or plan.words // 2 < MIN_WORDS or \
            -(-plan.words // (2 * vec)) * vec >= plan.words
    if (J, W, vec) == (20, 32, 4):
        assert (plan.slices, plan.threads) == (1, 160)
    if (J, W, vec) == (36, 128, 4):
        assert (plan.slices, plan.words, plan.threads) == (4, 32, 288)


def test_write_plan_refuses_what_the_kernel_cannot_stage():
    with pytest.raises(ValueError, match="columns"):
        write_plan(MAX_COLUMNS + 1, 32, 1, 4)
    with pytest.raises(ValueError, match="heads of a"):
        write_plan(20, 32, MAX_A_WORDS, 4)


@pytest.mark.parametrize("J,W_,H_,vec,threads", [
    (20, 32, 4, 16, 64), (36, 128, 4, 16, 288), (592, 128, 4, 16, 512),
    (20, 24, 4, 1, 480), (20, 16, 4, 16, 32), (592, 24, 4, 1, 512),
    (2000, 16, 4, 16, 512), (24, 8192, 8, 16, 512)])
def test_q_plan_threads_and_smem(J, W_, H_, vec, threads):
    """The int8 write's plan: a thread a piece of ``vec`` codes in whole
    warps (64 at step 21's J = 20, W = 32; 288 at the LM's J = 36, W =
    128), at most MAX_Q_THREADS (J = 592 at W = 128: rounds), enough for
    a staged a to go to shared memory in one round; the shared memory a
    block may use holds six words a column and all of a where it fits (not
    H·W = 65536 floats: the sums then read a from device memory; J = 2000
    columns, more than the f32 write's MAX_COLUMNS, still fit)."""
    plan = q_plan(J, W_, H_, vec)
    assert plan.threads == threads and plan.vec == vec
    assert plan.threads % 32 == 0
    assert plan.stage_a == (H_ * W_ < 1 << 16)
    if plan.stage_a:
        assert Q_STAGE * plan.threads >= min(H_ * W_,
                                             Q_STAGE * MAX_Q_THREADS)
    assert plan.smem == q_smem(J, W_, H_, plan.stage_a) <= MAX_SMEM_Q


def test_q_plan_refuses_what_the_kernel_cannot_stage():
    with pytest.raises(ValueError, match="shared memory"):
        q_plan(10_000, 32, 4, 16)
    with pytest.raises(ValueError, match="multiple of vec"):
        q_plan(20, 24, 4, 16)


def _write_groups(idx_row, lra_row, n_rows):
    """csrc/sparse_write.cu's groups for one batch row, followed lane by
    lane: warps of 32 columns grouped by equal row (__match_any_sync), the
    next column found in the warp or by a scan of the later warps, the
    owner being the first column (earlier lanes and a scan of the earlier
    warps), erased if an LRA row names its row. Returns (flags, next)."""
    owner, nxt = _match_any_owners(idx_row, n_rows, True)
    erase = [own and idx_row[j] in list(lra_row) for j, own in
             enumerate(owner)]
    return owner, erase, nxt


def _write_by_groups(mem, la, widx, ww, a, lra, step, delta, scale=None):
    """The kernel's result: each owner's row from its old value (zero if
    erased) plus its group's columns in j order, rounded as the kernel
    rounds (f32: product and sum apart; bf16: each to bf16; int8 rows with
    their ``scale``: dequantized, one FMA a column, then s' = max|row|·
    fl(1/127) and the codes rint(row / s')); the la cell stamped where a
    group column has w > delta."""
    mem, la = mem.clone(), la.clone()
    scale = None if scale is None else scale.clone()
    B, J = widx.shape
    kp1 = J // a.shape[1]
    bf16 = mem.dtype == torch.bfloat16
    for b in range(B):
        owner, erase, nxt = _write_groups(widx[b].tolist(), lra[b].tolist(),
                                          mem.shape[1] - 1)
        for j in range(J):
            if not owner[j]:
                continue
            row = int(widx[b, j])
            if erase[j]:
                acc = torch.zeros(mem.shape[2])
            elif scale is not None:
                acc = mem[b, row].float() * scale[b, row]
            else:
                acc = mem[b, row].float()
            u, touched = j, False
            while u >= 0:
                if scale is not None:          # one FMA a column
                    acc = ref.fma_f32(ww[b, u].expand(acc.shape),
                                      a[b, u // kp1], acc)
                elif bf16:
                    p = ww[b, u] * a[b, u // kp1]
                    acc = (acc + p.bfloat16().float()).bfloat16().float()
                else:
                    acc = acc + ww[b, u] * a[b, u // kp1]
                touched |= bool(ww[b, u] > delta)
                u = nxt[u]
            if scale is not None:              # max|row| over its pieces
                s_new = acc.abs().max() * quant.INV_QMAX
                q = acc / (s_new if s_new > 0 else 1.0)
                mem[b, row] = q.round().clamp(-127, 127).to(torch.int8)
                scale[b, row] = s_new
            else:
                mem[b, row] = acc.to(mem.dtype)
            if touched:
                la[b, row] = max(int(la[b, row]), int(step[b]))
    return (mem, la) if scale is None else (mem, la, scale)


@pytest.mark.parametrize("case", ["one-row", "lra-later", "at-delta",
                                  "scratch", "heavy-36", "heavy-72"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_write_groups_match_plain_bit_for_bit(case, dtype):
    """The kernels' ownership rule (first column owns, LRA rows erased,
    groups across warps at J > 32) gives the plain write's rows and usage
    (on int8 rows codes and scales too, the max taken over the row's
    pieces) bit for bit on its edge cases: every column on one row; an LRA
    row that a later head's column names; weights exactly at delta; every
    column on the scratch row with weight 0 (ignored); heavy duplicates at
    J = 36 and 72, with a per-lane step."""
    rng = np.random.default_rng(len(case))
    Hd, Kd = (4, 8) if case == "heavy-36" else (8, 8) if case == "heavy-72" \
        else (4, 4)
    Bd, Nd, Wd, J = 3, 40, 8, Hd * (Kd + 1)
    mem = rng.standard_normal((Bd, Nd + 1, Wd)).astype(np.float32)
    mem[:, Nd] = 0.0
    la = rng.integers(-50, 50, (Bd, Nd + 1)).astype(np.int32)
    la[:, Nd] = LA_SCRATCH
    widx = rng.integers(0, Nd, (Bd, Hd, Kd + 1)).astype(np.int32)
    ww = rng.random((Bd, J)).astype(np.float32)
    a = rng.standard_normal((Bd, Hd, Wd)).astype(np.float32)
    if case == "one-row":
        widx[:] = 17
    elif case == "lra-later":
        widx[:, 2, 0] = widx[:, 0, Kd]
        widx[:, 3, 1] = widx[:, 0, Kd]
    elif case == "at-delta":
        ww[:, ::2] = np.float32(0.005)
    elif case.startswith("heavy"):
        widx = rng.integers(0, 3, widx.shape).astype(np.int32)
    lra = widx[:, :, Kd].copy()
    widx = widx.reshape(Bd, J)
    if case == "scratch":
        widx[:] = Nd
        lra[:] = Nd
        ww[:] = 0.0
    step = np.array([60, 7, 61], np.int32)
    t = {k: torch.tensor(v) for k, v in dict(mem=mem, la=la, widx=widx,
                                              ww=ww, a=a, lra=lra,
                                              step=step).items()}
    scale = None
    if dtype == "int8":
        t["mem"], scale = quant.quantize_rows(t["mem"])
    else:
        t["mem"] = t["mem"].to(getattr(torch, dtype))
    got = _write_by_groups(t["mem"], t["la"], t["widx"], t["ww"], t["a"],
                           t["lra"], t["step"], 0.005, scale)
    want_m, want_l = t["mem"].clone(), t["la"].clone()
    if scale is None:
        ref.sparse_write_update_ref(want_m, want_l, t["widx"], t["ww"],
                                    t["a"], t["lra"], t["step"], 0.005)
    else:
        want_s = scale.clone()
        ref.sparse_write_update_q_ref(want_m, want_s, want_l, t["widx"],
                                      t["ww"], t["a"], t["lra"], t["step"],
                                      0.005)
        assert torch.equal(got[2].view(torch.int32), want_s.view(torch.int32))
    bits = {"bfloat16": torch.int16, "int8": torch.int8}.get(dtype,
                                                             torch.int32)
    assert torch.equal(got[0].view(bits), want_m.view(bits))
    assert torch.equal(got[1], want_l)
    if case == "scratch":
        assert torch.equal(got[0], t["mem"]) and torch.equal(got[1], t["la"])


# --------------------------------------------------------------------------
# The candidate read's plan (kernels/fused_read_candidates.py::cand_plan)
# and its selection (csrc/fused_read_candidates.cu: one 64-bit key a
# candidate, each warp's K best, ranked by counting the keys that beat
# each), followed in Python.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("C", [4, 148, 300])
@pytest.mark.parametrize("W", [32, 128])
@pytest.mark.parametrize("per", [4, 8, 16])
def test_cand_plan_tiles_fit_and_threads_cover_them(C, W, per):
    """A tile of min(C, 256) rows (C = 148, the smoke's, in one tile; 300
    in two), a thread to score each row of it, the tile's loads at no more
    than LOADS a thread unless the block is at its limit, whole warps, and
    shared memory within the block's limit."""
    plan = cand_plan(C, W, per, 4)
    assert plan.tile == min(C, MAX_TILE)
    assert plan.threads % 32 == 0 and plan.tile <= plan.threads <= 512
    loads = plan.tile * (W // per)
    assert plan.threads * LOADS >= loads or plan.threads == 512
    assert plan.threads < max(plan.tile, -(-loads // LOADS)) + 32
    assert plan.smem == cand_smem(C, W, 4, plan.tile, plan.threads)
    assert plan.smem <= MAX_SMEM
    if (C, W, per) == (148, 32, 4):
        assert (plan.tile, plan.threads) == (148, 160)


def test_cand_plan_shrinks_the_tile_to_fit():
    plan = cand_plan(300, 1024, 4, 8)
    assert plan.tile < MAX_TILE and plan.smem <= MAX_SMEM
    with pytest.raises(ValueError, match="do not fit"):
        cand_plan(300, 1 << 16, 4, 8)


def _order_key(v: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The kernel's key: the f32 bits made monotone (-0 as +0), then the
    position reversed."""
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    u = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                   - pos.astype(np.uint64))


def _select_by_keys(sims, cand, k, tile, threads):
    """The kernel's selection of one (b, h): for each tile, each warp's k
    best keys (its lanes' candidates sorted, 0 where a lane has none);
    then the key of the lists that r others beat is selection r. Returns
    the positions of the k selected."""
    C = len(cand)
    v = np.where(cand < 0, np.float32(-1e9), sims).astype(np.float32)
    keys = _order_key(v, np.arange(C))
    lists = []
    for c0 in range(0, C, tile):
        n = min(tile, C - c0)
        for w0 in range(0, threads, 32):
            mine = [keys[c0 + t] for t in range(w0, w0 + 32) if t < n]
            best = sorted(mine, reverse=True)[:k]
            lists += best + [np.uint64(0)] * (k - len(best))
    lists = np.array(lists, dtype=np.uint64)
    sel = [-1] * k
    for key in lists[lists > 0]:
        rank = int((lists > key).sum())
        if rank < k:
            sel[rank] = 0xFFFFFFFF - int(key & np.uint64(0xFFFFFFFF))
    return sel


@pytest.mark.parametrize("C", [4, 148, 300])
@pytest.mark.parametrize("case", ["rand", "zero", "cold", "copies"])
def test_candidate_keys_select_as_the_plain_sort(C, case):
    """Keys, each warp's sorted K best and their ranks give
    `ref.candidate_topk`'s selection: (similarity desc, position asc), a
    -1 only when fewer than K are valid, ties (a zero memory, copies of one
    row) by position, every slot filled; at the plan's tile and threads,
    so C = 300 spans two tiles."""
    rng = np.random.default_rng(C)
    Bd, Hd, Nd, Wd, Kd = 2, 3, 500, 16, 4
    mem = rng.standard_normal((Bd, Nd, Wd)).astype(np.float32)
    q = rng.standard_normal((Bd, Hd, Wd)).astype(np.float32)
    cand = np.stack([rng.choice(Nd, C, replace=False)
                     for _ in range(Bd * Hd)]).reshape(Bd, Hd, C)
    if case == "zero":
        mem[:] = 0.0
        cand[:, :, ::3] = -1
    elif case == "cold":
        cand[:] = -1
        cand[0, 0, C - 1] = 5
    elif case == "copies":
        mem[:, cand[0, 0, ::5]] = mem[:, :1]
        q[:] = mem[:, :1]
    cand = cand.astype(np.int32)
    mem_t, q_t, cand_t = map(torch.tensor, (mem, q, cand))
    words = ref.gather_words(mem_t, cand_t.clamp_min(0))
    sims = torch.einsum("bhw,bhcw->bhc", ref._normalize(q_t),
                        ref._normalize(words)).numpy()
    want = ref.candidate_topk(q_t, mem_t, Kd, cand_t).numpy()
    plan = cand_plan(C, Wd, 4, Kd)
    for b in range(Bd):
        for h in range(Hd):
            pos = _select_by_keys(sims[b, h], cand[b, h], Kd, plan.tile,
                                  plan.threads)
            assert -1 not in pos
            np.testing.assert_array_equal(cand[b, h][pos], want[b, h])
