"""The port's slot-sharded memory (`repro_torch.distributed.mem_shard`)
against the JAX package, on the CPU, with S gloo ranks.

The layouts and the plain `topk_read` are held against JAX's in this
process. The sharded forward runs at `tests/test_mesh_parity.py`'s sizes
(N = 64, W = 8, H = 2, K = 2, B = 2, D = 6, T = 6) in S = 2 and S = 4
spawned ranks, one spawn per S with every case inside it; the ranks write
what they computed to files and the tests below compare it. The JAX side
is the single-device `sam_unroll` under the ``ref`` and the
``pallas-interpret`` backends (JAX's own suite holds its mesh to those
results within 1e-5). This module imports JAX only inside the functions
that run in the test process, so the spawned ranks never load it.

Bars: every rank's outputs equal bit for bit (they run the replicated
controller on the same merged selections); floats (ys, read words, the
logical memory) within 1e-5 of JAX; read indices and usage tables exact;
the layouts exact; the sharded ops against their single-device
counterparts exactly (the gathered rows, whose sum over ranks adds only
zeros, and the write, whose owned rows take the same columns in the same
order, bit for bit), but for the top-K's scores: the plain sweep of a
block sums in another order than that of the whole memory (1e-5).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.core import addressing as addr
from repro_torch.core import sam
from repro_torch.core.types import (LA_SCRATCH, ControllerConfig,
                                    LSTMState, MemoryConfig, SAMState,
                                    SparseRead)
from repro_torch.distributed import mem_shard
from repro_torch.kernels import ops, ref

N, W, H, K, B, T, D, HIDDEN = 64, 8, 2, 2, 2, 6, 6, 16
N_BIG = 256                 # the second N of the collective-bytes check
SPLIT = 3                   # the converted state starts after this step
TOL = 1e-5


def _cfg(n=N):
    return sam.SAMConfig(MemoryConfig(num_slots=n, word_size=W, num_heads=H,
                                      k=K),
                         ControllerConfig(D, HIDDEN, D))


def _xs():
    return np.random.default_rng(1).standard_normal((T, B, D)).astype(
        np.float32)


def _np_state(st) -> SAMState:
    """A JAX `SAMState` with numpy leaves in the port's containers, so it
    pickles without JAX."""
    return SAMState(
        memory=np.asarray(st.memory), last_access=np.asarray(st.last_access),
        read=SparseRead(*(np.asarray(x) for x in st.read)),
        ctrl=LSTMState(np.asarray(st.ctrl.h), np.asarray(st.ctrl.c)),
        step=np.asarray(st.step))


# --------------------------------------------------------------------------
# In this process: the layouts and the plain top-K against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("leaf", ["memory", "usage"])
def test_layouts_match_jax(S, leaf):
    import jax.numpy as jnp

    from repro.distributed import mem_shard as jshard
    rng = np.random.default_rng(S)
    if leaf == "memory":
        x = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    else:
        x = rng.integers(-100, 100, (B, N + 1)).astype(np.int32)
        x[:, N] = LA_SCRATCH
    j_sharded = np.asarray(jshard.to_shard_layout(jnp.asarray(x), N, S))
    rows = N // S + 1
    for r in range(S):
        np.testing.assert_array_equal(
            mem_shard.shard_block(torch.tensor(x), N, S, r).numpy(),
            j_sharded[:, r * rows:(r + 1) * rows])
    np.testing.assert_array_equal(
        mem_shard.from_shard_layout(torch.tensor(j_sharded), N, S).numpy(),
        np.asarray(jshard.from_shard_layout(jnp.asarray(j_sharded), N, S)))


def _topk_inputs(case, rows, seed):
    rng = np.random.default_rng(seed)
    mem = rng.standard_normal((B, rows, W)).astype(np.float32)
    q = rng.standard_normal((B, H, W)).astype(np.float32)
    if case == "zero":
        mem[:] = 0.0
    elif case == "dup":                    # equal rows, the best, straddling
        for r in (rows // 2 - 1, rows // 2, rows - 2):
            mem[:, r] = mem[:, 3]
        q = mem[:, 3][:, None, :] + 0.01 * q
    return q, mem


@pytest.mark.parametrize("case", ["rand", "zero", "dup"])
@pytest.mark.parametrize("where", ["canonical", "block"])
def test_topk_read_plain_matches_jax(case, where):
    """On the canonical (B, N+1, W) buffer (valid_n = N) and on a rank's
    (B, N/4 + 1, W) block (valid_n = N/4): indices exact, vals within
    1e-5, against JAX's oracle and the interpret-mode Pallas kernel."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.topk_read import topk_read as pallas_topk
    n = N if where == "canonical" else N // 4
    q, mem = _topk_inputs(case, n + 1, seed=n)
    vals, idx = ops.topk_read(torch.tensor(q), torch.tensor(mem), K,
                              valid_n=n)
    want = [jref.topk_read_ref(jnp.asarray(q), jnp.asarray(mem[:, :n]), K),
            pallas_topk(jnp.asarray(q), jnp.asarray(mem), k=K, block_n=8,
                        interpret=True, valid_n=n)]
    for j_vals, j_idx in want:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals),
                                   atol=TOL, rtol=0)
    if case == "zero":
        np.testing.assert_array_equal(
            idx.numpy(), np.broadcast_to(np.arange(K), (B, H, K)))
    if case == "dup":
        np.testing.assert_array_equal(
            idx.numpy(), np.broadcast_to([3, n // 2 - 1], (B, H, K)))


def test_usage_stamp_matches_jax():
    """`addressing.update_last_access` (the read's usage stamp, whose
    `ref.stamp_usage` the sharded stamp and the plain write share) on one
    device: duplicate indices, weights on both sides of δ, against JAX."""
    import jax.numpy as jnp

    from repro.core import addressing as jaddr
    rng = np.random.default_rng(3)
    la = rng.integers(-N, 5, (B, N + 1)).astype(np.int32)
    idx = rng.integers(0, N, (B, H * K)).astype(np.int32)
    idx[:, 1] = idx[:, 0]
    w = rng.random((B, H * K)).astype(np.float32)
    w[:, 0], w[:, 2] = 0.001, 0.001
    got = addr.update_last_access(torch.tensor(la), torch.tensor(idx),
                                  torch.tensor(w), torch.tensor(9), 0.005)
    want = jaddr.update_last_access(jnp.asarray(la), jnp.asarray(idx),
                                    jnp.asarray(w), jnp.int32(9), 0.005)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sam_step_refuses_a_block_without_its_context():
    """A (B, N/S + 1, W) block outside `memory_mesh` matches no layout of
    an N-slot memory and raises, rather than passing for a small one."""
    cfg = _cfg()
    params = sam.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    block = sam.init_state(B, sam.SAMConfig(
        MemoryConfig(num_slots=N // 4, word_size=W, num_heads=H, k=K),
        cfg.controller), device="cpu")
    with pytest.raises(ValueError, match="matches no known layout"):
        sam.sam_step(params, cfg, block, torch.zeros((B, D)))


# --------------------------------------------------------------------------
# The spawned ranks
# --------------------------------------------------------------------------

def _boundary_cases(ctx, rng):
    """Each sharded op alone against its single-device counterpart on one
    canonical input: {name: (sharded, single-device)} as numpy."""
    n, ln = ctx.num_slots, ctx.local_n
    out = {}

    def block(x):
        return mem_shard.shard_block(x, n, ctx.shards, ctx.rank)

    # LRA: the minimum on a shard boundary (two rows of two ranks), and an
    # all-equal table.
    la = torch.tensor(rng.integers(0, 50, (B, n + 1)), dtype=torch.int32)
    la[:, ln - 1] = la[:, ln] = -7
    la[:, n] = LA_SCRATCH
    tie = la.clone()
    tie[:, :n] = 5
    for name, t in (("lra boundary", la), ("lra all equal", tie)):
        out[name] = (mem_shard.lra_topn_sharded(ctx, block(t), H),
                     ops.lra_topn(t, H, valid_n=n))
    # top-K: random, all zero, equal best rows on a shard boundary.
    for case in ("rand", "zero", "dup"):
        q, mem = _topk_inputs(case, n + 1, seed=11)
        if case == "dup":
            mem[:, ln] = mem[:, ln - 1] = mem[:, 3]
        q, mem = torch.tensor(q), torch.tensor(mem)
        vals, idx = mem_shard.topk_read_sharded(ctx, q, block(mem), K)
        r_vals, r_idx = ops.topk_read(q, mem, K, valid_n=n)
        out[f"topk {case} idx"] = (idx, r_idx)
        out[f"topk {case} vals"] = (vals, r_vals)
    # Rows, the write and the read-side stamp, with duplicates and every
    # rank owning some.
    mem = torch.tensor(rng.standard_normal((B, n + 1, W)), dtype=torch.float32)
    mem[:, n] = 0.0
    idx = torch.tensor(rng.integers(0, n, (B, H * (K + 1))), dtype=torch.int32)
    idx[:, 1] = idx[:, 0]
    out["gather_rows"] = (addr.gather_rows(block(mem), idx, shard=ctx),
                          ref.gather_rows(mem, idx))
    ww = torch.tensor(rng.random((B, H * (K + 1))), dtype=torch.float32)
    ww[:, 2] = 0.001
    a = torch.tensor(rng.standard_normal((B, H, W)), dtype=torch.float32)
    lra = idx.reshape(B, H, K + 1)[..., K].contiguous()
    step = torch.tensor(9, dtype=torch.int32)
    m_s, l_s = mem_shard.sparse_write_update_sharded(
        ctx, block(mem), block(la), idx, ww, a, lra, step, delta=0.005)
    m_1, l_1 = ops.sparse_write_update(mem.clone(), la.clone(), idx, ww, a,
                                       lra, step, delta=0.005)
    out["write memory"] = (mem_shard.gather_blocks(ctx, m_s), m_1)
    out["write scratch row"] = (m_s[:, ln], torch.zeros((B, W)))
    out["write usage"] = (mem_shard.gather_blocks(ctx, l_s), l_1)
    l_s = mem_shard.update_last_access_sharded(ctx, block(la), idx, ww, step,
                                               0.005)
    out["read stamp"] = (mem_shard.gather_blocks(ctx, l_s),
                         addr.update_last_access(la.clone(), idx, ww, step,
                                                 0.005))
    return {k: (v[0].numpy(), v[1].numpy()) for k, v in out.items()}


def _refusals(ctx, cfg, params):
    """(case, exception type, message) of each call the mesh must refuse."""
    out = []

    def expect(case, fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            out.append((case, type(e).__name__, str(e)))
        else:
            out.append((case, None, ""))

    q = torch.zeros((B, H, W))
    blk = torch.zeros((B, ctx.local_rows, W))
    expect("K > local_n", lambda: mem_shard.topk_read_sharded(
        ctx, q, blk, ctx.local_n + 1))
    expect("n > local_n", lambda: mem_shard.lra_topn_sharded(
        ctx, torch.zeros((B, ctx.local_rows), dtype=torch.int32),
        ctx.local_n + 1))
    expect("N % S", lambda: mem_shard.memory_mesh(N + 1).__enter__())
    lsh = sam.SAMConfig(MemoryConfig(num_slots=N, word_size=W, num_heads=H,
                                     k=K, ann="lsh"), cfg.controller)
    expect("lsh read", lambda: sam.sam_step(
        params, lsh, sam.init_state(B, lsh, device="cpu"),
        torch.zeros((B, D))))
    state = sam.init_state(B, cfg, device="cpu")
    expect("training", lambda: sam.sam_step(params, cfg, state,
                                            torch.zeros((B, D)),
                                            collect_deltas=True))
    leaves = {g: {n: t.clone().requires_grad_() for n, t in grp.items()}
              for g, grp in params.items()}
    expect("autograd", lambda: sam.sam_step(leaves, cfg, state,
                                            torch.zeros((B, D))))
    return out


def _rank(rank, shards, path, jparams, xs, split_state):
    """One rank: the forward (unroll and step by step), a run from a
    converted JAX state, the collective bytes at two N, the ops alone and
    the refusals, written to ``path``/rank<r>.pkl."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/init",
                            rank=rank, world_size=shards)
    cfg = _cfg()
    params = convert.params_from_jax(jparams, device="cpu")
    xs = torch.tensor(xs)
    res = {}
    with mem_shard.memory_mesh(N) as ctx:
        state = sam.init_state(B, cfg, device="cpu")
        res["block_rows"] = state.memory.shape[1]
        res["first_la"] = state.last_access.numpy().copy()
        final, ys = sam.sam_unroll(params, cfg, state, xs)
        res["ys"] = ys.numpy()
        res["final_memory"] = mem_shard.gather_blocks(ctx,
                                                      final.memory).numpy()
        res["final_la"] = mem_shard.gather_blocks(ctx,
                                                  final.last_access).numpy()
        steps, state = [], sam.init_state(B, cfg, device="cpu")
        with torch.inference_mode():
            for x in xs:
                state, y = sam.sam_step(params, cfg, state, x)
                steps.append({
                    "y": y.numpy(), "idx": state.read.indices.numpy(),
                    "words": state.read.words.numpy(),
                    "memory": mem_shard.gather_blocks(ctx,
                                                      state.memory).numpy(),
                    "la": mem_shard.gather_blocks(
                        ctx, state.last_access).numpy()})
        res["steps"] = steps
        # From the JAX state after SPLIT steps, cut into this rank's block.
        state = convert.sharded_state_from_jax(split_state, ctx, device="cpu")
        res["split_rows"] = state.memory.shape[1]
        final, ys = sam.sam_unroll(params, cfg, state, xs[SPLIT:])
        res["split_ys"] = ys.numpy()
        res["split_memory"] = mem_shard.gather_blocks(ctx,
                                                      final.memory).numpy()
        res["ops"] = _boundary_cases(ctx, np.random.default_rng(7))
        # A whole memory of local_n slots has a block's row count, and is
        # not a block.
        res["small_layout"] = mem_shard.memory_layout(ctx.local_n,
                                                      ctx.local_rows)
        res["refusals"] = _refusals(ctx, cfg, params)
    # The bytes each rank sends per step, at two memory sizes.
    res["bytes"] = {}
    for n in (N, N_BIG):
        with mem_shard.memory_mesh(n) as ctx:
            state = sam.init_state(B, _cfg(n), device="cpu")
            ctx.collectives.reset()
            sam.sam_unroll(params, _cfg(n), state, xs)
            res["bytes"][n] = ({k: v / T for k, v in
                                ctx.collectives.bytes.items()},
                               dict(ctx.collectives.calls))
            res["current"] = mem_shard.memory_layout(
                n, ctx.local_rows) is ctx
    # Outside the context the same block is refused again.
    try:
        mem_shard.memory_layout(N_BIG, N_BIG // shards + 1)
        res["current_after"] = None
    except ValueError as e:
        res["current_after"] = str(e)
    with open(os.path.join(path, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX single-device run, per backend: its parameters, per-step
    states and ys, and the state after SPLIT steps, as numpy."""
    import jax

    from repro.core import sam as jsam
    from repro.core.types import ControllerConfig as JC
    from repro.core.types import MemoryConfig as JM
    out = {}
    xs = _xs()
    for backend in ("ref", "pallas-interpret"):
        jcfg = jsam.SAMConfig(JM(num_slots=N, word_size=W, num_heads=H, k=K,
                                 backend=backend), JC(D, HIDDEN, D))
        params = jsam.init_params(jax.random.PRNGKey(0), jcfg)
        state = jsam.init_state(B, jcfg)
        step = jax.jit(lambda p, s, x: jsam.sam_step(p, jcfg, s, x))
        states, ys = [], []
        for x in xs:
            state, y = step(params, state, x)
            states.append(_np_state(state))
            ys.append(np.asarray(y))
        out[backend] = dict(params=jax.tree.map(np.asarray, params),
                            states=states, ys=np.stack(ys))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def mesh_run(request, jax_runs, tmp_path_factory):
    """Spawn S gloo ranks once and load what each wrote."""
    S = request.param
    path = str(tmp_path_factory.mktemp(f"mesh{S}"))
    ref_run = jax_runs["ref"]
    mp.spawn(_rank, args=(S, path, ref_run["params"], _xs(),
                          ref_run["states"][SPLIT - 1]), nprocs=S)
    runs = []
    for r in range(S):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            runs.append(pickle.load(f))
    return S, runs


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_mesh_ranks_agree_bit_for_bit(mesh_run):
    S, runs = mesh_run
    for r, run in enumerate(runs):
        assert run["block_rows"] == run["split_rows"] == N // S + 1
        # The staggered usage of block r: -(r·N/S) ... , then LA_SCRATCH.
        np.testing.assert_array_equal(
            run["first_la"][0, :-1], -np.arange(r * N // S, (r + 1) * N // S))
        assert run["first_la"][0, -1] == LA_SCRATCH
        for key in ("ys", "final_memory", "final_la", "split_ys"):
            np.testing.assert_array_equal(run[key], runs[0][key])
        for a, b in zip(run["steps"], runs[0]["steps"]):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
def test_mesh_forward_matches_jax(mesh_run, jax_runs, backend):
    """Every step: y and the read words within 1e-5, the read indices and
    the usage table exact, the logical memory within 1e-5 (its scratch row
    is filled afresh by the gather, so only rows [0, N) compare)."""
    _, runs = mesh_run
    want = jax_runs[backend]
    run = runs[0]
    _close(run["ys"], want["ys"])
    for t, (got, st) in enumerate(zip(run["steps"], want["states"])):
        _close(got["y"], want["ys"][t])
        np.testing.assert_array_equal(got["idx"], st.read.indices)
        _close(got["words"], st.read.words)
        np.testing.assert_array_equal(got["la"], st.last_access)
        _close(got["memory"][:, :N], st.memory[:, :N])
    np.testing.assert_array_equal(run["final_la"], want["states"][-1]
                                  .last_access)
    _close(run["final_memory"][:, :N], want["states"][-1].memory[:, :N])
    # From the JAX state after SPLIT steps, converted per rank.
    _close(run["split_ys"], want["ys"][SPLIT:])
    _close(run["split_memory"][:, :N], want["states"][-1].memory[:, :N])


def test_mesh_ops_match_single_device(mesh_run):
    """Each sharded op alone: the LRA merge with its minimum on a shard
    boundary and on an all-equal table, the top-K (random, all zero, equal
    best rows on a shard boundary), the row gather, the write and the read
    stamp, exactly; the top-K's scores within 1e-5."""
    _, runs = mesh_run
    for run in runs:
        for name, (got, want) in run["ops"].items():
            assert got.dtype == want.dtype, name
            if name.endswith("vals"):       # the plain sweep sums a block
                _close(got, want)           # in another order than N rows
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
    ops_ = runs[0]["ops"]
    ln = N // mesh_run[0]
    np.testing.assert_array_equal(ops_["lra boundary"][0][0], [ln - 1, ln])
    np.testing.assert_array_equal(ops_["lra all equal"][0][0], np.arange(H))
    np.testing.assert_array_equal(ops_["topk zero idx"][0][0, 0],
                                  np.arange(K))
    np.testing.assert_array_equal(ops_["topk dup idx"][0][0, 0], [3, ln - 1])


def test_mesh_collective_bytes_independent_of_n(mesh_run):
    """The bytes a rank sends per step are the same at N = 64 and 256:
    (B, H, K) scores and indices and (B, H) LRA stalenesses and indices
    gathered, (B, H·K, W) rows summed."""
    S, runs = mesh_run
    for run in runs:
        small, big = run["bytes"][N], run["bytes"][N_BIG]
        assert small == big
        assert small[0] == {"all_gather": 4 * (2 * B * H * K + 2 * B * H),
                            "psum": 4 * B * H * K * W}
        assert small[1] == {"all_gather": 4 * T, "psum": T}


def test_mesh_refuses_what_it_does_not_run(mesh_run):
    _, runs = mesh_run
    got = {case: (kind, msg) for case, kind, msg in runs[0]["refusals"]}
    assert runs[0]["small_layout"] is None         # a whole, small memory
    assert runs[0]["current"]
    assert "matches no known layout" in runs[0]["current_after"]
    assert got["K > local_n"][0] == "ValueError"
    assert "per shard" in got["K > local_n"][1]
    assert got["n > local_n"][0] == "ValueError"
    assert got["N % S"][0] == "ValueError"
    assert "equal blocks" in got["N % S"][1]
    for case in ("lsh read", "training", "autograd"):
        assert got[case][0] == "NotImplementedError", case
    assert "A11" in got["training"][1] and "A11" in got["lsh read"][1]
