"""The port's slot-sharded memory (`repro_torch.distributed.mem_shard`)
against the JAX package, on the CPU, with S gloo ranks.

The layouts and the plain `topk_read` are held against JAX's in this
process. The sharded forward and training run at
`tests/test_mesh_parity.py`'s sizes (N = 64, W = 8, H = 2, K = 2, B = 2,
D = 6, T = 6) in S = 2 and S = 4 spawned ranks, one spawn per S with every
case inside it; the ranks write what they computed to files and the tests
below compare it. The JAX side is the single-device `sam_unroll` under the
``ref`` and the ``pallas-interpret`` backends (JAX's own suite holds its
mesh to those results within 1e-5), and, for training, JAX's
single-device `unroll.unroll` under `jax.value_and_grad` of
``(ys ** 2).sum()`` on f32 rows (naive, sparse, chunked), int8 rows
(sparse, chunked) and bf16 rows (sparse). This module imports JAX only
inside the functions that run in the test process, so the spawned ranks
never load it.

Bars: every rank's outputs equal bit for bit, gradients included (they run
the replicated controller on the same merged selections, and no parameter
gradient is all-reduced); floats (ys, read words, the logical memory,
gradients) within 1e-5 of JAX; bf16 rows' gradients within
`BF16_GRAD_BAR` of max(1, |g|); int8 scales within rtol 1e-6; read
indices, usage tables and int8 codes exact; the layouts exact; the sharded
ops against their single-device counterparts exactly (the gathered rows,
whose sum over ranks adds only zeros, and the write, whose owned rows take
the same columns in the same order, bit for bit), but for the top-K's
scores: the plain sweep of a block sums in another order than that of the
whole memory (1e-5).
"""
from __future__ import annotations

import concurrent.futures
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree

from repro_torch import convert
from repro_torch.core import addressing as addr
from repro_torch.core import dnc, sam, training
from repro_torch.core import unroll as unroll_lib
from repro_torch.core.cell import SAMCell
from repro_torch.core.types import (LA_SCRATCH, ControllerConfig,
                                    LSTMState, MemoryConfig, SAMState,
                                    SparseRead)
from repro_torch.distributed import mem_shard
from repro_torch.kernels import ops, ref

N, W, H, K, B, T, D, HIDDEN = 64, 8, 2, 2, 2, 6, 6, 16
N_BIG = 256                 # the second N of the collective-bytes check
SPLIT = 3                   # the converted state starts after this step
TOL = 1e-5
SCALE_RTOL = 1e-6           # int8 scales: an ulp of torch-XLA drift
# bf16 rows' gradients, of max(1, |g|): twice JAX's own spread across its
# modes and backends on bf16 rows (tests/test_torch_dtypes.py::_bf16_bar,
# 0.0205 there): one bf16 rounding of the memory's cotangent that drift
# flips moves a gradient by up to a bf16 ulp.
BF16_GRAD_BAR = 0.0205
# The sharded training cases: (row dtype, unroll mode, chunk).
TRAIN_CASES = [("float32", "naive", None), ("float32", "sparse", None),
               ("float32", "chunked", 3), ("int8", "naive", None),
               ("int8", "sparse", None), ("int8", "chunked", 3),
               ("bfloat16", "naive", None), ("bfloat16", "sparse", None)]
TRAIN_IDS = [f"{d}-{m}" for d, m, _ in TRAIN_CASES]


def _cfg(n=N, dtype="float32"):
    return sam.SAMConfig(MemoryConfig(num_slots=n, word_size=W, num_heads=H,
                                      k=K, mem_dtype=dtype),
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
@pytest.mark.parametrize("leaf", ["memory", "usage", "bf16", "int8",
                                  "scale"])
def test_layouts_match_jax(S, leaf):
    """Each slot leaf (f32, bf16 and int8 rows, the usage table, int8
    rows' (B, N+1) scales) cut into blocks and put back as JAX's
    `to_shard_layout` and `from_shard_layout` do, scratch fills included."""
    import jax.numpy as jnp

    from repro.distributed import mem_shard as jshard
    rng = np.random.default_rng(S)
    if leaf == "usage":
        x = rng.integers(-100, 100, (B, N + 1)).astype(np.int32)
        x[:, N] = LA_SCRATCH
    elif leaf == "int8":
        x = rng.integers(-127, 128, (B, N + 1, W)).astype(np.int8)
    elif leaf == "scale":
        x = rng.random((B, N + 1)).astype(np.float32)
    else:
        x = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    t, j = torch.tensor(x), jnp.asarray(x)
    if leaf == "bf16":
        t, j = t.bfloat16(), j.astype(jnp.bfloat16)

    def np_(a):
        a = a.float() if isinstance(a, torch.Tensor) and a.dtype == \
            torch.bfloat16 else a
        return np.asarray(a, dtype=np.float32 if leaf == "bf16" else None)

    j_sharded = jshard.to_shard_layout(j, N, S)
    rows = N // S + 1
    for r in range(S):
        np.testing.assert_array_equal(
            np_(mem_shard.shard_block(t, N, S, r)),
            np_(j_sharded[:, r * rows:(r + 1) * rows]))
    t_sharded = torch.tensor(np.asarray(j_sharded, dtype=np.float32)
                             if leaf == "bf16" else np.asarray(j_sharded))
    if leaf == "bf16":
        t_sharded = t_sharded.bfloat16()
    np.testing.assert_array_equal(
        np_(mem_shard.from_shard_layout(t_sharded, N, S)),
        np_(jshard.from_shard_layout(j_sharded, N, S)))


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


def _rows(mem, dtype):
    """(port rows, JAX rows, port scales, JAX scales) of an f32 memory
    stored as ``dtype``: bf16 rows rounded, int8 rows quantized as the
    port's write quantizes them (`quant.quantize_rows`)."""
    import jax.numpy as jnp

    from repro_torch.core.quant import quantize_rows
    t = torch.tensor(mem)
    if dtype == "bfloat16":
        return (t.bfloat16(), jnp.asarray(mem).astype(jnp.bfloat16), None,
                None)
    codes, scale = quantize_rows(t)
    return (codes, jnp.asarray(codes.numpy()), scale,
            jnp.asarray(scale.numpy()))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", ["rand", "zero", "dup"])
@pytest.mark.parametrize("where", ["canonical", "block"])
def test_topk_read_plain_on_bf16_and_int8_rows_matches_jax(dtype, case,
                                                            where):
    """`topk_read` on bf16 rows and on int8 rows with their scales, on the
    canonical buffer and on a rank's block: the indices are those of JAX's
    single-device exact read (`jref.fused_read_ref`, which upcasts bf16
    rows and dequantizes int8 rows before the norm), and the scores within
    1e-5 of the picked rows' similarities on that f32 view."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    n = N if where == "canonical" else N // 4
    q, mem = _topk_inputs(case, n + 1, seed=n)
    mem_t, mem_j, scale_t, scale_j = _rows(mem, dtype)
    vals, idx = ops.topk_read(torch.tensor(q), mem_t, K, valid_n=n,
                              mem_scale=scale_t)
    _, _, j_idx = jref.fused_read_ref(jnp.asarray(q), mem_j,
                                      jnp.ones((B, H)), K, valid_n=n,
                                      mem_scale=scale_j)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    words = ref.gather_words(mem_t, idx, scale_t)
    sims = torch.einsum("bhw,bhkw->bhk", ref._normalize(torch.tensor(q)),
                        ref._normalize(words))
    _close(vals.numpy(), sims.numpy())
    if case == "zero":
        np.testing.assert_array_equal(
            idx.numpy(), np.broadcast_to(np.arange(K), (B, H, K)))
    if case == "dup":
        np.testing.assert_array_equal(
            idx.numpy(), np.broadcast_to([3, n // 2 - 1], (B, H, K)))


def test_bf16_rows_rank_as_the_single_device_read():
    """Where JAX disagrees with itself (ROADMAP.md §C): its single-device
    exact read ranks bf16 rows upcast to f32, while its `topk_read` (the
    Pallas kernel and `ref.topk_read_ref`), which its mesh route calls,
    normalises them in bf16. The port ranks a block's bf16 rows as the
    single-device read does, so a row scores the same on a block as in
    the whole memory: its selection equals `jref.fused_read_ref`'s on
    every draw, and JAX's `topk_read_ref` on the raw bf16 rows parts from
    it on some. Seeds 0-39 at the mesh tests' sizes; seed 4 is the first
    to part (batch row 0, head 0: rows (33, 20) at f32 similarities
    0.70850 and 0.70621, against (20, 33) in bf16)."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    parted = {}
    for seed in range(40):
        rng = np.random.default_rng(seed)
        mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
        q = rng.standard_normal((B, H, W)).astype(np.float32)
        mem_j = jnp.asarray(mem).astype(jnp.bfloat16)
        _, idx = ops.topk_read(torch.tensor(q), torch.tensor(mem).bfloat16(),
                               K, valid_n=N)
        _, _, f_idx = jref.fused_read_ref(jnp.asarray(q), mem_j,
                                          jnp.ones((B, H)), K, valid_n=N)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(f_idx))
        _, t_idx = jref.topk_read_ref(jnp.asarray(q), mem_j[:, :N], K)
        differ = np.argwhere(idx.numpy() != np.asarray(t_idx))
        if len(differ):
            parted[seed] = differ[0].tolist()
    print(f"JAX's topk_read_ref on raw bf16 rows parts from the single-"
          f"device read at seeds {sorted(parted)} (first (b, h, k): "
          f"{parted})")
    assert parted and min(parted) == 4 and parted[4] == [0, 0, 0]


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
    expect("sdnc", lambda: dnc.init_state(B, dnc.DNCConfig(
        cfg.memory, cfg.controller, sparse=True), device="cpu"))
    expect("streaming", lambda: training.train_task_streaming(
        training.ModelSpec("sam", cfg.memory, cfg.controller), "copy",
        mesh=ctx, device="cpu"))
    # Once refused, now run: a step that records its deltas, and one that
    # autograd records.
    state = sam.init_state(B, cfg, device="cpu")
    expect("training", lambda: sam.sam_step(params, cfg, state,
                                            torch.zeros((B, D)),
                                            collect_deltas=True))
    leaves = {g: {n: t.clone().requires_grad_() for n, t in grp.items()}
              for g, grp in params.items()}
    expect("autograd", lambda: sam.sam_step(leaves, cfg, state,
                                            torch.zeros((B, D))))
    return out


def _gathered(ctx, state) -> dict:
    """A state's slot leaves in the canonical layout (bf16 rows as f32,
    which holds them exactly) and its read, as numpy."""
    out = {"memory": mem_shard.gather_blocks(ctx, state.memory.detach()),
           "la": mem_shard.gather_blocks(ctx, state.last_access),
           "idx": state.read.indices, "words": state.read.words.detach()}
    if state.mem_scale is not None:
        out["scale"] = mem_shard.gather_blocks(ctx, state.mem_scale.detach())
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in out.items()}


def _train(ctx, params, xs, dtype, mode, chunk):
    """One gradient of (ys ** 2).sum() through `unroll.unroll` on this
    rank's block, the backward on another thread: ys, the final state,
    the gradients (the parameters' tree, as numpy), the bytes a step sent
    in the forward and in the backward, and, for the rollback modes,
    whether the backward gave the block back bit for bit and
    `roll_forward` the final state."""
    cell = SAMCell(_cfg(ctx.num_slots, dtype))
    leaves, spec = pytree.tree_flatten(params)
    leaves = [t.clone().requires_grad_() for t in leaves]
    state0 = cell.init_state(B, device="cpu")
    start = [b.clone() for b in (state0.memory, state0.mem_scale)
             if b is not None]
    ctx.collectives.reset()
    final, ys = unroll_lib.unroll(cell, pytree.tree_unflatten(leaves, spec),
                                  state0, xs, mode=mode, chunk=chunk)
    fwd = {k: v // T for k, v in ctx.collectives.bytes.items()}
    out = {"ys": ys.detach().numpy(), "state": _gathered(ctx, final)}
    ctx.collectives.reset()
    # On a thread of its own, where the caller's context is not set, as
    # autograd runs a backward on the card.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        grads = pool.submit(torch.autograd.grad, (ys ** 2).sum(),
                            leaves).result()
    bwd = {k: v // T for k, v in ctx.collectives.bytes.items()}
    out["bytes"] = (fwd, bwd)
    out["grads"] = pytree.tree_unflatten([g.numpy() for g in grads], spec)
    if mode != "naive":
        bufs = [b for b in (final.memory, final.mem_scale) if b is not None]
        out["restored"] = all(torch.equal(a, b) for a, b in zip(bufs, start))
        redone = _gathered(ctx, unroll_lib.roll_forward(final))
        out["rolled_forward"] = all(np.array_equal(redone[k], v) for k, v
                                    in out["state"].items())
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
        # Training on the block, and the bf16 and int8 forward.
        res["train"] = {case: _train(ctx, params, xs, *case)
                        for case in TRAIN_CASES}
        res["rows_fwd"] = {}
        for dtype in ("bfloat16", "int8"):
            final, ys = sam.sam_unroll(params, _cfg(N, dtype), sam.init_state(
                B, _cfg(N, dtype), device="cpu"), xs)
            res["rows_fwd"][dtype] = {"ys": ys.numpy(),
                                      "state": _gathered(ctx, final)}
    # The bytes each rank sends per step, at two memory sizes: the forward,
    # and a sparse train step's forward and backward on each row dtype.
    res["train_bytes"] = {}
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
            for dtype in ("float32", "bfloat16", "int8"):
                res["train_bytes"][dtype, n] = _train(
                    ctx, params, xs, dtype, "sparse", None)["bytes"]
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


@pytest.fixture(scope="module")
def jax_train(jax_runs):
    """JAX's single-device `unroll.unroll` of each training case under
    `jax.value_and_grad` of (ys ** 2).sum(), from the forward's weights:
    ys, the final state (bf16 rows as f32) and the gradients, as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.core import sam as jsam
    from repro.core import unroll as junroll
    from repro.core.cell import SAMCell as JCell
    from repro.core.types import ControllerConfig as JC
    from repro.core.types import MemoryConfig as JM
    params = jax_runs["ref"]["params"]
    xs = jnp.asarray(_xs())
    out = {}
    for dtype, mode, chunk in TRAIN_CASES:
        cell = JCell(jsam.SAMConfig(JM(num_slots=N, word_size=W, num_heads=H,
                                       k=K, mem_dtype=dtype),
                                    JC(D, HIDDEN, D)))

        def loss(p, s, cell=cell, mode=mode, chunk=chunk):
            st, ys = junroll.unroll(cell, p, s, xs, mode=mode, chunk=chunk)
            return (ys ** 2).sum(), (st, ys)

        (_, (st, ys)), g = jax.value_and_grad(loss, has_aux=True)(
            params, cell.init_state(B))
        state = {"memory": np.asarray(st.memory, dtype=np.float32
                                      if dtype == "bfloat16" else None),
                 "la": np.asarray(st.last_access),
                 "idx": np.asarray(st.read.indices),
                 "words": np.asarray(st.read.words)}
        if st.mem_scale is not None:
            state["scale"] = np.asarray(st.mem_scale)
        out[dtype, mode, chunk] = {"ys": np.asarray(ys), "state": state,
                                   "grads": jax.tree.map(np.asarray, g)}
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
    """What the mesh still refuses names ROADMAP.md A11 (the LSH read, the
    SDNC, streaming); a step that records its deltas, or that autograd
    records, runs on a block."""
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
    for case in ("lsh read", "sdnc", "streaming"):
        assert got[case][0] == "NotImplementedError", case
        assert "ROADMAP.md A11" in got[case][1], case
    for case in ("training", "autograd"):
        assert got[case] == (None, ""), case

def _state_close(got: dict, want: dict) -> None:
    """The logical rows of the slot leaves (scratch rows are filled afresh
    by the gather) and the read: codes, usage and indices exact, int8
    scales within rtol 1e-6, floats within 1e-5."""
    for key, w in want.items():
        g = got[key]
        if key in ("memory", "la", "scale"):
            g, w = g[:, :N], w[:, :N]
        if key == "scale":
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0)
        elif np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=key)


def _grad_gap(got, want) -> float:
    """The largest |got - want| over max(1, |want|), leaf by leaf."""
    return max(float((np.abs(got[g][n] - w) / np.maximum(1.0, np.abs(w)))
                     .max()) for g, grp in want.items()
               for n, w in grp.items())


@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
def test_mesh_train_matches_jax(mesh_run, jax_train, case):
    """A gradient of (ys ** 2).sum() through the unroll on each rank's
    block against JAX's single-device `unroll` under `value_and_grad`:
    ys and the final state as above; gradients within 1e-5 (atol and
    rtol), bf16 rows' within `BF16_GRAD_BAR` of max(1, |g|); the same on
    every rank, bit for bit."""
    _, runs = mesh_run
    want = jax_train[case]
    got = runs[0]["train"][case]
    np.testing.assert_allclose(got["ys"], want["ys"], atol=TOL, rtol=TOL)
    _state_close(got["state"], want["state"])
    if case[0] == "bfloat16":
        assert _grad_gap(got["grads"], want["grads"]) <= BF16_GRAD_BAR
    else:
        for g, grp in want["grads"].items():
            for n, w in grp.items():
                np.testing.assert_allclose(got["grads"][g][n], w, atol=TOL,
                                           rtol=TOL, err_msg=f"{g}.{n}")
    for run in runs[1:]:
        other = run["train"][case]
        np.testing.assert_array_equal(other["ys"], got["ys"])
        for g, grp in got["grads"].items():
            for n, v in grp.items():
                np.testing.assert_array_equal(other["grads"][g][n], v)


@pytest.mark.parametrize("case", [c for c in TRAIN_CASES if c[1] != "naive"],
                         ids=[i for c, i in zip(TRAIN_CASES, TRAIN_IDS)
                              if c[1] != "naive"])
def test_mesh_backward_restores_and_rolls_forward(mesh_run, case):
    """The sparse and chunked backwards leave each rank's block (and an
    int8 block's scales) as the forward found it, bit for bit, and
    `unroll.roll_forward` brings the final state back, bit for bit, on
    every rank."""
    _, runs = mesh_run
    for run in runs:
        assert run["train"][case]["restored"]
        assert run["train"][case]["rolled_forward"]


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_mesh_forward_on_bf16_and_int8_rows_matches_jax(mesh_run, jax_train,
                                                        dtype):
    """`sam_unroll` on bf16 and int8 blocks against the forward of JAX's
    single-device unroll: ys within 1e-5, the logical rows (int8 codes
    exact, scales within rtol 1e-6), usage and read indices exact; every
    rank alike."""
    _, runs = mesh_run
    want = jax_train[dtype, "sparse", None]
    got = runs[0]["rows_fwd"][dtype]
    np.testing.assert_allclose(got["ys"], want["ys"], atol=TOL, rtol=TOL)
    _state_close(got["state"], want["state"])
    for run in runs[1:]:
        for key, v in got["state"].items():
            np.testing.assert_array_equal(run["rows_fwd"][dtype]["state"][key],
                                          v)


def test_mesh_train_bytes_independent_of_n(mesh_run):
    """The bytes a rank sends per step of a sparse train step, forward and
    backward, on each row dtype, are the same at N = 64 and 256. The
    forward gathers the (B, H, K) top-K and (B, H) LRA scores and indices,
    and sums the K read rows and the J = H·(K+1) written rows it records;
    the backward sums the written rows' cotangents and the replay's K read
    rows (int8 rows: codes and f32 scales; their cotangent is the
    scales')."""
    _, runs = mesh_run
    J = H * (K + 1)
    for dtype, size, ct in (("float32", 4, 4 * W), ("bfloat16", 2, 2 * W),
                            ("int8", 1, 4)):
        row = W * size + (4 if dtype == "int8" else 0)
        want = ({"all_gather": 4 * (2 * B * H * K + 2 * B * H),
                 "psum": B * (H * K + J) * row},
                {"all_gather": 0, "psum": B * J * ct + B * H * K * row})
        for run in runs:
            small = run["train_bytes"][dtype, N]
            assert small == run["train_bytes"][dtype, N_BIG], dtype
            assert small == want, dtype
