"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: run with ``python -m pytest -m cuda tests/test_torch_cuda.py``
on a machine with an NVIDIA GPU and nvcc. Whether a card is present is
decided inside the fixture, so every worker collects the same tests; on a
machine without one each test skips. Sizes are small and N is ragged
(not a multiple of any tile) so the masked tail runs.

Tolerances: integers (indices, usage, LSH bucket ids and index, DAM's
least-used row) exact;
floats within 1e-5 (the kernels sum in another order than the plain
versions, and the reads' similarity is computed as (x·q̂)·|x|⁻¹ rather
than x̂·q̂). Two exceptions, each counted: a bucket-id bit may differ
where the plain projection lies within 1e-6·|x|·|plane| of 0, and the
candidate read may swap selections whose plain similarities lie within
1e-6 of each other. The causal attention kernel: f32 within 2e-5 (the JAX
suite's bar) on unit normal inputs; bf16 outputs within one bf16 ulp of
the output's magnitude (both round the same f32 softmax, summed in
another order), at D in 16 ... 128, D = 120 and D = 256, with and
without a sliding window or a prefix (the prefix-LM's keys, seen by every
query); on scores as large as the LM's (q and k of std 12), where two f32
orders differ by 1e-3, no further from the f64 result than twice the
plain f32 version is.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import sam
from repro_torch.core.quant import quantize_rows
from repro_torch.core.types import (LA_SCRATCH, ControllerConfig,
                                    MemoryConfig)
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_read import fused_read_sweep
from repro_torch.kernels.fused_read_candidates import fused_read_candidates
from repro_torch.kernels.lsh_hash import (BLOCKS_PER_SM, STREAM_TILE,
                                          STREAM_WARPS, hash_plan, lsh_hash,
                                          streams)
from repro_torch.kernels.scatter_rows import scatter_rows
from repro_torch.kernels.sparse_write import sparse_write_update
from repro_torch.kernels.topk_read import topk_read
from repro_torch.kernels.usage_argmin import lra_topn, usage_argmin

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _read_inputs(rng, B, N, W, H, case):
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    q = rng.standard_normal((B, H, W)).astype(np.float32)
    if case == "zero":
        mem[:] = 0.0
    elif case == "dup":
        for r in (N // 3, N // 2, N - 1):
            mem[:, r] = mem[:, 7]
        q = mem[:, 7][:, None, :] + 0.01 * q
    beta = (1.0 + rng.random((B, H))).astype(np.float32)
    return q, mem, beta


# (B, N, valid_n, W, H, K): the memory has N + 1 rows. The first two are
# the original cases; then valid_n = K, one batch row and many, every H
# from 1 to 8, K of 1 and 8, W = 16 (int8's narrowest), 32 and 128 (the
# LM's), a ragged last chunk, a scratch row left out, and 2^18 + 1 rows.
SWEEP_SHAPES = [(3, 1000, 1000, 32, 4, 4), (3, 4097, 4097, 32, 4, 4),
                (1, 4, 4, 32, 4, 4), (8, 1000, 1000, 16, 1, 1),
                (4, 4097, 4097, 128, 3, 8), (8, 4097, 4097, 32, 8, 1),
                (1, 65536, 65536, 128, 8, 8), (4, 65536, 65536, 128, 4, 8),
                (8, 262145, 262145, 32, 4, 4), (4, 65536, 65536, 16, 3, 4)]
SWEEP_CASES = [pytest.param(shape, case, id=f"{case}-{'x'.join(map(str, shape))}")
               for shape in SWEEP_SHAPES for case in ("rand", "zero", "dup")
               if shape[1] > 8 or case != "dup"]


def _check_zero_case(idx, B, H, K):
    assert torch.equal(idx.cpu(), torch.arange(K, dtype=torch.int32)
                       .expand(B, H, K))


@pytest.mark.parametrize("shape,case", SWEEP_CASES)
def test_fused_read_kernel_matches_plain(dev, shape, case):
    B, N, valid_n, W, H, K = shape
    q, mem, beta = (torch.tensor(x, device=dev) for x in
                    _read_inputs(np.random.default_rng(N), B, N, W, H, case))
    read, w, idx = fused_read_sweep(q, mem, beta, k=K, valid_n=valid_n)
    r_read, r_w, r_idx = ref.fused_read_ref(q, mem, beta, K, valid_n=valid_n)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx)
    assert (read - r_read).abs().max().item() <= TOL
    assert (w - r_w).abs().max().item() <= TOL
    if case == "zero":
        _check_zero_case(idx, B, H, K)


TOPK_SHAPES = [(3, 1000, 1000, 32, 4, 4), (3, 4097, 4097, 32, 4, 4),
               (3, 4097, 1025, 32, 4, 4), (8, 262144, 262144, 32, 4, 4),
               (1, 65536, 65536, 128, 8, 8), (4, 4, 4, 16, 3, 4),
               (8, 1000, 1000, 32, 1, 1)]


@pytest.mark.parametrize("shape,case", [
    pytest.param(shape, case, id=f"{case}-{'x'.join(map(str, shape))}")
    for shape in TOPK_SHAPES for case in ("rand", "zero", "dup")
    if shape[1] > 8 or case != "dup"])
def test_topk_read_kernel_matches_plain_and_fused_read(dev, shape, case):
    """On a (B, N+1, W) buffer (a rank's block has this layout, with N its
    share of the rows) and with a valid_n far short of it: indices equal
    to the plain version's and to `fused_read_sweep`'s bit for bit, vals
    within 1e-5."""
    B, N, valid_n, W, H, K = shape
    q, mem, beta = (torch.tensor(x, device=dev) for x in
                    _read_inputs(np.random.default_rng(N + valid_n), B,
                                 N, W, H, case))
    vals, idx = topk_read(q, mem, k=K, valid_n=valid_n)
    r_vals, r_idx = ref.topk_read_ref(q, mem, K, valid_n=valid_n)
    f_idx = fused_read_sweep(q, mem, beta, k=K, valid_n=valid_n)[2]
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx)
    assert torch.equal(idx, f_idx)
    assert (vals - r_vals).abs().max().item() <= TOL
    assert int(idx.max()) < valid_n
    if case == "zero":
        _check_zero_case(idx, B, H, K)
    assert torch.equal(ops.topk_read(q, mem, K, valid_n=valid_n)[1], idx)


@pytest.mark.parametrize("shape,case", [
    pytest.param(shape, case, id=f"{case}-{'x'.join(map(str, shape))}")
    for shape in TOPK_SHAPES[:4] for case in ("rand", "zero", "dup")])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_topk_read_kernel_on_bf16_and_int8_rows(dev, shape, case, dtype):
    """bf16 rows, and int8 rows with their scales: indices equal to the
    plain version's (which ranks the upcast or dequantized rows) and to
    `fused_read_sweep`'s on the same storage, bit for bit, vals within
    1e-5, on a whole buffer and with a valid_n short of it."""
    B, N, valid_n, W, H, K = shape
    q, mem, beta = (torch.tensor(x, device=dev) for x in
                    _read_inputs(np.random.default_rng(N + valid_n), B,
                                 N, W, H, case))
    mem, scale = _storage(mem, dtype)
    vals, idx = topk_read(q, mem, k=K, valid_n=valid_n, mem_scale=scale)
    r_vals, r_idx = ref.topk_read_ref(q, mem, K, valid_n=valid_n,
                                      mem_scale=scale)
    f_idx = fused_read_sweep(q, mem, beta, k=K, valid_n=valid_n,
                             mem_scale=scale)[2]
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx)
    assert torch.equal(idx, f_idx)
    assert (vals - r_vals).abs().max().item() <= TOL
    if case == "zero":
        _check_zero_case(idx, B, H, K)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sweep_scores_do_not_depend_on_where_the_rows_lie(dev, dtype):
    """A row's score is a function of the row, q and the row dtype: the
    same rows swept alone and inside larger memories, at other offsets,
    with other B and valid_n (so other grid plans), give bit-identical
    `topk_read` scores (f32) and `fused_read_sweep` weights, and the same
    picks shifted by the offset. Each head's K best rows are planted near
    its query, so they win wherever they lie."""
    rng = np.random.default_rng(7)
    n, W, H, K = 5000, 32, 4, 4
    x = rng.standard_normal((n, W)).astype(np.float32)
    base = rng.standard_normal((H, W)).astype(np.float32)
    for h, at in enumerate((10, 1700, n - K, 3001)):
        x[at:at + K] = base[h] + 0.01 * rng.standard_normal((K, W))

    def sweep(mem_np, b, q_np, valid_n):
        mem, scale = _storage(torch.tensor(mem_np, device=dev), dtype) \
            if dtype != "float32" else (torch.tensor(mem_np, device=dev), None)
        q = torch.tensor(q_np, device=dev)
        bt = torch.full(q.shape[:2], 2.0, device=dev)
        _, w, idx = fused_read_sweep(q, mem, bt, k=K, valid_n=valid_n,
                                     mem_scale=scale)
        vals, t_idx = topk_read(q, mem, k=K, valid_n=valid_n,
                                mem_scale=scale)
        return {"w": w[b], "idx": idx[b], "vals": vals[b], "t_idx": t_idx[b]}

    alone = np.zeros((1, n + 1, W), np.float32)
    alone[0, :n] = x
    want = sweep(alone, 0, base[None], n)
    for off, B, extra in ((1, 3, 17), (777, 2, 60000), (4093, 4, 5)):
        mem = rng.standard_normal((B, off + n + extra, W)).astype(np.float32)
        mem[1, off:off + n] = x
        q = rng.standard_normal((B, H, W)).astype(np.float32)
        q[1] = base
        got = sweep(mem, 1, q, off + n + extra - 1)
        torch.cuda.synchronize()
        assert torch.equal(got["idx"] - off, want["idx"])
        assert torch.equal(got["w"], want["w"])
        assert torch.equal(got["t_idx"] - off, want["t_idx"])
        assert torch.equal(got["vals"], want["vals"])


def test_topk_read_kernel_raises_on_inputs_it_cannot_take(dev):
    q = torch.zeros((2, 4, 8), device=dev)
    mem = torch.zeros((2, 65, 8), device=dev)
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        topk_read(q, mem.to(torch.float16), k=2)
    with pytest.raises(ValueError, match="multiple of 8"):
        topk_read(torch.zeros((2, 4, 4), device=dev),
                  torch.zeros((2, 65, 4), device=dev, dtype=torch.bfloat16),
                  k=2)
    with pytest.raises(ValueError, match="mem_scale"):
        topk_read(torch.zeros((2, 4, 16), device=dev),
                  torch.zeros((2, 65, 16), device=dev, dtype=torch.int8), k=2)
    with pytest.raises(ValueError, match="take no mem_scale"):
        topk_read(q, mem, k=2, mem_scale=torch.ones((2, 65), device=dev))
    with pytest.raises(ValueError, match="valid_n"):
        topk_read(q, mem, k=4, valid_n=3)
    with pytest.raises(ValueError, match="CUDA"):
        topk_read(q.cpu(), mem.cpu(), k=2)
    with pytest.raises(ValueError, match="multiple of 4"):
        topk_read(torch.zeros((2, 4, 6), device=dev),
                  torch.zeros((2, 65, 6), device=dev), k=2)
    with pytest.raises(ValueError, match="pieces"):      # 1 KB rows
        topk_read(torch.zeros((2, 4, 256), device=dev),
                  torch.zeros((2, 65, 256), device=dev), k=2)
    with pytest.raises(ValueError, match="selection"):
        ops.topk_read(q.requires_grad_(), mem, 2)


@pytest.mark.parametrize("N", [1000, 4097])
@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("case", ["ties", "stagger"])
def test_lra_topn_kernel_matches_plain(dev, N, n, case):
    B = 3
    rng = np.random.default_rng(N + n)
    if case == "ties":
        la = rng.integers(-3, 3, (B, N + 1)).astype(np.int32)
    else:
        la = np.broadcast_to(-np.arange(N + 1, dtype=np.int32), (B, N + 1)).copy()
    la[:, N] = LA_SCRATCH
    la = torch.tensor(la, device=dev)
    got = lra_topn(la, n, valid_n=N)
    want = ref.lra_topn_ref(la[:, :N], n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _lra_table(rng, B, N, case):
    """(B, N + 1) int32 usage table for `lra_topn` and the valid_n to sweep:
    'step21' the -arange(N) stagger after 21 steps of SAM's writes (about
    400 rows a batch row stamped 1..21, most of them at the high end, where
    the LRA picks lie), 'ascending' values rising with the index, 'equal'
    one value everywhere (the answer is 0..n-1), 'extremes' random values
    with INT32_MIN and INT32_MAX at many places, 'valid' a smaller valid_n
    with the smallest values just past it."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    la = np.broadcast_to(-np.arange(N + 1, dtype=np.int64), (B, N + 1)).copy()
    vn = N
    if case == "step21":
        for step in range(1, 22):
            rows = np.concatenate([N - 1 - rng.integers(0, 4 * step, 12),
                                   rng.integers(0, N, 8)])
            la[:, rows] = step
    elif case == "ascending":
        la = -la
    elif case == "equal":
        la[:] = 7
    elif case == "extremes":
        la = rng.integers(lo, hi, (B, N + 1), endpoint=True)
        la[:, rng.integers(0, N, 24)] = lo
        la[:, rng.integers(0, N, 24)] = hi
    elif case == "valid":
        vn = N - 5
        la[:, vn:] = lo
    la[:, N] = LA_SCRATCH
    return la.astype(np.int32), vn


@pytest.mark.parametrize("B,N", [(3, 4097), (4, 65536), (8, 1 << 20)],
                         ids=["ragged", "lm", "smoke"])
@pytest.mark.parametrize("case", ["step21", "ascending", "equal", "extremes",
                                  "valid"])
def test_lra_topn_kernel_on_usage_tables(dev, B, N, case):
    """Every n of 1..8 bit for bit against the plain version, one launch a
    call; the (8, 2^20 + 1) table has the smoke's stride, whose rows start
    at every offset from a 16-byte boundary."""
    la, vn = _lra_table(np.random.default_rng(N), B, N, case)
    la = torch.tensor(la, device=dev)
    for n in range(1, 9):
        count = lra_topn.launches
        got = lra_topn(la, n, valid_n=vn)
        assert lra_topn.launches == count + 1
        want = ref.lra_topn_ref(la[:, :vn], n)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n, got, want)
        if case == "equal":
            assert got.tolist() == [list(range(n))] * B


def _write_inputs(rng, B, N, W, H, K):
    J = H * (K + 1)
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    la = rng.integers(-50, 50, (B, N + 1)).astype(np.int32)
    la[:, N] = LA_SCRATCH
    widx = rng.integers(0, N, (B, H, K + 1)).astype(np.int32)
    widx[:, 1, 0] = widx[:, 0, 2]          # duplicate across heads
    widx[:, 1, K] = widx[:, 0, 1]          # an LRA row that was also read
    lra = widx[:, :, K].copy()
    ww = rng.random((B, J)).astype(np.float32)
    ww[:, 3] = 0.001                       # below delta: no usage stamp
    a = rng.standard_normal((B, H, W)).astype(np.float32)
    return mem, la, widx.reshape(B, J), ww, a, lra


@pytest.mark.parametrize("N", [1000, 4097])
@pytest.mark.parametrize("per_lane", [False, True])
def test_sparse_write_kernel_matches_plain(dev, N, per_lane):
    B, W, H, K = 3, 32, 4, 4
    mem, la, widx, ww, a, lra = (torch.tensor(x, device=dev) for x in
                                 _write_inputs(np.random.default_rng(N),
                                               B, N, W, H, K))
    step = (torch.tensor([60, 7, 61], dtype=torch.int32, device=dev)
            if per_lane else torch.tensor(60, dtype=torch.int32, device=dev))
    scratch = mem[:, N].clone()
    m_ref, l_ref = mem.clone(), la.clone()
    ref.sparse_write_update_ref(m_ref, l_ref, widx, ww, a, lra, step, 0.005)
    m_out, l_out = sparse_write_update(mem, la, widx, ww, a, lra, step,
                                       delta=0.005)
    torch.cuda.synchronize()
    assert m_out.data_ptr() == mem.data_ptr()          # in place
    assert (mem - m_ref).abs().max().item() <= TOL
    assert torch.equal(la, l_ref)
    assert torch.equal(mem[:, N], scratch)
    assert la[:, N].eq(LA_SCRATCH).all()


WRITE_CASES = ["one-row", "lra-later", "at-delta", "scratch", "lm", "w30",
               "unaligned", "strided-step"]


def _write_case(rng, case, dtype):
    """Inputs of the write's edge cases, each with a per-lane step: every
    column on one row (erased: the row is also every head's LRA row); an
    LRA row that a later head's column also names; weights exactly at
    delta (no stamp); every column on the scratch row N with weight 0 (the
    sharded write's columns of other ranks); the LM's (B, J, W) =
    (4, 36, 128); the single-value pieces: W = 30, and a memory that
    starts one value past a 16-byte boundary; and a per-lane step read
    through a stride of 2."""
    B, N, W, H, K = (4, 4097, 128, 4, 8) if case == "lm" else \
        (3, 1000, 30 if case == "w30" else 32, 4, 4)
    mem, la, widx, ww, a, lra = _write_inputs(rng, B, N, W, H, K)
    mem[:, N] = 0.0
    J = H * (K + 1)
    if case == "one-row":
        widx[:] = 17
        lra[:] = 17
    elif case == "lra-later":
        widx = widx.reshape(B, H, K + 1)
        widx[:, 2, 0] = widx[:, 0, K]
        widx[:, 3, 1] = widx[:, 0, K]
        widx = widx.reshape(B, J)
    elif case == "at-delta":
        ww[:, ::2] = np.float32(0.005)
    elif case == "scratch":
        widx[:] = N
        lra[:] = N
        ww[:] = 0.0
    step = np.array([60, 7, 61, 3][:B], dtype=np.int32)
    mem, la, widx, ww, a, lra, step = (
        torch.tensor(x) for x in (mem, la, widx, ww, a, lra, step))
    if dtype == "bfloat16":
        mem = mem.to(torch.bfloat16)
    return mem, la, widx, ww, a, lra, step


def _unaligned(t):
    """A contiguous copy of t that starts one value past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("case", WRITE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_write_kernel_edge_cases_bit_for_bit(dev, case, dtype):
    """The f32/bf16 write's groups and stamps on their edge cases, rows and
    usage bit for bit against the plain version (the same adds in the same
    order), one launch each."""
    mem, la, widx, ww, a, lra, step = (
        x.to(dev) for x in _write_case(np.random.default_rng(len(case)),
                                        case, dtype))
    if case == "unaligned":
        mem = _unaligned(mem)
    if case == "strided-step":
        step = step.repeat_interleave(2)[::2]
        assert step.stride(0) == 2
    before_m, before_l = mem.clone(), la.clone()
    m_ref, l_ref = mem.clone(), la.clone()
    ref.sparse_write_update_ref(m_ref, l_ref, widx, ww, a, lra, step, 0.005)
    count = sparse_write_update.launches_by_dtype[dtype]
    sparse_write_update(mem, la, widx, ww, a, lra, step, delta=0.005)
    torch.cuda.synchronize()
    assert sparse_write_update.launches_by_dtype[dtype] == count + 1
    assert torch.equal(mem.view(torch.int16 if dtype == "bfloat16"
                                else torch.int32),
                       m_ref.view(torch.int16 if dtype == "bfloat16"
                                  else torch.int32))
    assert torch.equal(la, l_ref)
    if case == "scratch":
        assert torch.equal(mem, before_m) and torch.equal(la, before_l)
    if case == "at-delta":                 # rows only columns at delta name
        even = widx[:, ::2].cpu().numpy()
        odd = widx[:, 1::2].cpu().numpy()
        for b in range(widx.shape[0]):
            rows = sorted(set(even[b]) - set(odd[b]))
            assert rows and torch.equal(la[b, rows], before_l[b, rows])


def _scatter_inputs(rng, B, N, W, J, dups):
    mem = rng.standard_normal((B, N + 1, W)).astype(np.float32)
    if dups == "heavy":
        idx = rng.integers(0, 3, (B, J)).astype(np.int32)
    else:
        idx = rng.integers(0, N, (B, J)).astype(np.int32)
        idx[:, 7] = idx[:, 2]              # a row named three times
        idx[:, 9] = idx[:, 2]
        idx[:, J - 1] = N - 1              # the last logical row
    rows = rng.standard_normal((B, J, W)).astype(np.float32)
    return mem, idx, rows


@pytest.mark.parametrize("N", [1000, 4097])
@pytest.mark.parametrize("mode", ["add", "set"])
@pytest.mark.parametrize("dups", ["some", "heavy"])
def test_scatter_rows_kernel_matches_plain(dev, N, mode, dups):
    """Both modes bit for bit: the kernel's 'add' sums a row's columns in j
    order with separately rounded adds, as the plain version does."""
    B, W, J = 3, 32, 20
    mem, idx, rows = (torch.tensor(x, device=dev) for x in _scatter_inputs(
        np.random.default_rng(N), B, N, W, J, dups))
    want = ref.scatter_rows_ref(mem.clone(), idx, rows, mode)
    count = scatter_rows.launches
    out = scatter_rows(mem, idx, rows, mode=mode)
    torch.cuda.synchronize()
    assert out.data_ptr() == mem.data_ptr()            # in place
    assert scatter_rows.launches == count + 1
    assert torch.equal(mem, want)


@pytest.mark.parametrize("B,R,J,W,case", [
    (4, 65537, 36, 128, "some"),           # the LM's write: J = H·(K+1)
    (3, 1000, 70, 32, "cross"),            # groups across three warps
    (3, 1000, 36, 32, "heavy"),            # three rows, every column
    (3, 1000, 36, 30, "some"),             # W % 4 != 0: floats
    (3, 1000, 20, 32, "unaligned"),        # mem off a 16-byte boundary
    (2, 500, 40, 32, "outside"),           # indices -1 and R are skipped
])
@pytest.mark.parametrize("mode", ["add", "set"])
def test_scatter_rows_kernel_at_other_shapes(dev, B, R, J, W, case, mode):
    """Bit for bit against the plain version, one launch a call. Skipped
    columns are compared as if they were not there (the plain version
    raises on them)."""
    rng = np.random.default_rng(J + W)
    mem = rng.standard_normal((B, R, W)).astype(np.float32)
    rows = rng.standard_normal((B, J, W)).astype(np.float32)
    if case == "heavy":
        idx = rng.integers(0, 3, (B, J))
    elif case == "cross":
        idx = rng.integers(0, R, (B, J))
        idx[:, [5, 33, 40, 66]] = idx[:, [0]]      # warps 0, 1, 1, 2
        idx[:, [31, 32]] = idx[:, [64]]            # warps 0, 1 and 2
    else:
        idx = rng.integers(0, R, (B, J))
        idx[:, [7, J - 1]] = idx[:, [2]]
    keep = list(range(J))
    if case == "outside":
        idx[:, 3], idx[:, J - 4] = -1, R
        keep = [j for j in keep if j not in (3, J - 4)]
    idx = idx.astype(np.int32)
    want = ref.scatter_rows_ref(torch.tensor(mem), torch.tensor(idx[:, keep]),
                                torch.tensor(rows[:, keep]), mode)
    if case == "unaligned":
        flat = torch.empty(B * R * W + 1, device=dev)
        m = flat[1:].view(B, R, W)
        m.copy_(torch.tensor(mem))
        assert m.data_ptr() % 16 == 4
    else:
        m = torch.tensor(mem, device=dev)
    count = scatter_rows.launches
    out = scatter_rows(m, torch.tensor(idx, device=dev),
                       torch.tensor(rows, device=dev), mode=mode)
    torch.cuda.synchronize()
    assert out.data_ptr() == m.data_ptr()
    assert scatter_rows.launches == count + 1
    assert torch.equal(m.cpu(), want)


def test_scatter_rows_kernel_raises_on_inputs_it_cannot_take(dev):
    mem = torch.zeros((2, 65, 8), device=dev)
    idx = torch.zeros((2, 5), dtype=torch.int32, device=dev)
    rows = torch.zeros((2, 5, 8), device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        scatter_rows(mem.cpu(), idx.cpu(), rows.cpu(), mode="add")
    with pytest.raises(ValueError, match="int32"):
        scatter_rows(mem, idx.long(), rows, mode="add")
    with pytest.raises(ValueError, match="float32"):
        scatter_rows(mem, idx, rows.double(), mode="set")
    with pytest.raises(ValueError, match="rows must be"):
        scatter_rows(mem, idx, rows[:, :4], mode="set")
    with pytest.raises(ValueError, match="contiguous"):
        scatter_rows(mem.transpose(0, 1).contiguous().transpose(0, 1), idx,
                     rows, mode="add")
    with pytest.raises(ValueError, match="mode"):
        scatter_rows(mem, idx, rows, mode="max")
    with pytest.raises(ValueError, match="columns"):
        scatter_rows(mem, torch.zeros((2, 4097), dtype=torch.int32,
                                      device=dev),
                     torch.zeros((2, 4097, 8), device=dev), mode="set")


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("B,R,J,W,case", [
    (3, 1001, 20, 32, "some"),             # the smoke's widths
    (3, 1000, 36, 32, "heavy"),            # three rows, every column
    (4, 65537, 36, 128, "some"),           # the LM's write
    (3, 1000, 70, 32, "cross"),            # groups across three warps
    (3, 1000, 36, 30, "some"),             # W % 8 != 0: single values
    (3, 1000, 20, 32, "unaligned"),        # mem off a 16-byte boundary
    (2, 500, 40, 32, "outside"),           # indices -1 and R are skipped
])
@pytest.mark.parametrize("mode", ["add", "set"])
def test_scatter_rows_bf16_kernel_matches_plain(dev, B, R, J, W, case, mode):
    """bf16 rows, both modes bit for bit against `ref.scatter_rows_ref`:
    each column rounded to bf16 and added in j order, rounding after each
    add; one launch a call, counted under bf16."""
    rng = np.random.default_rng(J + W + 1)
    mem = torch.tensor(rng.standard_normal((B, R, W)), dtype=torch.bfloat16)
    rows = torch.tensor(3 * rng.standard_normal((B, J, W)),
                        dtype=torch.bfloat16)
    if case == "heavy":
        idx = rng.integers(0, 3, (B, J))
    elif case == "cross":
        idx = rng.integers(0, R, (B, J))
        idx[:, [5, 33, 40, 66]] = idx[:, [0]]
        idx[:, [31, 32]] = idx[:, [64]]
    else:
        idx = rng.integers(0, R - 1, (B, J))
        idx[:, [7, J - 1]] = idx[:, [2]]
    keep = list(range(J))
    if case == "outside":
        idx[:, 3], idx[:, J - 4] = -1, R
        keep = [j for j in keep if j not in (3, J - 4)]
    idx = idx.astype(np.int32)
    want = ref.scatter_rows_ref(mem.clone(), torch.tensor(idx[:, keep]),
                                rows[:, keep], mode)
    if case == "unaligned":
        flat = torch.empty(B * R * W + 1, dtype=torch.bfloat16, device=dev)
        m = flat[1:].view(B, R, W)
        m.copy_(mem)
        assert m.data_ptr() % 16 == 2
    else:
        m = mem.to(dev)
    count = scatter_rows.launches_by_dtype["bfloat16"]
    out = scatter_rows(m, torch.tensor(idx, device=dev), rows.to(dev),
                       mode=mode)
    torch.cuda.synchronize()
    assert out.data_ptr() == m.data_ptr()
    assert scatter_rows.launches_by_dtype["bfloat16"] == count + 1
    assert torch.equal(_bits(m.cpu()), _bits(want))


@pytest.mark.parametrize("B,R,J,W,case", [
    (3, 1001, 20, 32, "some"), (3, 1000, 36, 32, "heavy"),
    (4, 65537, 36, 128, "some"), (3, 1000, 70, 32, "cross"),
    (3, 1000, 20, 24, "some"),             # W % 16 != 0: single codes
    (3, 1000, 20, 32, "unaligned"), (2, 500, 40, 32, "outside")])
def test_scatter_rows_int8_restore_matches_plain(dev, B, R, J, W, case):
    """int8 rows: the 'set' of recorded (codes, scale) pairs, both bit for
    bit against `ref.scatter_rows_q_ref`, the last duplicate winning;
    untouched rows and scales keep their bits."""
    rng = np.random.default_rng(J + W + 2)
    mem, scale = quantize_rows(torch.tensor(
        rng.standard_normal((B, R, W)), dtype=torch.float32))
    rows, rows_scale = quantize_rows(torch.tensor(
        3 * rng.standard_normal((B, J, W)), dtype=torch.float32))
    if case == "heavy":
        idx = rng.integers(0, 3, (B, J))
    elif case == "cross":
        idx = rng.integers(0, R, (B, J))
        idx[:, [5, 33, 40, 66]] = idx[:, [0]]
        idx[:, [31, 32]] = idx[:, [64]]
    else:
        idx = rng.integers(0, R - 1, (B, J))
        idx[:, [7, J - 1]] = idx[:, [2]]
    keep = list(range(J))
    if case == "outside":
        idx[:, 3], idx[:, J - 4] = -1, R
        keep = [j for j in keep if j not in (3, J - 4)]
    idx = idx.astype(np.int32)
    want, want_s = ref.scatter_rows_q_ref(
        mem.clone(), scale.clone(), torch.tensor(idx[:, keep]),
        rows[:, keep], rows_scale[:, keep], "set")
    if case == "unaligned":
        flat = torch.empty(B * R * W + 1, dtype=torch.int8, device=dev)
        m = flat[1:].view(B, R, W)
        m.copy_(mem)
    else:
        m = mem.to(dev)
    s = scale.to(dev)
    count = scatter_rows.launches_by_dtype["int8"]
    out = scatter_rows(m, torch.tensor(idx, device=dev), rows.to(dev),
                       mode="set", mem_scale=s, rows_scale=rows_scale.to(dev))
    torch.cuda.synchronize()
    assert out.data_ptr() == m.data_ptr()
    assert scatter_rows.launches_by_dtype["int8"] == count + 1
    assert torch.equal(m.cpu(), want) and torch.equal(s.cpu(), want_s)


def test_scatter_rows_new_instantiations_refuse_what_they_cannot_take(dev):
    mem = torch.zeros((2, 65, 16), dtype=torch.int8, device=dev)
    scale = torch.zeros((2, 65), device=dev)
    idx = torch.zeros((2, 5), dtype=torch.int32, device=dev)
    rows = torch.zeros((2, 5, 16), dtype=torch.int8, device=dev)
    rows_scale = torch.zeros((2, 5), device=dev)
    with pytest.raises(NotImplementedError, match="A9c"):
        scatter_rows(mem, idx, rows, mode="add", mem_scale=scale,
                     rows_scale=rows_scale)
    with pytest.raises(ValueError, match="rows_scale"):
        scatter_rows(mem, idx, rows, mode="set", mem_scale=scale)
    with pytest.raises(ValueError, match="int8"):
        scatter_rows(mem, idx, rows.float(), mode="set", mem_scale=scale,
                     rows_scale=rows_scale)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        scatter_rows(mem, idx, rows, mode="set")
    with pytest.raises(ValueError, match="bfloat16"):
        scatter_rows(mem.bfloat16(), idx, rows.float(), mode="add")
    # On the card ops route an int8 'add' to the kernel, which raises.
    with pytest.raises(NotImplementedError, match="A9c"):
        ops.scatter_rows(mem, idx, rows.float(), "add", mem_scale=scale)


@pytest.mark.parametrize("mode", ["add", "set"])
def test_scatter_rows_on_a_scale_cotangent_view(dev, mode):
    """The int8 scales' cotangent takes the f32 kernel at W = 1 on a
    (B, N+1, 1) view of the (B, N+1) buffer: bit for bit, in place."""
    rng = np.random.default_rng(7)
    ct = torch.tensor(rng.standard_normal((8, 4097)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, 4096, (8, 36)), dtype=torch.int32)
    idx[:, 9] = idx[:, 2]
    rows = torch.tensor(rng.standard_normal((8, 36, 1)), dtype=torch.float32)
    want = ref.scatter_rows_ref(ct.clone()[..., None], idx, rows, mode)
    c = ct.to(dev)
    scatter_rows(c[..., None], idx.to(dev), rows.to(dev), mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(c.cpu(), want[..., 0])


@pytest.mark.parametrize("kind", ["sam", "sam_ann"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_dtype_train_step_on_card_matches_cpu(dev, dtype, kind):
    """A sparse training step on bf16 and int8 rows, kernels on the card
    against the plain versions on the CPU: the loss within 1e-5 relative,
    gradients within 2e-5 of max(1, |g|) (int8: the JAX suite's bar) or
    2e-2 (bf16: a drift-flipped bf16 rounding moves a gradient by up to
    an ulp of the memory's cotangent). Launches a step: the forward's
    read, LRA and write T times; the backward's scatters (bf16: 6T on
    bf16 rows; int8: 2T restores and 2T on the f32 scales' cotangent)
    and, for int8, T replayed writes."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import training
    from repro_torch.data.tasks import copy_task
    spec = training.ModelSpec(
        kind, MemoryConfig(num_slots=1000, word_size=32, num_heads=4, k=4,
                           mem_dtype=dtype),
        ControllerConfig(input_size=10, hidden_size=32, output_size=8))
    batch = copy_task(2, 5, 5, 8, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    T = batch[0].shape[1]
    out = {}
    for device in ("cpu", dev):
        init_p, init_s, unroll = training.build_model(spec, device=device)
        leaves, treedef = pytree.tree_flatten(
            init_p(torch.Generator().manual_seed(0)))
        leaves = [p.requires_grad_() for p in leaves]
        inputs, targets, mask = (t.to(device) for t in batch)
        n0 = dict(scatter_rows.launches_by_dtype)
        w0 = sparse_write_update.launches
        _, ys = unroll(pytree.tree_unflatten(leaves, treedef), init_s(2),
                       inputs.transpose(0, 1))
        loss = training.bits_loss(ys, targets.transpose(0, 1),
                                  mask.transpose(0, 1))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[str(device)[:4]] = (
            loss.item(), [torch.zeros_like(x).cpu() if g is None else g.cpu()
                          for x, g in zip(leaves, grads)],
            {k: v - n0[k] for k, v in scatter_rows.launches_by_dtype.items()},
            sparse_write_update.launches - w0)
    (l_cpu, g_cpu, _, _), (l_gpu, g_gpu, scat, writes) = out["cpu"], \
        out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    bar = 2e-2 if dtype == "bfloat16" else 2e-5
    for a, b in zip(g_gpu, g_cpu):
        assert ((a - b).abs() / b.abs().clamp_min(1.0)).max() <= bar
    if dtype == "bfloat16":
        assert scat == {"float32": 0, "bfloat16": 6 * T, "int8": 0}
        assert writes == T
    else:
        assert scat == {"float32": 2 * T, "bfloat16": 0, "int8": 2 * T}
        assert writes == 2 * T


def test_sparse_train_step_on_card_matches_cpu(dev):
    """One sparse-mode training step, kernels on the card against the plain
    versions on the CPU: loss within 1e-5 relative; gradients and updated
    weights within atol 1e-5 / rtol 1e-5, the bar of `test_torch_train.py`
    (cuBLAS and the CPU sum the controller's products in other orders, and
    T recurrent steps carry the difference, to about 1e-8 at this size).
    The backward launches no sweep: the forward's T launches of each O(N)
    kernel are all there are."""
    _train_step_on_card_matches_cpu(dev, "sam")


def test_sam_ann_train_step_on_card_matches_cpu(dev):
    """The same for the LSH cell: the forward launches the hash 2T times
    and the candidate read, the LRA and the write T times each, the
    backward none of them; the planes do not move."""
    _train_step_on_card_matches_cpu(dev, "sam_ann")


def _train_step_on_card_matches_cpu(dev, kind):
    from torch.utils import _pytree as pytree

    from repro_torch.core import training
    from repro_torch.data.tasks import copy_task
    from repro_torch.optim import optimizers as opt
    spec = training.ModelSpec(
        kind, MemoryConfig(num_slots=1000, word_size=32, num_heads=4, k=4),
        ControllerConfig(input_size=10, hidden_size=32, output_size=8))
    read = fused_read_candidates if kind == "sam_ann" else fused_read_sweep
    kernels = (read, lra_topn, sparse_write_update, scatter_rows, lsh_hash)
    batch = copy_task(2, 5, 5, 8, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    T = batch[0].shape[1]
    out = {}
    for device in ("cpu", dev):
        init_p, init_s, unroll = training.build_model(spec, device=device)
        params = init_p(torch.Generator().manual_seed(0))
        inputs, targets, mask = (t.to(device) for t in batch)
        leaves, treedef = pytree.tree_flatten(params)
        leaves = [p.clone().requires_grad_() for p in leaves]
        counts = [k.launches for k in kernels]
        _, ys = unroll(pytree.tree_unflatten(leaves, treedef),
                       init_s(2), inputs.transpose(0, 1))
        loss = training.bits_loss(ys, targets.transpose(0, 1),
                                  mask.transpose(0, 1))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        launched = [k.launches - c for k, c in zip(kernels, counts)]
        _, _, step = training.make_task_train_step(spec, 1e-3, device=device)
        new_params, _, step_loss, _ = step(params, opt.rmsprop_init(params),
                                           inputs, targets, mask)
        if kind == "sam_ann":               # fixed planes: not moved
            assert torch.equal(new_params["lsh_planes"], params["lsh_planes"])
        out[device if device == "cpu" else "cuda"] = (
            loss.item(), [g.cpu() for g in grads],
            [p.cpu() for p in pytree.tree_leaves(new_params)],
            step_loss.item(), launched)
    (l_cpu, g_cpu, p_cpu, s_cpu, _), (l_gpu, g_gpu, p_gpu, s_gpu, launched) = \
        out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(s_gpu - s_cpu) <= 1e-5 * abs(s_cpu)
    for a, b in [*zip(g_gpu, g_cpu), *zip(p_gpu, p_cpu)]:
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert launched[:3] == [T, T, T]
    assert launched[3] >= T
    assert launched[4] == (2 * T if kind == "sam_ann" else 0)


def test_kernels_raise_on_inputs_they_cannot_take(dev):
    la = torch.zeros((2, 65), device=dev)
    with pytest.raises(ValueError, match="int32"):
        ops.lra_topn(la, 2, valid_n=64)            # float usage table
    q = torch.zeros((2, 8, 4), device=dev).transpose(1, 2)
    mem = torch.zeros((2, 65, 4), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_read(q, mem, torch.ones((2, 4), device=dev), 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.fused_read(torch.zeros((2, 4, 6), device=dev),
                       torch.zeros((2, 65, 6), device=dev),
                       torch.ones((2, 4), device=dev), 2)
    with pytest.raises(ValueError, match="CUDA"):
        fused_read_sweep(q.cpu().contiguous(), mem.cpu(),
                         torch.ones((2, 4)), k=2)


def test_sam_unroll_on_card_matches_cpu(dev):
    cfg = sam.SAMConfig(MemoryConfig(num_slots=1000, word_size=16,
                                     num_heads=2, k=4),
                        ControllerConfig(input_size=6, hidden_size=16,
                                         output_size=4))
    params = sam.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    xs = torch.tensor(np.random.default_rng(0).integers(0, 2, (8, 2, 6)),
                      dtype=torch.float32)
    s_cpu = sam.init_state(2, cfg, device="cpu")
    s_gpu = sam.init_state(2, cfg, device=dev)
    p_gpu = {g: {n: v.to(dev) for n, v in t.items()} for g, t in params.items()}
    counts = (fused_read_sweep.launches, sparse_write_update.launches,
              lra_topn.launches)
    for x in xs:
        s_cpu, y_cpu = sam.sam_step(params, cfg, s_cpu, x)
        s_gpu, y_gpu = sam.sam_step(p_gpu, cfg, s_gpu, x.to(dev))
        assert torch.equal(s_gpu.read.indices.cpu(), s_cpu.read.indices)
        assert torch.equal(s_gpu.last_access.cpu(), s_cpu.last_access)
        assert (s_gpu.memory.cpu() - s_cpu.memory).abs().max() <= TOL
        assert (y_gpu.cpu() - y_cpu).abs().max() <= TOL
    assert (fused_read_sweep.launches, sparse_write_update.launches,
            lra_topn.launches) == tuple(c + len(xs) for c in counts)


# --------------------------------------------------------------------------
# The LSH read: the signature hash and the candidate read
# --------------------------------------------------------------------------

NEAR_ZERO = NEAR_TIE = 1e-6


def _hash_flips(x, planes, got, want):
    """(bits that differ, of which not near 0): a bit may differ only where
    the plain projection lies within 1e-6·|x|·|plane| of 0."""
    bits = planes.shape[1]
    proj = torch.einsum("rw,tbw->rtb", x, planes)
    shift = torch.arange(bits, device=x.device, dtype=torch.int32)
    diff = (((got ^ want)[..., None] >> shift) & 1).bool()
    near = proj.abs() <= NEAR_ZERO * (x.norm(dim=-1)[:, None, None]
                                      * planes.norm(dim=-1)[None])
    return int(diff.sum()), int((diff & ~near).sum())


def _hash_inputs(R, W, T, bits, seed):
    """Rows and planes from a seed: rows 0-2 zero (exactly 0, id 0), row 3
    tiny (projections near 0), row 4 orthogonal to the first plane up to
    rounding (that projection near 0)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((R, W), generator=gen)
    planes = torch.randn((T, bits, W), generator=gen)
    x[:3] = 0.0
    x[3:4] = 1e-30
    p0 = planes[0, 0]
    x[4:5] -= (x[4:5] @ p0)[:, None] / (p0 @ p0) * p0
    return x, planes


def _check_hash(x, planes):
    """One launch; every differing bit near 0; ids in [0, 2^bits)."""
    bits = planes.shape[1]
    count = lsh_hash.launches
    got = lsh_hash(x, planes)
    want = ref.lsh_hash_ref(x, planes)
    torch.cuda.synchronize()
    assert lsh_hash.launches == count + 1
    flips, far = _hash_flips(x, planes, got, want)
    assert far == 0, f"{far} of {flips} differing bits are not near 0"
    assert (got[:3] == 0).all() and (got >= 0).all()
    assert (got < 2 ** bits).all()


# (R, W, T, bits): the step's R = 32 and 160 and their neighbours, a
# single row, R = 4097 (513 one-warp tiles, the last of one row), W of
# 4 to 128, T·bits below (16), at (32) and above (64) one group of 32
# planes, bits = 30 (a table a group).
@pytest.mark.parametrize("R,W,T,bits", [
    (32, 32, 4, 8), (160, 32, 4, 8), (5000, 32, 4, 8), (333, 64, 2, 30),
    (7, 4, 1, 1), (1, 32, 4, 8), (31, 32, 4, 8), (33, 32, 4, 8),
    (4097, 32, 4, 8), (160, 4, 4, 8), (160, 64, 4, 8), (160, 128, 4, 8),
    (160, 32, 2, 8), (160, 32, 8, 8), (4097, 128, 8, 8), (160, 32, 1, 30),
    (33, 32, 3, 30)])
def test_lsh_hash_kernel_matches_plain(dev, R, W, T, bits):
    x, planes = _hash_inputs(R, W, T, bits, R)
    _check_hash(x.to(dev), planes.to(dev))


@pytest.mark.parametrize("W,T,bits", [(32, 4, 8), (4, 4, 8), (128, 8, 8),
                                      (32, 3, 30)])
def test_lsh_hash_kernel_streams_to_a_partial_tile(dev, W, T, bits):
    """The streamed plan (a rebuild's): each warp of the persistent blocks
    takes several tiles through its ring, and the last tile is partial."""
    sms = _build.sm_count(dev)
    R = 6 * STREAM_TILE * STREAM_WARPS * BLOCKS_PER_SM * sms + 37
    plan = hash_plan(streams(R, sms), W)
    tiles = -(-R // plan.tile)
    assert plan.streamed and R % plan.tile
    assert plan.blocks(R, sms) * plan.warps < tiles
    x, planes = _hash_inputs(R, W, T, bits, W + T)
    _check_hash(x.to(dev), planes.to(dev))


def test_lsh_hash_kernel_raises_on_inputs_it_cannot_take(dev):
    x = torch.zeros((8, 32), device=dev)
    planes = torch.zeros((4, 8, 32), device=dev)
    with pytest.raises(ValueError, match="bits"):
        lsh_hash(x, torch.zeros((1, 31, 32), device=dev))
    with pytest.raises(ValueError, match="multiple of 4"):
        lsh_hash(torch.zeros((8, 6), device=dev),
                 torch.zeros((4, 8, 6), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        lsh_hash(torch.zeros((32, 8), device=dev).t(), planes)
    with pytest.raises(ValueError, match="float32"):
        lsh_hash(x.double(), planes)
    with pytest.raises(ValueError, match="CUDA"):
        lsh_hash(x.cpu(), planes.cpu())


def _cand_inputs(rng, B, N, W, H, C, case):
    q, mem, beta = _read_inputs(rng, B, N, W, H, "rand")
    cand = rng.integers(0, N, (B, H, C)).astype(np.int32)
    if case == "cold":                     # fewer than K valid candidates
        cand[:] = -1
        cand[0, 0, [1, C - 1]] = [5, N - 1]
        cand[1, 2, C // 2] = 40
    elif case == "zero":                   # every similarity ties at 0
        mem[:] = 0.0
        cand[:, :, ::3] = -1
    elif case == "dup":                    # repeats, removed by dedup
        cand[:, :, C // 2:] = cand[:, :, :C - C // 2]
    return q, mem, beta, ref.dedup(torch.tensor(cand)).numpy()


def _cand_near_ties(q, mem, idx, r_idx, mem_scale=None):
    """Swapped selections, each allowed only at plain similarities within
    1e-6 of each other (an invalid one scores -1e9)."""
    diff = idx != r_idx
    if not diff.any():
        return 0

    def sims(ix):
        rows = ref.gather_words(mem, ix.clamp_min(0), mem_scale)
        s = torch.einsum("bhw,bhkw->bhk", ref._normalize(q),
                         ref._normalize(rows))
        return torch.where(ix < 0, -1e9, s)

    gap = (sims(idx) - sims(r_idx)).abs()[diff].max().item()
    assert gap <= NEAR_TIE, f"selections differ beyond a near-tie ({gap})"
    return int(diff.sum())


@pytest.mark.parametrize("C", [4, 148, 300])
@pytest.mark.parametrize("case", ["rand", "cold", "zero", "dup"])
def test_fused_read_candidates_kernel_matches_plain(dev, case, C):
    """C = K (the edge: every candidate is selected), the step's C = 148
    in one tile, and C = 300 in two tiles of at most 256 rows
    (`fused_read_candidates.cand_plan`), where the sum reads the K chosen
    rows from device memory again."""
    B, N, W, H, K = 3, 1000, 32, 4, 4
    q, mem, beta, cand = (torch.tensor(x, device=dev) for x in _cand_inputs(
        np.random.default_rng(C), B, N, W, H, C, case))
    count = fused_read_candidates.launches
    read, w, idx = fused_read_candidates(q, mem, beta, cand, k=K)
    r_read, r_w, r_idx = ref.fused_read_candidates_ref(q, mem, beta, K, cand)
    torch.cuda.synchronize()
    assert fused_read_candidates.launches == count + 1
    _cand_near_ties(q, mem, idx, r_idx)
    t_read, t_w = ref.sparse_read_tail(q, mem, beta, idx)
    assert (read - t_read).abs().max().item() <= TOL
    assert (w - t_w).abs().max().item() <= TOL
    assert (w[idx < 0] == 0).all()
    if case == "cold":
        assert sorted(idx[0, 0, :2].tolist()) == [5, N - 1]
        assert (idx[0, 0, 2:] == -1).all() and (idx[0, 1] == -1).all()
        assert (read[0, 1] == 0).all() and (w[0, 1] == 0).all()
    if case in ("zero", "cold") or C == K:
        assert torch.equal(idx, r_idx)     # exact ties: position order


@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case in ("none-valid", "k-valid", "copies")
    for dtype in ("float32", "bfloat16", "int8")] + [("zero-scale", "int8")])
def test_fused_read_candidates_kernel_edge_cases(dev, case, dtype):
    """No candidate valid (every selection -1, weight 0, read 0); exactly K
    valid (all of them selected); copies of one row at scattered positions
    scoring highest (exact ties, which must go by position); int8 rows of
    scale 0 (a zero row and codes under a zero scale) among the
    candidates."""
    B, N, W, H, K, C = 3, 1000, 32, 4, 4, 148
    rng = np.random.default_rng(7)
    q, mem, beta, cand = _cand_inputs(rng, B, N, W, H, C, "rand")
    distinct = np.stack([rng.choice(N, C, replace=False)
                         for _ in range(B * H)]).reshape(B, H, C)
    copies = np.arange(0, C, 7)
    if case == "none-valid":
        cand[:] = -1
    elif case == "k-valid":
        keep = rng.permuted(np.tile(np.arange(C) < K, (B, H, 1)), axis=-1)
        cand = np.where(keep, distinct, -1).astype(np.int32)
    elif case == "copies":                 # ids 0..C-1, rows 0, 7, 14, ...
        cand = rng.permuted(np.tile(np.arange(C, dtype=np.int32), (B, H, 1)),
                            axis=-1)
        mem[:, copies] = mem[:, :1]
        q[:] = mem[:, :1]
    mem_s, scale = (torch.tensor(mem, device=dev), None)
    if dtype != "float32":
        mem_s, scale = _storage(mem_s, dtype)
    if case == "zero-scale":
        ids = torch.tensor(cand[0, 0], device=dev).clamp_min(0)
        mem_s[:, ids[:20]] = 0                   # zero rows: scale 0
        scale[:, ids[:20]] = 0.0
        scale[:, ids[20:40]] = 0.0               # codes under a zero scale
    q, beta, cand = (torch.tensor(x, device=dev) for x in (q, beta, cand))
    read, w, idx = fused_read_candidates(q, mem_s, beta, cand, k=K,
                                         mem_scale=scale)
    r_idx = ref.candidate_topk(q, mem_s, K, cand, scale)
    torch.cuda.synchronize()
    t_read, t_w = ref.sparse_read_tail(q, mem_s, beta, idx, scale)
    assert (read - t_read).abs().max().item() <= TOL
    assert (w - t_w).abs().max().item() <= TOL
    assert (w[idx < 0] == 0).all()
    if case == "none-valid":
        assert idx.eq(-1).all() and w.eq(0).all() and read.eq(0).all()
    elif case == "k-valid":
        assert torch.equal(idx.sort(-1).values,
                           cand.sort(-1).values[..., -K:])
    elif case == "copies":
        is_copy = torch.isin(cand, torch.tensor(copies, device=dev))
        want = torch.stack([row[hit][:K] for row, hit in
                            zip(cand.reshape(-1, C), is_copy.reshape(-1, C))])
        assert torch.equal(idx, want.reshape(B, H, K))
    _cand_near_ties(q, mem_s, idx, r_idx, scale)


def test_fused_read_candidates_kernel_raises_on_inputs_it_cannot_take(dev):
    q = torch.zeros((2, 4, 32), device=dev)
    mem = torch.zeros((2, 65, 32), device=dev)
    beta = torch.ones((2, 4), device=dev)
    cand = torch.zeros((2, 4, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="C >= k"):
        fused_read_candidates(q, mem, beta, cand, k=4)
    with pytest.raises(ValueError, match="int32"):
        fused_read_candidates(q, mem, beta, cand.long(), k=2)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_read_candidates(torch.zeros((2, 4, 6), device=dev),
                              torch.zeros((2, 65, 6), device=dev), beta, cand,
                              k=2)
    with pytest.raises(ValueError, match="CUDA"):
        fused_read_candidates(q.cpu(), mem.cpu(), beta.cpu(), cand.cpu(), k=2)


def _lsh_cfg(N, H=2, W=16):
    return sam.SAMConfig(MemoryConfig(num_slots=N, word_size=W, num_heads=H,
                                      k=4, ann="lsh"),
                         ControllerConfig(input_size=6, hidden_size=16,
                                          output_size=4))


def test_lsh_sam_unroll_on_card_matches_cpu(dev):
    """Eight LSH steps from a cold index, the card against the CPU: read
    indices, usage table and the index exact, floats within 1e-5. Per step
    the card launches the hash twice, the candidate read, the LRA and the
    write once each, and the exact sweep never."""
    cfg = _lsh_cfg(1000)
    params = sam.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    xs = torch.tensor(np.random.default_rng(0).integers(0, 2, (8, 2, 6)),
                      dtype=torch.float32)
    s_cpu = sam.init_state(2, cfg, device="cpu")
    s_gpu = sam.init_state(2, cfg, device=dev)
    p_gpu = {g: ({n: v.to(dev) for n, v in t.items()}
                 if isinstance(t, dict) else t.to(dev))
             for g, t in params.items()}
    kernels = (lsh_hash, fused_read_candidates, lra_topn,
               sparse_write_update, fused_read_sweep)
    counts = [k.launches for k in kernels]
    for x in xs:
        s_cpu, y_cpu = sam.sam_step(params, cfg, s_cpu, x)
        s_gpu, y_gpu = sam.sam_step(p_gpu, cfg, s_gpu, x.to(dev))
        assert torch.equal(s_gpu.read.indices.cpu(), s_cpu.read.indices)
        assert torch.equal(s_gpu.last_access.cpu(), s_cpu.last_access)
        assert torch.equal(s_gpu.ann.buckets.cpu(), s_cpu.ann.buckets)
        assert torch.equal(s_gpu.ann.cursor.cpu(), s_cpu.ann.cursor)
        assert (s_gpu.memory.cpu() - s_cpu.memory).abs().max() <= TOL
        assert (y_gpu.cpu() - y_cpu).abs().max() <= TOL
    T = len(xs)
    assert [k.launches - c for k, c in zip(kernels, counts)] == \
        [2 * T, T, T, T, 0]


def test_lsh_ann_build_on_card_matches_cpu(dev):
    from repro_torch.core import ann
    cfg = _lsh_cfg(1000, W=32).memory
    gen = torch.Generator().manual_seed(3)
    planes = ann.lsh_planes(gen, cfg, device="cpu")
    mem = torch.randn((2, 1001, 32), generator=gen)
    mem[:, 100:200] = mem[:, 7:8]          # a bucket fuller than its ring
    got = ann.ann_build(planes.to(dev), mem.to(dev), cfg)
    want = ann.ann_build(planes, mem, cfg)
    assert torch.equal(got.buckets.cpu(), want.buckets)
    assert torch.equal(got.cursor.cpu(), want.cursor)


# --------------------------------------------------------------------------
# bf16 and int8 rows: the write, the int8 write and both reads
# --------------------------------------------------------------------------

def _storage(mem, dtype):
    """f32 rows -> (bf16 rows, None) or (int8 codes, scales)."""
    if dtype == "bfloat16":
        return mem.to(torch.bfloat16), None
    return quantize_rows(mem)


@pytest.mark.parametrize("shape,case", SWEEP_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_fused_read_kernel_dtypes_match_plain(dev, shape, case, dtype):
    B, N, valid_n, W, H, K = shape
    q, mem, beta = (torch.tensor(x, device=dev) for x in
                    _read_inputs(np.random.default_rng(N), B, N, W, H, case))
    mem, scale = _storage(mem, dtype)
    count = fused_read_sweep.launches_by_dtype[dtype]
    read, w, idx = fused_read_sweep(q, mem, beta, k=K, valid_n=valid_n,
                                    mem_scale=scale)
    r_read, r_w, r_idx = ref.fused_read_ref(q, mem, beta, K, valid_n=valid_n,
                                            mem_scale=scale)
    torch.cuda.synchronize()
    assert fused_read_sweep.launches_by_dtype[dtype] == count + 1
    assert torch.equal(idx, r_idx)
    assert (read - r_read).abs().max().item() <= TOL
    assert (w - r_w).abs().max().item() <= TOL
    if case == "zero":
        _check_zero_case(idx, B, H, K)
        assert read.eq(0).all()


@pytest.mark.parametrize("case", ["rand", "cold", "zero", "dup"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_fused_read_candidates_kernel_dtypes_match_plain(dev, case, dtype):
    B, N, W, H, K, C = 3, 1000, 32, 4, 4, 148
    q, mem, beta, cand = (torch.tensor(x, device=dev) for x in _cand_inputs(
        np.random.default_rng(C), B, N, W, H, C, case))
    mem, scale = _storage(mem, dtype)
    count = fused_read_candidates.launches_by_dtype[dtype]
    read, w, idx = fused_read_candidates(q, mem, beta, cand, k=K,
                                         mem_scale=scale)
    r_idx = ref.candidate_topk(q, mem, K, cand, scale)
    torch.cuda.synchronize()
    assert fused_read_candidates.launches_by_dtype[dtype] == count + 1
    _cand_near_ties(q, mem, idx, r_idx, scale)
    t_read, t_w = ref.sparse_read_tail(q, mem, beta, idx, scale)
    assert (read - t_read).abs().max().item() <= TOL
    assert (w - t_w).abs().max().item() <= TOL
    assert (w[idx < 0] == 0).all()
    if case in ("zero", "cold"):
        assert torch.equal(idx, r_idx)     # exact ties: position order


@pytest.mark.parametrize("N", [1000, 4097])
@pytest.mark.parametrize("case", ["rand", "zero", "heavy"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sparse_write_kernel_dtypes_match_plain(dev, N, case, dtype):
    """Bit for bit: rows (bf16 bits, int8 codes), scales and usage; a
    duplicate-heavy case (every column on rows 0-2, as on a zero memory,
    where all K reads of every head tie) and an all-zero memory."""
    B, W, H, K = 3, 32, 4, 4
    rng = np.random.default_rng(N + 1)
    mem, la, widx, ww, a, lra = _write_inputs(rng, B, N, W, H, K)
    if case == "zero":
        mem[:] = 0.0
    if case == "heavy":
        widx = rng.integers(0, 3, widx.shape).astype(np.int32)
        lra = widx.reshape(B, H, K + 1)[:, :, K].copy()
    mem, la, widx, ww, a, lra = (torch.tensor(x, device=dev) for x in
                                 (mem, la, widx, ww, a, lra))
    mem, scale = _storage(mem, dtype)
    step = torch.tensor([60, 7, 61], dtype=torch.int32, device=dev)
    m_ref, l_ref = mem.clone(), la.clone()
    s_ref = None if scale is None else scale.clone()
    scratch = mem[:, N].clone()
    count = sparse_write_update.launches_by_dtype[dtype]
    out = sparse_write_update(mem, la, widx, ww, a, lra, step, delta=0.005,
                              mem_scale=scale)
    torch.cuda.synchronize()
    assert sparse_write_update.launches_by_dtype[dtype] == count + 1
    if dtype == "int8":
        ref.sparse_write_update_q_ref(m_ref, s_ref, l_ref, widx, ww, a, lra,
                                      step, 0.005)
        assert out[2].data_ptr() == scale.data_ptr()
        assert torch.equal(scale, s_ref)
    else:
        ref.sparse_write_update_ref(m_ref, l_ref, widx, ww, a, lra, step,
                                    0.005)
    assert out[0].data_ptr() == mem.data_ptr()         # in place
    assert torch.equal(mem, m_ref) and torch.equal(la, l_ref)
    assert torch.equal(mem[:, N], scratch)


def _q_case(rng, W, H, K, case):
    """int8 inputs (B = 3, N = 4097) of the int8 write's cases, each with a
    per-lane step: 'rand'; 'cross-warp', one row named in columns 3 and 40
    (its group spans two warps of columns); 'all-erased', every column on
    one of the H LRA rows; 'zero-sum', batch row 0's first LRA row taking
    only weights of 0 (its sum is 0, so s' = 0); 'outside', columns on the
    scratch row N, on N + 3 and on -1, which the kernel ignores. Returns
    the inputs and the columns set outside."""
    B, N = 3, 4097
    mem, la, widx, ww, a, lra = _write_inputs(rng, B, N, W, H, K)
    mem[:, N] = 0.0
    outside = []
    if case == "cross-warp":
        widx[:, 40] = widx[:, 3]
    elif case == "all-erased":
        widx = lra[:, np.arange(H * (K + 1)) % H].copy()
    elif case == "zero-sum":
        ww[0, widx[0] == lra[0, 0]] = 0.0
    elif case == "outside":                # none of them an LRA column
        outside = [1, 6, 7, 11]
        widx[:, outside] = np.array([N, N + 3, -1, N], np.int32)
    step = np.array([60, 7, 61], dtype=np.int32)
    mem, la, widx, ww, a, lra, step = (
        torch.tensor(x) for x in (mem, la, widx, ww, a, lra, step))
    q, scale = quantize_rows(mem)
    return (q, la, widx, ww, a, lra, step, scale), outside


# (W, H, K): W of 16 (one 16-byte piece a row), 24 (not a multiple of 16:
# single codes), 32 and 128; J = H·(K+1) of 20, 36 and 592 (more pieces
# than a block has threads at W >= 32: rounds, each piece summed again);
# then J = 2000 columns, and H·W = 65536 floats of a, which do not fit in
# shared memory and are read from device memory.
Q_SHAPES = [(W, H, K) for W in (16, 24, 32, 128)
            for H, K in ((4, 4), (4, 8), (4, 147))] + [(16, 4, 499),
                                                       (8192, 8, 2)]


# (W, H, K, case): each case at step 21's shape, and again where it meets
# another path: a group across warps at J = 72 and 592, columns outside at
# W = 24, a zero sum in rounds, every owner erased at W = 16, single codes
# at J = 592.
Q_CASES = [(32, 4, 4, case) for case in ("rand", "all-erased", "zero-sum",
                                         "outside", "unaligned",
                                         "strided-step")] + [
    (32, 8, 8, "cross-warp"), (128, 4, 147, "cross-warp"),
    (24, 4, 8, "outside"), (128, 4, 147, "zero-sum"),
    (16, 4, 8, "all-erased"), (24, 4, 147, "unaligned")]


@pytest.mark.parametrize("W,H,K,case", Q_CASES)
def test_sparse_write_q_kernel_bit_for_bit(dev, W, H, K, case):
    """The int8 write on its shapes and edge cases, one launch each: codes,
    scales and usage bit for bit against the plain version, the scratch
    row untouched. 'outside' is held against the plain write with those
    columns on column 0's row at weight 0 (an FMA of 0 leaves a sum as it
    is, and a weight of 0 stamps nothing); 'unaligned' starts the memory
    one byte past a 16-byte boundary (single codes); 'strided-step' reads
    the per-lane step through a stride of 2."""
    (mem, la, widx, ww, a, lra, step, scale), outside = (
        _q_case(np.random.default_rng(W * K + len(case)), W, H, K, case))
    mem, la, widx, ww, a, lra, step, scale = (
        x.to(dev) for x in (mem, la, widx, ww, a, lra, step, scale))
    if case == "unaligned":
        mem = _unaligned(mem)
    if case == "strided-step":
        step = step.repeat_interleave(2)[::2]
        assert step.stride(0) == 2
    N = mem.shape[1] - 1
    r_idx, r_w = widx.clone(), ww.clone()
    r_idx[:, outside] = widx[:, :1]
    r_w[:, outside] = 0.0
    m_ref, s_ref, l_ref = mem.clone(), scale.clone(), la.clone()
    ref.sparse_write_update_q_ref(m_ref, s_ref, l_ref, r_idx, r_w, a, lra,
                                  step, 0.005)
    scratch = (mem[:, N].clone(), scale[:, N].clone(), la[:, N].clone())
    count = sparse_write_update.launches_by_dtype["int8"]
    sparse_write_update(mem, la, widx, ww, a, lra, step, delta=0.005,
                        mem_scale=scale)
    torch.cuda.synchronize()
    assert sparse_write_update.launches_by_dtype["int8"] == count + 1
    assert torch.equal(mem, m_ref)
    assert torch.equal(scale.view(torch.int32), s_ref.view(torch.int32))
    assert torch.equal(la, l_ref)
    assert all(torch.equal(x[:, N], y) for x, y in zip((mem, scale, la),
                                                       scratch))
    if case == "zero-sum":
        row = int(lra[0, 0])
        assert scale[0, row] == 0 and (mem[0, row] == 0).all()


@pytest.mark.parametrize("W,H,K", Q_SHAPES)
def test_sparse_write_q_kernel_at_every_shape(dev, W, H, K):
    """Every (W, J) of Q_SHAPES, aligned and not (16-byte pieces where W
    allows, single codes otherwise), bit for bit, one launch each."""
    (mem, la, widx, ww, a, lra, step, scale), _ = _q_case(
        np.random.default_rng(W + K), W, H, K, "rand")
    for aligned in (True, False):
        m, l, sc = (x.to(dev) for x in (mem, la, scale))
        if not aligned:
            m = _unaligned(m)
        args = [x.to(dev) for x in (widx, ww, a, lra, step)]
        m_ref, s_ref, l_ref = m.clone(), sc.clone(), l.clone()
        ref.sparse_write_update_q_ref(m_ref, s_ref, l_ref, *args, 0.005)
        count = sparse_write_update.launches_by_dtype["int8"]
        sparse_write_update(m, l, *args, delta=0.005, mem_scale=sc)
        torch.cuda.synchronize()
        assert sparse_write_update.launches_by_dtype["int8"] == count + 1
        assert torch.equal(m, m_ref) and torch.equal(l, l_ref)
        assert torch.equal(sc.view(torch.int32), s_ref.view(torch.int32))


def test_dtype_kernels_raise_on_inputs_they_cannot_take(dev):
    q = torch.zeros((2, 4, 8), device=dev)
    beta = torch.ones((2, 4), device=dev)
    mem8 = torch.zeros((2, 65, 8), dtype=torch.int8, device=dev)
    scale = torch.zeros((2, 65), device=dev)
    cand = torch.zeros((2, 4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_read_sweep(q, mem8, beta, k=2, mem_scale=scale)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_read_candidates(q, mem8, beta, cand, k=2, mem_scale=scale)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_read_sweep(torch.zeros((2, 4, 4), device=dev),
                         torch.zeros((2, 65, 4), dtype=torch.bfloat16,
                                     device=dev), beta, k=2)
    q16 = torch.zeros((2, 4, 16), device=dev)
    m16 = torch.zeros((2, 65, 16), dtype=torch.int8, device=dev)
    for bad in (None, scale[:, :64], scale.double()):
        with pytest.raises(ValueError, match="mem_scale"):
            fused_read_sweep(q16, m16, beta, k=2, mem_scale=bad)
    with pytest.raises(ValueError, match="no mem_scale"):
        fused_read_candidates(q16, m16.to(torch.bfloat16), beta, cand, k=2,
                              mem_scale=scale)
    la = torch.zeros((2, 65), device=dev)          # a float usage table
    J = 10
    widx = torch.zeros((2, J), dtype=torch.int32, device=dev)
    args = (widx, torch.ones((2, J), device=dev), q16[:, :2].contiguous(),
            widx[:, :2].contiguous(), 1)
    with pytest.raises(ValueError, match="last_access must be torch.int32"):
        sparse_write_update(m16, la, *args, delta=0.005, mem_scale=scale)
    with pytest.raises(ValueError, match="mem_scale must be"):
        sparse_write_update(m16, la.int(), *args, delta=0.005,
                            mem_scale=scale[:, :64].contiguous())
    with pytest.raises(ValueError, match="int8 rows"):
        sparse_write_update(m16, la.int(), *args, delta=0.005)


class _LockstepCPU:
    """Wraps `ops.fused_read` and `ops.sparse_write_update` so that every
    call on the card is repeated by the plain version on CPU copies of its
    inputs: the write bit for bit (rows, scales, usage), the read's indices
    up to near-ties within 1e-6 and its floats within 1e-5."""

    def __enter__(self):
        self.saved = read0, write0 = ops.fused_read, ops.sparse_write_update
        self.calls = 0

        def cpu(*xs):
            return [x.cpu() if isinstance(x, torch.Tensor) else x for x in xs]

        def fused_read(q, mem, beta, k, *, valid_n=None, cand_idx=None,
                       mem_scale=None):
            out = read0(q, mem, beta, k, valid_n=valid_n, cand_idx=cand_idx,
                        mem_scale=mem_scale)
            q_, m_, b_, c_, s_ = cpu(q, mem, beta, cand_idx, mem_scale)
            if cand_idx is None:
                want = ref.fused_read_ref(q_, m_, b_, k, valid_n=valid_n,
                                          mem_scale=s_)[2]
            else:
                want = ref.candidate_topk(q_, m_, k, c_, s_)
            idx = out[2].cpu()
            _cand_near_ties(q_, m_, idx, want, s_)
            t_read, t_w = ref.sparse_read_tail(q_, m_, b_, idx, s_)
            assert (out[0].cpu() - t_read).abs().max() <= TOL
            assert (out[1].cpu() - t_w).abs().max() <= TOL
            self.calls += 1
            return out

        def sparse_write_update(mem, la, widx, ww, a, lra, step, *, delta,
                                mem_scale=None):
            before = cpu(mem, la, widx, ww, a, lra, step, mem_scale)
            out = write0(mem, la, widx, ww, a, lra, step, delta=delta,
                         mem_scale=mem_scale)
            m_, l_, *rest, s_ = before
            if s_ is None:
                want = ref.sparse_write_update_ref(m_, l_, *rest, delta)
            else:
                want = ref.sparse_write_update_q_ref(m_, s_, l_, *rest, delta)
            assert all(torch.equal(g.cpu(), w) for g, w in zip(out, want))
            self.calls += 1
            return out

        ops.fused_read = fused_read
        ops.sparse_write_update = sparse_write_update
        return self

    def __exit__(self, *exc):
        ops.fused_read, ops.sparse_write_update = self.saved
        return False


@pytest.mark.parametrize("ann", ["exact", "lsh"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_dtype_sam_unroll_on_card_matches_cpu(dev, dtype, ann):
    """Eight steps of `SAM.forward` on bf16 or int8 rows on the card, in
    lockstep with the plain versions on the CPU (`_LockstepCPU`): every
    write bit for bit, every read as the kernel tests hold it. (A rollout
    on the CPU alone would not do: the controller's f32 sums differ from
    cuBLAS's in the last bits, and a stored bf16 row or int8 code carries
    such a difference across a rounding boundary now and then.) Launches:
    each step's kernels once, in the rows' dtype; the output is finite."""
    extra = {"ann": "lsh"} if ann == "lsh" else {}
    cfg = sam.SAMConfig(MemoryConfig(num_slots=1000, word_size=16,
                                     num_heads=2, k=4, mem_dtype=dtype,
                                     **extra),
                        ControllerConfig(input_size=6, hidden_size=16,
                                         output_size=4))
    model = sam.SAM(cfg, seed=0, device=dev)
    xs = torch.tensor(np.random.default_rng(0).integers(0, 2, (8, 2, 6)),
                      dtype=torch.float32, device=dev)
    read = fused_read_candidates if ann == "lsh" else fused_read_sweep
    def counts():
        return (read.launches, read.launches_by_dtype[dtype],
                sparse_write_update.launches,
                sparse_write_update.launches_by_dtype[dtype])

    before = counts()
    with _LockstepCPU() as lock:
        state, ys = model(model.init_state(2), xs)
    torch.cuda.synchronize()
    T = len(xs)
    assert lock.calls == 2 * T
    assert tuple(a - b for a, b in zip(counts(), before)) == (T, T, T, T)
    assert state.memory.dtype == getattr(torch, dtype)
    assert torch.isfinite(ys).all() and ys.shape == (T, 2, 4)
    assert state.memory[:, 1000].eq(0).all()
    if dtype == "int8":
        assert state.mem_scale[:, 1000].eq(0).all()
        assert state.mem_scale.gt(0).any()


# --------------------------------------------------------------------------
# DAM's least-used row (`usage_argmin`) and the dense models
# --------------------------------------------------------------------------

def _usage_table(rng, B, N, case):
    """(B, N) f32 usage, the ``valid_n`` to sweep and the index each row's
    minimum must have where the case fixes it (None where the plain version
    alone decides). Row b of a (B, N) table starts (b·N) mod 4 entries past
    a 16-byte boundary, so where N % 4 != 0 rows b > 0 start misaligned:
    the kernel reads their first (-b·N) mod 4 entries (the head) and the
    entries after their last whole float4 (the tail) as scalars."""
    u = (1.0 + rng.random((B, N))).astype(np.float32)
    lo, hi = min(3, N - 1), N - 1          # hi in another chunk past 8192
    if case == "ties":
        u[:] = 0.25
        return u, None, [0] * B
    if case == "tiles":
        u[:, [lo, hi]] = 0.5
        return u, None, [lo] * B
    if case == "zeros":                    # -0.0 equals +0.0: lo wins
        u[0::2, lo], u[0::2, hi] = -0.0, 0.0
        u[1::2, lo], u[1::2, hi] = 0.0, -0.0
        return u, None, [lo] * B
    if case == "head":                     # the head's last entry, tied
        heads = [(-b * N) % 4 for b in range(B)]   # later in the body
        want = [max(0, min(hd, N) - 1) for hd in heads]
        for b, i in enumerate(want):
            u[b, i] = u[b, min(i + 5, N - 1)] = 0.125
        return u, None, want
    if case == "tail":                     # the row's last entry
        u[:, N - 1] = 0.125
        return u, None, [N - 1] * B
    if case == "last":                     # the last entry before valid_n;
        vn = max(1, N - 1)                 # a smaller one past it, unseen
        u[:, vn - 1] = 0.125
        u[:, vn:] = 0.0
        return u, vn, [vn - 1] * B
    return u, None, None


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("N", [1, 1000, (1 << 20) - 1, (1 << 20) - 2,
                               (1 << 20) - 3])
@pytest.mark.parametrize("case", ["rand", "ties", "tiles", "zeros", "head",
                                  "tail", "last"])
def test_usage_argmin_kernel_matches_plain(dev, B, N, case):
    u, vn, want = _usage_table(np.random.default_rng(N + B), B, N, case)
    u = torch.tensor(u, device=dev)
    got = usage_argmin(u, valid_n=vn)
    plain = ref.usage_argmin_ref(u[:, :vn])
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert torch.equal(got, plain)
    if want is not None:
        assert got.tolist() == want
    if N > 1:                              # the rows past valid_n are unseen
        u[:, N - 1] = -1.0
        assert torch.equal(usage_argmin(u, valid_n=N - 1),
                           ref.usage_argmin_ref(u[:, :N - 1]))


def test_usage_argmin_kernel_raises_on_inputs_it_cannot_take(dev):
    u = torch.rand((2, 64), device=dev)
    for dtype in (torch.float64, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match="float32"):
            usage_argmin(u.to(dtype))
    with pytest.raises(ValueError, match="contiguous"):
        usage_argmin(torch.rand((64, 2), device=dev).t())
    with pytest.raises(ValueError, match="contiguous"):
        usage_argmin(u[:, ::2])
    with pytest.raises(ValueError, match="valid_n"):
        usage_argmin(u, valid_n=65)
    with pytest.raises(ValueError, match="CUDA"):
        usage_argmin(u.cpu())


@pytest.mark.parametrize("model", ["dam", "ntm"])
def test_dense_unroll_on_card_matches_cpu(dev, model):
    """Eight steps of `dense_step` on the card and on the CPU from the same
    state, each step from the CPU's state (teacher-forced), so that a
    near-tie of DAM's usage cannot carry a cuBLAS rounding into another
    row: indices equal, floats within 1e-5. DAM launches `usage_argmin`
    once a step, the NTM never."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import dense
    cfg = dense.DenseConfig(
        MemoryConfig(num_slots=1000, word_size=32, num_heads=4),
        ControllerConfig(input_size=10, hidden_size=32, output_size=8),
        model=model)
    params = dense.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    p_gpu = {g: {k: v.to(dev) for k, v in t.items()}
             for g, t in params.items()}
    xs = torch.tensor(np.random.default_rng(0).standard_normal((8, 2, 10)),
                      dtype=torch.float32)
    s_cpu = dense.init_state(2, cfg, device="cpu")
    before = usage_argmin.launches
    for x in xs:
        s_gpu = type(s_cpu)(*(t.to(dev) if isinstance(t, torch.Tensor)
                              else type(t)(*(u.to(dev) for u in t))
                              for t in s_cpu))
        if model == "dam":
            assert torch.equal(ops.usage_argmin(s_gpu.usage).cpu(),
                               ref.usage_argmin_ref(s_cpu.usage))
        s_gpu, y_gpu = dense.dense_step(p_gpu, cfg, s_gpu, x.to(dev))
        s_cpu, y_cpu = dense.dense_step(params, cfg, s_cpu, x)
        assert (y_gpu.cpu() - y_cpu).abs().max() <= TOL
        for a, b in zip(pytree.tree_leaves(s_gpu), pytree.tree_leaves(s_cpu)):
            assert (a.cpu().float() - b.float()).abs().max() <= TOL
    torch.cuda.synchronize()
    assert usage_argmin.launches - before == (2 * len(xs) if model == "dam"
                                              else 0)


def test_dam_train_step_on_card_matches_cpu(dev):
    """One DAM training step (N = 1000, T = 12) on the card against the
    CPU: loss within 1e-5 relative; gradients and updated weights within
    atol/rtol 1e-5 (cuBLAS and the CPU sum the controller's and the dense
    read's products in other orders). The forward launches `usage_argmin`
    T times, the backward never."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import training
    from repro_torch.data.tasks import copy_task
    from repro_torch.optim import optimizers as opt
    spec = training.ModelSpec(
        "dam", MemoryConfig(num_slots=1000, word_size=32, num_heads=4, k=4),
        ControllerConfig(input_size=10, hidden_size=32, output_size=8))
    batch = copy_task(2, 5, 5, 8, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    T = batch[0].shape[1]
    out = {}
    for device in ("cpu", dev):
        init_p, init_s, unroll = training.build_model(spec, device=device)
        params = init_p(torch.Generator().manual_seed(0))
        inputs, targets, mask = (t.to(device) for t in batch)
        leaves, treedef = pytree.tree_flatten(params)
        leaves = [p.clone().requires_grad_() for p in leaves]
        n0 = usage_argmin.launches
        _, ys = unroll(pytree.tree_unflatten(leaves, treedef), init_s(2),
                       inputs.transpose(0, 1))
        loss = training.bits_loss(ys, targets.transpose(0, 1),
                                  mask.transpose(0, 1))
        n1 = usage_argmin.launches
        grads = torch.autograd.grad(loss, leaves)
        launched = (n1 - n0, usage_argmin.launches - n1)
        _, _, step = training.make_task_train_step(spec, 1e-3, device=device)
        new_params, _, step_loss, _ = step(params, opt.rmsprop_init(params),
                                           inputs, targets, mask)
        out["cpu" if device == "cpu" else "cuda"] = (
            loss.item(), [g.cpu() for g in grads],
            [p.cpu() for p in pytree.tree_leaves(new_params)],
            step_loss.item(), launched)
    (l_cpu, g_cpu, p_cpu, s_cpu, cpu_launched), \
        (l_gpu, g_gpu, p_gpu, s_gpu, launched) = out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    assert abs(s_gpu - s_cpu) <= 1e-5 * abs(s_cpu)
    for a, b in [*zip(g_gpu, g_cpu), *zip(p_gpu, p_cpu)]:
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert launched == (T, 0) and cpu_launched == (0, 0)


# --------------------------------------------------------------------------
# The causal GQA attention kernel (csrc/flash_attention.cu)
# --------------------------------------------------------------------------

def _bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the magnitude max |x|."""
    _, e = torch.frexp(x.float().abs().max())
    return 2.0 ** (int(e) - 8)


def _attention_inputs(dev, B, S, H, Hkv, D, dtype, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g) * scale
    k = torch.randn((B, S, Hkv, D), generator=g) * scale
    v = torch.randn((B, S, Hkv, D), generator=g)
    return tuple(t.to(device=dev, dtype=getattr(torch, dtype))
                 for t in (q, k, v))


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 64, 2, 1, 16), (2, 128, 4, 2, 32), (1, 128, 8, 8, 16),   # JAX's
    (1, 130, 12, 1, 128),            # G = 12, S not a multiple of the tile
    (2, 1000, 4, 4, 64), (1, 1, 2, 1, 32),
    # Ragged S around the 64-row tile (cp.async's zero-fill, a ragged last
    # tile), and D in 16 ... 128 at G = 1 and G = 12.
    (1, 15, 12, 1, 32), (2, 63, 4, 4, 128), (1, 65, 12, 1, 16),
    (1, 65, 2, 2, 32), (1, 130, 24, 2, 64),
    (2, 2048, 48, 4, 128),           # StarCoder2-7B's heads at full length
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(dev, B, S, H, Hkv, D, dtype):
    q, k, v = _attention_inputs(dev, B, S, H, Hkv, D, dtype, seed=S + H)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= (2e-5 if dtype == "float32" else _bf16_ulp(want))
    # The dispatch takes any layout (a transposed view is copied first).
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(ops.flash_attention(qt, k, v), out)


# D = 120 (H2O-Danube3: the D = 128 tile with a zero tail) and the sliding
# window: a window under one tile, one not a multiple of the tile, one of
# whole tiles, one at least S (no key hidden), width 1 (a row sees only
# itself), and Danube's heads (32 over 8) at a window of 512.
WINDOW_CASES = [
    (1, 130, 4, 2, 120, None), (2, 63, 8, 2, 120, None),
    (2, 257, 8, 2, 120, 32), (1, 1000, 4, 1, 120, 100),
    (1, 1000, 4, 4, 64, 64), (2, 300, 4, 2, 32, 1), (1, 200, 2, 1, 128, 500),
    (1, 129, 12, 1, 16, 65), (1, 2048, 32, 8, 120, 512),
]


@pytest.mark.parametrize("B,S,H,Hkv,D,window", WINDOW_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_head_dim_120_and_window(dev, B, S, H, Hkv, D,
                                                        window, dtype):
    q, k, v = _attention_inputs(dev, B, S, H, Hkv, D, dtype, seed=S + D)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    want = ref.flash_attention_ref(q, k, v, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= (2e-5 if dtype == "float32" else _bf16_ulp(want))
    assert torch.equal(ops.flash_attention(q, k, v, window=window), out)
    if window is not None and window < S:   # the window hides keys
        assert (ref.flash_attention_ref(q, k, v) - want).abs().max() > 1e-3


@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_head_dim_120_on_large_scores(dev, window,
                                                             dtype):
    """The large-score bars of the next test at D = 120, with and without
    a window."""
    q, k, v = _attention_inputs(dev, 2, 512, 8, 2, 120, dtype, seed=6,
                                scale=12.0)
    out = flash_attention(q, k, v, window=window)
    if dtype == "bfloat16":
        want = ref.flash_attention_ref(q, k, v, window)
        err = (out.float() - want.float()).abs().max().item()
        assert err <= _bf16_ulp(want)
        return
    exact = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                    window)
    err = (out.double() - exact).abs().max().item()
    plain = (ref.flash_attention_ref(q, k, v, window).double()
             - exact).abs().max()
    assert err <= 2 * plain.item() + 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_on_large_scores(dev, dtype):
    """Scores of std ~144, as the LM's weights give them. f32: both f32
    versions are held against the f64 result. bf16: within one bf16 ulp
    of the plain version, the bar of the small inputs (p·v keeps p at f32
    precision as p_hi + p_lo)."""
    q, k, v = _attention_inputs(dev, 2, 512, 8, 2, 128, dtype, seed=5,
                                scale=12.0)
    out = flash_attention(q, k, v)
    if dtype == "bfloat16":
        want = ref.flash_attention_ref(q, k, v)
        err = (out.float() - want.float()).abs().max().item()
        assert err <= _bf16_ulp(want)
        return
    exact = ref.flash_attention_ref(q.double(), k.double(), v.double())
    err = (out.double() - exact).abs().max().item()
    plain = (ref.flash_attention_ref(q, k, v).double() - exact).abs().max()
    assert err <= 2 * plain.item() + 2e-5


# D = 256 (PaliGemma: 16 query heads, 8 of them its pad heads, over one kv
# head) and the prefix: none, under one tile, not a multiple of the tile,
# of whole tiles, equal to S, past S (every key seen: no key past S may be
# unmasked), with a window, at D = 120 and D = 32 too, and PaliGemma's
# prefill shapes (B = 4, S = 2048, prefix 256).
PREFIX_CASES = [
    (1, 64, 16, 1, 256, None, 0), (1, 130, 4, 2, 256, None, 0),
    (2, 63, 16, 1, 256, None, 16), (1, 257, 8, 1, 256, None, 40),
    (2, 300, 16, 1, 256, None, 256), (1, 200, 4, 2, 256, None, 200),
    (1, 100, 4, 2, 32, None, 500), (1, 65, 2, 1, 256, None, 1),
    (2, 500, 4, 2, 128, 64, 100), (1, 1000, 4, 1, 120, 100, 130),
    (1, 129, 12, 1, 16, 65, 70), (4, 2048, 16, 1, 256, None, 256),
]


@pytest.mark.parametrize("B,S,H,Hkv,D,window,prefix", PREFIX_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_head_dim_256_and_prefix(dev, B, S, H, Hkv, D,
                                                        window, prefix,
                                                        dtype):
    q, k, v = _attention_inputs(dev, B, S, H, Hkv, D, dtype,
                                seed=S + D + prefix)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v, window=window, prefix=prefix)
    want = ref.flash_attention_ref(q, k, v, window, prefix)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= (2e-5 if dtype == "float32" else _bf16_ulp(want))
    assert torch.equal(ops.flash_attention(q, k, v, window=window,
                                           prefix=prefix), out)
    if prefix > 1:                          # the prefix shows keys
        assert (ref.flash_attention_ref(q, k, v, window) - want).abs().max() \
            > 1e-3


@pytest.mark.parametrize("prefix", [0, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_head_dim_256_on_large_scores(dev, prefix,
                                                             dtype):
    """The large-score bars at D = 256 (16 query heads over one kv head),
    with and without a prefix."""
    q, k, v = _attention_inputs(dev, 2, 512, 16, 1, 256, dtype, seed=7,
                                scale=12.0)
    out = flash_attention(q, k, v, prefix=prefix)
    if dtype == "bfloat16":
        want = ref.flash_attention_ref(q, k, v, None, prefix)
        err = (out.float() - want.float()).abs().max().item()
        assert err <= _bf16_ulp(want)
        return
    exact = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                    None, prefix)
    err = (out.double() - exact).abs().max().item()
    plain = (ref.flash_attention_ref(q, k, v, None, prefix).double()
             - exact).abs().max()
    assert err <= 2 * plain.item() + 2e-5


# (192, 128): DeepSeek-V2 MLA's q·k (nope 128 + rope 64) and v widths, H =
# Hkv (MLA's k_rope is broadcast to every head), with GQA too, ragged S
# around the 64-row tile, and the full config's prefill heads (B = 4, S =
# 2048, 128 heads).
MLA_CASES = [
    (1, 64, 2, 2, 192, 128), (2, 130, 4, 4, 192, 128),
    (1, 63, 8, 2, 192, 128), (1, 1, 2, 1, 192, 128),
    (2, 1000, 4, 4, 192, 128), (4, 2048, 128, 128, 192, 128),
]


def _mla_inputs(dev, B, S, H, Hkv, D, DV, dtype, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=g) * scale
    k = torch.randn((B, S, Hkv, D), generator=g) * scale
    v = torch.randn((B, S, Hkv, DV), generator=g)
    return tuple(t.to(device=dev, dtype=getattr(torch, dtype))
                 for t in (q, k, v))


@pytest.mark.parametrize("B,S,H,Hkv,D,DV", MLA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_narrow_v(dev, B, S, H, Hkv, D, DV, dtype):
    q, k, v = _mla_inputs(dev, B, S, H, Hkv, D, DV, dtype, seed=S + H)
    n0 = flash_attention.launches
    out = flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == (B, S, H, DV)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= (2e-5 if dtype == "float32" else _bf16_ulp(want))
    assert torch.equal(ops.flash_attention(q, k, v), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_narrow_v_on_large_scores(dev, dtype):
    """The large-score bars at (192, 128), MLA's 128 heads over themselves
    cut to 8."""
    q, k, v = _mla_inputs(dev, 2, 512, 8, 8, 192, 128, dtype, seed=8,
                          scale=12.0)
    out = flash_attention(q, k, v)
    if dtype == "bfloat16":
        want = ref.flash_attention_ref(q, k, v)
        err = (out.float() - want.float()).abs().max().item()
        assert err <= _bf16_ulp(want)
        return
    exact = ref.flash_attention_ref(q.double(), k.double(), v.double())
    err = (out.double() - exact).abs().max().item()
    plain = (ref.flash_attention_ref(q, k, v).double() - exact).abs().max()
    assert err <= 2 * plain.item() + 2e-5


def test_flash_attention_kernel_refuses_unbuilt_pairs(dev):
    """Only (D, D) and (192, 128) are built: any other pair is refused by
    name before a launch, v wider than q·k too."""
    n0 = flash_attention.launches
    for D, DV in ((192, 192), (128, 64), (192, 64), (64, 128), (256, 128)):
        q, k, v = _mla_inputs(dev, 1, 64, 2, 2, D, DV, "bfloat16")
        with pytest.raises(ValueError, match=f"q·k {D}, v {DV}"):
            flash_attention(q, k, v)
    assert flash_attention.launches == n0


def test_flash_attention_kernel_raises_on_inputs_it_cannot_take(dev):
    q, k, v = _attention_inputs(dev, 1, 64, 4, 2, 32, "float32")
    bad = {
        "float16": (q.half(), k.half(), v.half()),
        "dtypes differ": (q, k.bfloat16(), v),
        "rank": (q[0], k[0], v[0]),
        "head ratio": (q[:, :, :3], k, v),
        "head dim": (q[..., :24].contiguous(), k[..., :24].contiguous(),
                     v[..., :24].contiguous()),
        "k shape": (q, k[:, :32], v),
        "layout": (q.transpose(1, 2).contiguous().transpose(1, 2), k, v),
        "cpu": (q.cpu(), k.cpu(), v.cpu()),
    }
    n0 = flash_attention.launches
    for case, args in bad.items():
        with pytest.raises(ValueError, match="flash_attention"):
            flash_attention(*args)
    for window in (0, -3, 2.5):
        with pytest.raises(ValueError, match="window"):
            flash_attention(q, k, v, window=window)
    for prefix in (-1, 2.5, None, True):
        with pytest.raises(ValueError, match="prefix"):
            flash_attention(q, k, v, prefix=prefix)
    assert flash_attention.launches == n0
    # Under autograd the op is the attention Function (LM training): its
    # forward launches the kernel once.
    out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.requires_grad and flash_attention.launches == n0 + 1


# --------------------------------------------------------------------------
# The serving engine and checkpoints on the card
# --------------------------------------------------------------------------

def test_engine_evict_restore_round_trip_on_card(dev, tmp_path):
    """The reduced `starcoder2_7b_sam` (bf16 compute) served on the card:
    user u (sampled) 8 tokens uninterrupted against 4 + 4 across two
    engines sharing a store of one hot session (u spills to disk between
    them) with other neighbours and lanes: tokens, the memory states, the
    cache, the position and the counter bit for bit, through the read,
    write and LRA kernels."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.engine import Request, ServeEngine, SessionStore
    from repro_torch.models import lm

    cfg = reduced(get_config("starcoder2_7b_sam"))
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)

    def u(**kw):
        return Request(user="u", greedy=False, sample_seed=42, **kw)

    def noise(n):
        return Request(user="noise", prompt=[9, 9], max_new_tokens=n,
                       greedy=False, sample_seed=7)

    def engine(store=None):
        return ServeEngine(cfg, lanes=3, max_len=64, params=params,
                           device=dev, session_store=store)

    n0 = fused_read_sweep.launches
    e1 = engine()
    full = {r["user"]: r["tokens"] for r in e1.run(
        [u(prompt=[3, 7, 11, 2], max_new_tokens=8), noise(6)])}
    want = e1.sessions.take("u")
    assert fused_read_sweep.launches > n0
    store = SessionStore(num_slots=cfg.memory.num_slots, capacity=1,
                         spill_dir=str(tmp_path))
    first = engine(store).run([u(prompt=[3, 7, 11, 2], max_new_tokens=4),
                               noise(8)])
    first = [r for r in first if r["user"] == "u"][0]["tokens"]
    assert store.spills == 1
    b = engine(store)
    b.submit(Request(user="other", prompt=[1, 2, 3], max_new_tokens=9,
                     greedy=False, sample_seed=5))
    rest = b.run([u(prompt=[first[-1]], max_new_tokens=4)])
    assert store.restores == 1
    assert first + [r for r in rest if r["user"] == "u"][0]["tokens"] == \
        full["u"]
    got = b.sessions.take("u")
    for key in ("k", "v"):
        assert torch.equal(got["cache"][key], want["cache"][key])
    assert torch.equal(got["pos"], want["pos"])
    assert int(got["counter"]) == int(want["counter"])
    for sg, sw in zip(got["mem"], want["mem"], strict=True):
        for name in sg._fields:
            assert torch.equal(getattr(sg, name), getattr(sw, name)), name


def test_checkpoint_round_trip_of_cuda_tensors(dev, tmp_path):
    """CUDA leaves of every dtype a session holds save and restore bit for
    bit, onto the card where the template leaf lies there."""
    from repro_torch.checkpoint import ckpt

    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"f32": torch.randn((3, 5), generator=g, device=dev),
            "bf16": torch.randn((4, 2), generator=g, device=dev).bfloat16(),
            "int8": torch.randint(-127, 128, (2, 6), generator=g,
                                  device=dev, dtype=torch.int8),
            "int32": torch.randint(0, 1 << 30, (7,), generator=g,
                                   device=dev, dtype=torch.int32),
            "host": torch.arange(3), "counter": 5}
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    got, step = ckpt.restore_checkpoint(str(tmp_path), tree)
    assert step == 1 and int(got["counter"]) == 5
    for key in ("f32", "bf16", "int8", "int32", "host"):
        assert got[key].device == tree[key].device
        assert got[key].dtype == tree[key].dtype
        assert torch.equal(got[key], tree[key]), key


# --------------------------------------------------------------------------
# LM training on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,Hkv,D,qb", [
    (1, 64, 2, 1, 16, 16), (2, 130, 12, 1, 128, 64),
    (1, 512, 48, 4, 128, 512), (2, 1000, 4, 4, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gradient_on_card_matches_plain(dev, B, S, H, Hkv, D,
                                                        qb, dtype):
    """The attention Function on the card (its forward the kernel, one
    launch; its backward plain, in blocks of ``qb`` query rows) against
    autograd through the plain version in f32: f32 within 2e-5 of
    max(1, |g|), bf16 within one bf16 ulp of the gradient's magnitude."""
    q, k, v = (t.requires_grad_() for t in _attention_inputs(
        dev, B, S, H, Hkv, D, dtype, seed=S + H))
    g = torch.randn(q.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(3)).to(q.dtype)
    n0 = flash_attention.launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v, q_block=qb),
                              (q, k, v), g)
    assert flash_attention.launches == n0 + 1
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*plain), plain,
                               g.float())
    for a, b in zip(got, want):
        assert a.dtype == q.dtype
        err = ((a.float() - b).abs() / b.abs().clamp_min(1.0)).max().item() \
            if dtype == "float32" else (a.float() - b).abs().max().item()
        assert err <= (2e-5 if dtype == "float32" else _bf16_ulp(b))


@pytest.mark.parametrize("B,S,H,Hkv,D,qb,window", [
    (1, 130, 4, 2, 120, 64, 32), (2, 512, 32, 8, 120, 128, 100),
    (1, 300, 4, 4, 64, 100, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_window_gradient_on_card_matches_plain(
        dev, B, S, H, Hkv, D, qb, window, dtype):
    """The same at D = 120 and with a window: the kernel's forward and the
    plain backward, whose query blocks take only the keys the window
    reaches, against autograd through the plain windowed version."""
    q, k, v = (t.requires_grad_() for t in _attention_inputs(
        dev, B, S, H, Hkv, D, dtype, seed=S + D))
    g = torch.randn(q.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(4)).to(q.dtype)
    n0 = flash_attention.launches
    got = torch.autograd.grad(
        ops.flash_attention(q, k, v, q_block=qb, window=window), (q, k, v), g)
    assert flash_attention.launches == n0 + 1
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*plain, window),
                               plain, g.float())
    for a, b in zip(got, want):
        assert a.dtype == q.dtype
        err = ((a.float() - b).abs() / b.abs().clamp_min(1.0)).max().item() \
            if dtype == "float32" else (a.float() - b).abs().max().item()
        assert err <= (2e-5 if dtype == "float32" else _bf16_ulp(b))


@pytest.mark.parametrize("B,S,H,Hkv,D,qb,window,prefix", [
    (1, 300, 16, 1, 256, 64, None, 40), (2, 130, 4, 2, 32, 64, None, 200),
    (1, 256, 8, 1, 256, 128, None, 256), (1, 200, 4, 2, 64, 100, 32, 50)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_prefix_gradient_on_card_matches_plain(
        dev, B, S, H, Hkv, D, qb, window, prefix, dtype):
    """The same at D = 256 and with a prefix: the kernel's forward and the
    plain backward, whose query blocks take the keys up to the prefix's
    end, against autograd through the plain version with the prefix."""
    q, k, v = (t.requires_grad_() for t in _attention_inputs(
        dev, B, S, H, Hkv, D, dtype, seed=S + D + prefix))
    g = torch.randn(q.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(5)).to(q.dtype)
    n0 = flash_attention.launches
    got = torch.autograd.grad(
        ops.flash_attention(q, k, v, q_block=qb, window=window,
                            prefix=prefix), (q, k, v), g)
    assert flash_attention.launches == n0 + 1
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*plain, window, prefix),
                               plain, g.float())
    for a, b in zip(got, want):
        assert a.dtype == q.dtype
        err = ((a.float() - b).abs() / b.abs().clamp_min(1.0)).max().item() \
            if dtype == "float32" else (a.float() - b).abs().max().item()
        assert err <= (2e-5 if dtype == "float32" else _bf16_ulp(b))


def _lm_train_case(dev):
    """The reduced `starcoder2_7b_sam` at f32 compute, weights from seed 0
    on the CPU, and a batch of `lm_token_batches`: the first pipeline seed
    of 0-31 whose reads, run on this machine's CPU, hold no near-tie at K
    (the card and the CPU then read the same rows; which seeds do depends
    on the host's float library). Returns (cfg, params, batch, the CPU's
    (loss, metrics, grads))."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.tokens import PipelineState, lm_token_batches
    from repro_torch.models import lm

    cfg = dataclasses.replace(reduced(get_config("starcoder2_7b_sam")),
                              compute_dtype="float32")
    params = lm.init_params(cfg, seed=0, device="cpu")
    for seed in range(32):
        b, _ = next(lm_token_batches(cfg.vocab_size, 2, 64,
                                     PipelineState(seed=seed)))
        batch = {k: torch.as_tensor(v) for k, v in b.items()}
        out, reads = _grads_and_reads(params, cfg, batch)
        if not _near_tie_at_k(reads):
            return cfg, params, batch, out
    pytest.fail("no pipeline seed of 0-31 reads without a near-tie at K")


def _grads_and_reads(params, cfg, batch):
    from repro_torch.launch import steps

    seen, fused_read = [], ops.fused_read

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        seen.append((q.detach().clone(), mem.detach().clone(), k, valid_n))
        return fused_read(q, mem, beta, k, valid_n=valid_n)

    ops.fused_read = record
    try:
        out = steps.value_and_grad(params, cfg, batch)
    finally:
        ops.fused_read = fused_read
    return out, seen


def _near_tie_at_k(reads, margin=1e-6) -> bool:
    for q, mem, k, valid_n in reads:
        sims = torch.einsum("bhw,bnw->bhn", ref._normalize(q.double()),
                            ref._normalize(mem[:, :valid_n].double()))
        v = sims.sort(dim=-1, descending=True).values[..., k - 1:k]
        band = (sims - v).abs() <= margin
        straddles = (sims > v + margin).sum(-1) + band.sum(-1) > k
        if (straddles & (band & (sims != v)).any(-1)).any():
            return True
    return False


def test_lm_train_step_on_card_matches_cpu(dev):
    """The reduced LM's loss and every gradient on the card (attention,
    read, write, LRA and scatter kernels) against the CPU: the loss within
    1e-5, gradients within the JAX suite's sparse-against-naive bar, atol
    2e-4 / rtol 1e-3 (the attention kernel sums in another f32 order on
    scores of std ~64, which the softmax carries into every gradient: up
    to 7e-5 apart, as the forward slice is held to 1e-4 of its scale in
    `tests/test_torch_lm.py`); then two
    `make_train_step` steps on each at the default schedule, the
    parameters within 1e-5 (AdamW's step divides a gradient element by its
    own size, so a faster rate would turn the drift of a gradient that
    cancels to near zero into a step: `tests/test_torch_lm_train.py`)."""
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import optimizers as opt

    cfg, p_cpu, batch, (l_cpu, _, g_cpu) = _lm_train_case(dev)
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    b_gpu = {k: v.to(dev) for k, v in batch.items()}
    n0 = (flash_attention.launches, scatter_rows.launches)
    l_gpu, _, g_gpu = steps.value_and_grad(p_gpu, cfg, b_gpu)
    assert flash_attention.launches > n0[0] and scatter_rows.launches > n0[1]
    assert abs(float(l_gpu) - float(l_cpu)) <= 1e-5 * max(1, abs(float(l_cpu)))
    for a, b in zip(tree_map(lambda t: t.cpu(), g_gpu).values(),
                    g_cpu.values()):
        for x, y in zip(torch.utils._pytree.tree_leaves(a),
                        torch.utils._pytree.tree_leaves(b)):
            torch.testing.assert_close(x, y, atol=2e-4, rtol=1e-3)
    step = steps.make_train_step(cfg)
    s_c, s_g = opt.adamw_init(p_cpu), opt.adamw_init(p_gpu)
    for _ in range(2):
        p_c, s_c, _ = step(p_cpu, s_c, batch)
        p_g, s_g, _ = step(p_gpu, s_g, b_gpu)
    for x, y in zip(torch.utils._pytree.tree_leaves(p_g),
                    torch.utils._pytree.tree_leaves(p_c)):
        torch.testing.assert_close(x.cpu(), y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_lm_sparse_against_chunked_on_card(dev, compute_dtype):
    """On the card, the reduced LM's gradients in the sparse and chunked
    (C = 1) unrolls within 1e-5 of max(1, |g|), the memory zero again
    after each backward."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.models import sam_layer
    from repro_torch.models.layers import tree_map

    cfg, p_cpu, batch, _ = _lm_train_case(dev)
    params = tree_map(lambda t: t.to(dev), p_cpu)
    batch = {k: v.to(dev) for k, v in batch.items()}
    made, init = [], sam_layer.init_memory_state

    def recorded(*a, **kw):
        made.append(init(*a, **kw))
        return made[-1]

    grads = {}
    sam_layer.init_memory_state = recorded
    try:
        for mode in ("sparse", "chunked"):
            c = dataclasses.replace(cfg, compute_dtype=compute_dtype,
                                    memory=dataclasses.replace(
                                        cfg.memory, unroll_mode=mode,
                                        unroll_chunk=1))
            _, _, grads[mode] = steps.value_and_grad(params, c, batch)
            assert torch.equal(made[-1].memory,
                               torch.zeros_like(made[-1].memory))
    finally:
        sam_layer.init_memory_state = init
    for x, y in zip(torch.utils._pytree.tree_leaves(grads["chunked"]),
                    torch.utils._pytree.tree_leaves(grads["sparse"])):
        assert ((x - y).abs() / y.abs().clamp_min(1.0)).max().item() <= 1e-5


# --------------------------------------------------------------------------
# The streaming trainer (core/training.py, unroll.roll_forward)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sparse", "chunked"])
def test_streaming_chunk_steps_on_card_match_cpu(dev, mode):
    """Two streaming chunk steps (N = 1000, a chunk of 12 from a carry
    with a written memory) on the card against the CPU: losses within
    1e-5 relative, the updated weights within atol/rtol 1e-5; after each,
    the carry's buffers (after `roll_forward`) equal a clone taken after
    the chunk's forward, bit for bit, and the redo launched one
    `scatter_rows` 'set' a step and nothing else."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import training, unroll
    from repro_torch.data.tasks import copy_task
    from repro_torch.optim import optimizers as opt
    spec = training.ModelSpec(
        "sam", MemoryConfig(num_slots=1000, word_size=32, num_heads=4, k=4),
        ControllerConfig(input_size=10, hidden_size=32, output_size=8),
        bptt_chunk=5 if mode == "chunked" else None)
    inputs, targets, mask = (t.transpose(0, 1) for t in copy_task(
        2, 11, 11, 8, generator=torch.Generator().manual_seed(0),
        device="cpu"))
    C = 12
    out = {}
    for device in ("cpu", dev):
        forward = unroll.unroll
        finals, redo = [], []

        def recording(cell, p, s, xs, **kw):
            state, ys = forward(cell, p, s, xs, **kw)
            finals.append([unroll._get(state, b).clone()
                           for b in cell.dense_buffers])
            return state, ys

        roll = unroll.roll_forward

        def counted(state):
            n0 = (scatter_rows.launches, sparse_write_update.launches,
                  lra_topn.launches, fused_read_sweep.launches)
            state = roll(state)
            redo.append(tuple(a.launches - b for a, b in zip(
                (scatter_rows, sparse_write_update, lra_topn,
                 fused_read_sweep), n0)))
            return state

        unroll.unroll, unroll.roll_forward = recording, counted
        try:
            init_p, init_s, step = training.make_streaming_train_step(
                spec, 1e-3, device=device)
            params = init_p(torch.Generator().manual_seed(0))
            opt_state, carry = opt.rmsprop_init(params), init_s(2)
            losses, carries = [], []
            for c in range(2):
                sl = slice(c * C, (c + 1) * C)
                params, opt_state, carry, loss, _ = step(
                    params, opt_state, carry, *(t[sl].to(device) for t in
                                                (inputs, targets, mask)))
                losses.append(loss.item())
                carries.append([unroll._get(carry, b).clone() for b in
                                ("memory", "last_access")])
        finally:
            unroll.unroll, unroll.roll_forward = forward, roll
        for got, want in zip(carries, finals):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        out[str(torch.device(device).type)] = (
            losses, [p.cpu() for p in pytree.tree_leaves(params)], redo)
    (l_cpu, p_cpu, r_cpu), (l_gpu, p_gpu, r_gpu) = out["cpu"], out["cuda"]
    for a, b in zip(l_gpu, l_cpu):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(p_gpu, p_cpu):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert r_cpu == [(0, 0, 0, 0)] * 2 and r_gpu == [(C, 0, 0, 0)] * 2
