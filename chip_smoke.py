#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the SAM cell — the copy task at the paper's widths (controller 100,
H = K = 4, W = 32, δ = 0.005, f32 rows) with N = 2^20 memory rows, B = 8
and T = 42 — through the four hand-written CUDA kernels, forward and in
training, and fails (nonzero exit) if any phase fails:

1. build the kernels from `src/repro_torch/kernels/csrc/` with nvcc for
   sm_90a and print each kernel's registers, shared memory and spills;
2. hold each kernel against its plain PyTorch version at full width, on
   the inputs of a real rollout: the all-zero first step and step 21 for
   the forward kernels; for `scatter_rows`, the inputs of a real backward:
   the rollback of step 21 ('set', which must also give back the memory
   before step 21's write bit for bit), the read-cotangent add ('add') and
   a case heavy in duplicates (both modes);
3. run the forward path (`SAM.forward` = `sam_unroll`) in lockstep — at
   every step the plain versions run on the inputs the kernels got and the
   outputs are compared, the rollout going on with the kernels' results —
   and check that each forward kernel's launch counter reads exactly T;
4. train (`core/training.py`, `core/unroll.py`):
   a. a sparse-rollback forward and backward through `unroll` from the
      memory the rollout left, in lockstep (every `scatter_rows` call of
      the backward is compared with its plain version on the same inputs),
      with the counters read after the forward and after the backward: the
      backward launches no O(N) kernel (read, LRA, write 0) and
      `scatter_rows` at least T times; the memory is back to the initial
      memory bit for bit; the loss and every gradient leaf are finite;
   b. the same in chunked mode with C = `suggest_chunk(...)`: gradients as
      in sparse mode within the gradient tolerance;
   c. the main path: one `make_task_train_step` step, in lockstep, with
      every counter set to 0 just before it and read just after; then
      three more RMSProp steps, and nothing may turn NaN;
   d. a small training step (N = 1000, T = 12) on the card against the
      plain versions on the CPU;
5. time each kernel, its plain version and the one PyTorch call that
   computes the same function where there is one (CUDA events, L2 flushed
   before each launch), the rollout's ms per step and its peak memory, the
   train step's ms (forward and backward apart) and its peak memory beside
   `residual_accounting(mode="sparse")` plus the one dense memory
   cotangent;
6. print the card, one JSON line of per-kernel numbers, and last the
   ``{"ok": true, ...}`` line.

Tolerances: integer outputs exact; forward floats within 1e-5 (other
summation order, rsqrt rounding). Read indices may differ from the plain
version's only where the plain similarities of the swapped rows lie within
1e-6 of each other; each such near-tie is counted and printed.
`scatter_rows` bit for bit in both modes: 'add' sums each row's columns
in the plain version's j order, so a dropped or reordered duplicate shows
even where the cotangents are tiny. Card against CPU: loss within 1e-5
relative; gradients, card against CPU and chunked against sparse, within
atol 1e-5 / rtol 1e-5, the bar of `tests/test_torch_train.py` (cuBLAS
sums the controller's products in another order than the CPU, and T
recurrent steps carry it; the runs read errors of 1e-8 and below).

It exits nonzero without printing a result when no CUDA device is
present or the port's sources are missing.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
NEAR_TIE = 1e-6
GRAD_ATOL = GRAD_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
B, T, MAX_LEN, BITS = 8, 42, 20, 8
N, W, H, K, HIDDEN, DELTA = 1 << 20, 32, 4, 4, 100, 0.005
LR = 1e-4
RECORD_STEPS = (1, 21)
REPLACES = {
    "fused_read_sweep": ("src/repro/kernels/fused_read.py:85",
                         "src/repro_torch/kernels/csrc/fused_read.cu"),
    "sparse_write_update": ("src/repro/kernels/sparse_write.py:68",
                            "src/repro_torch/kernels/csrc/sparse_write.cu"),
    "lra_topn": ("src/repro/kernels/usage_argmin.py:71",
                 "src/repro_torch/kernels/csrc/lra_topn.cu"),
    "scatter_rows": ("src/repro/kernels/scatter_rows.py:29",
                     "src/repro_torch/kernels/csrc/scatter_rows.cu"),
}
FORWARD = ("fused_read_sweep", "sparse_write_update", "lra_topn")


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def ptxas_summary(log: str) -> list[str]:
    keep = ("entry function", "Used", "spill")
    return [" ".join(line.replace("ptxas info    :", "").split())
            for line in log.splitlines() if any(k in line for k in keep)]


class Checker:
    """Compares each kernel call with its plain version on the same inputs
    and keeps the largest float error and the near-tie count per kernel."""

    def __init__(self, ref):
        self.ref = ref
        self.err = {name: 0.0 for name in REPLACES}
        self.near_ties = 0
        self.scatter_calls = {"add": 0, "set": 0}

    def lra(self, la, n, valid_n, out):
        want = self.ref.lra_topn_ref(la[:, :valid_n], n)
        require(torch.equal(out, want), "lra_topn differs from its plain version")

    def read(self, q, mem, beta, k, valid_n, out):
        read, w, idx = out
        _, _, r_idx = self.ref.fused_read_ref(q, mem, beta, k, valid_n=valid_n)
        diff = idx != r_idx
        if diff.any():
            qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-6)

            def sims(ix):
                rows = self.ref.gather_rows(mem, ix)
                rn = rows * torch.rsqrt((rows * rows).sum(-1, keepdim=True) + 1e-6)
                return torch.einsum("bhw,bhkw->bhk", qn, rn)

            gap = (sims(idx) - sims(r_idx)).abs()[diff].max().item()
            require(gap <= NEAR_TIE, f"read indices differ beyond a near-tie "
                                     f"(similarity gap {gap:.3g})")
            self.near_ties += int(diff.sum().item())
        # The floats are held against the plain tail on the kernel's rows.
        t_read, t_w = self.ref.sparse_read_tail(q, mem, beta, idx)
        err = max((read - t_read).abs().max().item(),
                  (w - t_w).abs().max().item())
        require(err <= TOL, f"fused_read_sweep float error {err:.3g}")
        self.err["fused_read_sweep"] = max(self.err["fused_read_sweep"], err)

    def write(self, before, after):
        m_ref, l_ref = before[0].clone(), before[1].clone()
        self.ref.sparse_write_update_ref(m_ref, l_ref, *before[2:7],
                                         delta=before[7])
        require(torch.equal(after[1], l_ref),
                "sparse_write_update usage table differs")
        err = (after[0] - m_ref).abs().max().item()
        require(err <= TOL, f"sparse_write_update float error {err:.3g}")
        self.err["sparse_write_update"] = max(
            self.err["sparse_write_update"], err)

    def scatter(self, before, idx, rows, mode, after):
        """``before``: a copy of the buffer the kernel got, which the plain
        version updates here; ``after``: the kernel's result."""
        want = self.ref.scatter_rows_ref(before, idx.contiguous(),
                                         rows.contiguous(), mode)
        err = (after - want).abs().max().item()
        require(torch.equal(after, want), f"scatter_rows '{mode}' differs "
                f"from its plain version (max err {err:.3g})")
        self.scatter_calls[mode] += 1


class Intercept:
    """Wraps the four ops of `repro_torch.kernels.ops` for one run. With a
    ``checker`` every call is compared with the plain version on the same
    inputs (lockstep); with ``record`` the inputs of the steps in
    RECORD_STEPS are kept as clones."""

    def __init__(self, ops, checker=None, record=False):
        self.ops, self.checker, self.record = ops, checker, record
        self.calls = {name: 0 for name in REPLACES}
        self.records = {}

    def _keep(self, name, args):
        self.calls[name] += 1
        if self.record and self.calls[name] in RECORD_STEPS:
            self.records[(name, self.calls[name])] = tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args)

    def __enter__(self):
        ops = self.ops
        self.saved = (ops.lra_topn, ops.fused_read, ops.sparse_write_update,
                      ops.scatter_rows)
        lra0, read0, write0, scatter0 = self.saved

        def lra_topn(la, n, *, valid_n=None):
            self._keep("lra_topn", (la, n, valid_n))
            out = lra0(la, n, valid_n=valid_n)
            if self.checker:
                self.checker.lra(la, n, valid_n, out)
            return out

        def fused_read(q, mem, beta, k, *, valid_n=None):
            self._keep("fused_read_sweep", (q, mem, beta, k, valid_n))
            out = read0(q, mem, beta, k, valid_n=valid_n)
            if self.checker:
                self.checker.read(q, mem, beta, k, valid_n, out)
            return out

        def sparse_write_update(mem, la, widx, ww, a, lra, step, *, delta):
            args = (mem, la, widx, ww, a, lra, step, delta)
            self._keep("sparse_write_update", args)
            before = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                           for x in args) if self.checker else None
            out = write0(mem, la, widx, ww, a, lra, step, delta=delta)
            if self.checker:
                self.checker.write(before, out)
            return out

        def scatter_rows(mem, idx, rows, mode="add"):
            self._keep("scatter_rows", (mem, idx, rows, mode))
            before = mem.detach().clone() if self.checker else None
            out = scatter0(mem, idx, rows, mode)
            if self.checker:
                self.checker.scatter(before, idx, rows.detach(), mode,
                                     out.detach())
            return out

        ops.lra_topn, ops.fused_read = lra_topn, fused_read
        ops.sparse_write_update, ops.scatter_rows = (sparse_write_update,
                                                     scatter_rows)
        return self

    def __exit__(self, *exc):
        (self.ops.lra_topn, self.ops.fused_read, self.ops.sparse_write_update,
         self.ops.scatter_rows) = self.saved
        return False


def time_ms(fn, iters, flush):
    """Median ms of single launches on the device, each after an L2 flush.
    A GPU spin after the flush holds the stream until the host has queued
    the start event, the launch and the end event, so host-side wrapper
    time never lands inside the timed window."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.add_(1.0)            # 128 MB: pushes the 50 MB L2 out
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def host_ms(fn, runs=5, setup=None):
    """Median host-clock ms of ``fn`` over ``runs`` synchronised runs, each
    after ``setup`` (outside the window); returns (median, all times)."""
    times = []
    for _ in range(runs):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unique_rows(idx) -> int:
    return len({(b, r) for b, row in enumerate(idx.tolist()) for r in row})


def run() -> None:
    require(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from torch.utils import _pytree as pytree

        from repro_torch.core import sam, training
        from repro_torch.core import unroll as unroll_lib
        from repro_torch.core.cell import SAMCell
        from repro_torch.core.types import (LA_SCRATCH, ControllerConfig,
                                            MemoryConfig)
        from repro_torch.data.tasks import copy_task
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels.fused_read import fused_read_sweep
        from repro_torch.kernels.scatter_rows import scatter_rows
        from repro_torch.kernels.sparse_write import sparse_write_update
        from repro_torch.kernels.usage_argmin import lra_topn
        from repro_torch.optim import optimizers as opt
    except ImportError as e:
        raise SmokeFailure(f"the port's sources are missing: {e}") from e
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {"fused_read_sweep": fused_read_sweep,
               "sparse_write_update": sparse_write_update,
               "lra_topn": lra_topn, "scatter_rows": scatter_rows}

    def zero_counts():
        for fn in kernels.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    # ---- 1. build ----
    t0 = time.perf_counter()
    try:
        info = _build.build_all()
    except RuntimeError as e:
        raise SmokeFailure(f"the kernels did not build: {e}") from e
    print(f"[build] {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(info)} (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, v in info.items():
        for line in ptxas_summary(v["ptxas"]):
            print(f"[build] {name}: {line}")

    cfg = sam.SAMConfig(MemoryConfig(num_slots=N, word_size=W, num_heads=H,
                                     k=K, delta=DELTA),
                        ControllerConfig(input_size=BITS + 2,
                                         hidden_size=HIDDEN,
                                         output_size=BITS))
    model = sam.SAM(cfg, seed=0, device=dev)
    inputs, targets, mask = copy_task(
        B, MAX_LEN, MAX_LEN, BITS, device=dev,
        generator=torch.Generator().manual_seed(1))
    xs = inputs.transpose(0, 1).contiguous()              # (T, B, D)
    ts, ms = targets.transpose(0, 1), mask.transpose(0, 1)
    require(xs.shape == (T, B, BITS + 2), f"xs has shape {tuple(xs.shape)}")

    # ---- 2. each kernel against its plain version, at full width ----
    checker = Checker(ref)
    with torch.inference_mode():
        with Intercept(ops, record=True) as rec:
            model(model.init_state(B), xs[:max(RECORD_STEPS)])
        for step in RECORD_STEPS:
            q, mem, beta, k, valid_n = rec.records[("fused_read_sweep", step)]
            checker.read(q, mem, beta, k, valid_n,
                         fused_read_sweep(q, mem, beta, k=k, valid_n=valid_n))
            la, n, valid_n = rec.records[("lra_topn", step)]
            checker.lra(la, n, valid_n, lra_topn(la, n, valid_n=valid_n))
            before = rec.records[("sparse_write_update", step)]
            m, l = before[0].clone(), before[1].clone()
            checker.write(before, sparse_write_update(m, l, *before[2:7],
                                                      delta=before[7]))
            if step == 1:
                require(mem.abs().max().item() > 0.0 and
                        before[0].abs().max().item() == 0.0,
                        "step 1 should write into an all-zero memory")
            torch.cuda.synchronize()
            print(f"[kernels] step {step}: read err "
                  f"{checker.err['fused_read_sweep']:.3g}, write err "
                  f"{checker.err['sparse_write_update']:.3g}, lra exact, "
                  f"near-ties {checker.near_ties}")

        # scatter_rows on the inputs of a real backward at step 21.
        step = max(RECORD_STEPS)
        wr = rec.records[("sparse_write_update", step)]
        q21, mem21, beta21, _, _ = rec.records[("fused_read_sweep", step)]
        widx21 = wr[2]                       # the rows step 21 wrote ...
        old21 = ref.gather_rows(wr[0], widx21)       # ... and their old rows
        ridx21 = fused_read_sweep(q21, mem21, beta21, k=K,
                                  valid_n=N)[2].reshape(B, H * K)
        cpu = torch.Generator().manual_seed(2)
        dup_idx = torch.randint(0, 3, (B, widx21.shape[1]), generator=cpu,
                                dtype=torch.int32).to(dev)

        def randn(*shape):
            return torch.randn(shape, generator=cpu).to(dev)

        scatter_cases = {
            "rollback of step 21 (set)": (mem21, widx21, old21, "set"),
            "read cotangent (add)": (torch.zeros_like(mem21), ridx21,
                                     randn(B, H * K, W), "add"),
            "duplicates (add)": (mem21, dup_idx, randn(B, widx21.shape[1], W),
                                 "add"),
            "duplicates (set)": (mem21, dup_idx, randn(B, widx21.shape[1], W),
                                 "set"),
        }
        for name, (buf, idx, rows, mode) in scatter_cases.items():
            out = scatter_rows(buf.clone(), idx, rows, mode=mode)
            checker.scatter(buf.clone(), idx, rows, mode, out)
            if name.startswith("rollback"):
                require(torch.equal(out, wr[0]), "the rollback of step 21 "
                        "does not give back the memory before its write")
            del out
        torch.cuda.synchronize()
        print(f"[kernels] scatter_rows on backward inputs at full width: "
              f"{', '.join(scatter_cases)}; both modes bit for bit; the "
              f"rollback gives back the memory before step {step}'s write "
              f"bit for bit")

    # ---- 3. the forward path, in lockstep ----
    zero_counts()
    state = model.init_state(B)
    with torch.inference_mode(), Intercept(ops, checker=checker):
        state, ys = model(state, xs)
    torch.cuda.synchronize()
    fwd_launches = counts()
    print(f"[forward] launches {fwd_launches} over T={T} steps; near-ties "
          f"{checker.near_ties}")
    for name in FORWARD:
        require(fwd_launches[name] == T, f"{name} launched "
                f"{fwd_launches[name]} times, expected {T}")
    require(ys.shape == (T, B, BITS) and torch.isfinite(ys).all().item(),
            "outputs are not finite values of shape (T, B, bits)")
    require(torch.isfinite(state.memory).all().item(), "memory not finite")
    require(state.memory[:, N].eq(0).all().item()
            and state.last_access[:, N].eq(LA_SCRATCH).all().item(),
            "the scratch row was touched")
    require(int(state.step) == T, "step counter")
    # The same cell on a small input: kernels on the card vs plain on the CPU.
    small = sam.SAMConfig(MemoryConfig(num_slots=1000, word_size=W,
                                       num_heads=H, k=K, delta=DELTA),
                          cfg.controller)
    small_cpu = sam.SAM(small, seed=3, device="cpu")
    small_gpu = sam.SAM(small, seed=3, device=dev)
    _, y_cpu = small_cpu(small_cpu.init_state(2), xs[:12, :2].cpu())
    _, y_gpu = small_gpu(small_gpu.init_state(2), xs[:12, :2])
    small_err = (y_gpu.cpu() - y_cpu).abs().max().item()
    require(small_err <= TOL, f"small rollout differs from the CPU ({small_err:.3g})")
    print(f"[forward] small rollout (N=1000, T=12) card vs CPU max err {small_err:.3g}")

    # ---- 4. training ----
    cell = SAMCell(cfg)
    flat_p, p_spec = pytree.tree_flatten(
        {g: {n: v.detach() for n, v in t.items()}
         for g, t in model.params().items()})

    def start_state():
        """A fresh state holding what the forward rollout left: a memory
        with 42 steps of writes, its usage table, read and controller."""
        s = cell.init_state(B, device=dev)
        s.memory.copy_(state.memory)
        s.last_access.copy_(state.last_access)
        return s._replace(read=type(state.read)(*(t.clone() for t in state.read)),
                          ctrl=type(state.ctrl)(*(t.clone() for t in state.ctrl)),
                          step=state.step.clone())

    def fwd_bwd(mode, chunk, lockstep):
        """One forward and backward through `unroll` from `start_state`.
        Returns (loss, grads, fwd counts, bwd counts, memory restored,
        residual accounting)."""
        s0 = start_state()
        m0 = s0.memory.clone()
        leaves = [p.clone().requires_grad_() for p in flat_p]
        params = pytree.tree_unflatten(leaves, p_spec)
        acct = unroll_lib.residual_accounting(cell, params, s0, xs, mode=mode,
                                              chunk=chunk)
        with Intercept(ops, checker=checker if lockstep else None):
            zero_counts()
            _, ys_t = unroll_lib.unroll(cell, params, s0, xs, mode=mode,
                                        chunk=chunk)
            loss = training.bits_loss(ys_t, ts, ms)
            torch.cuda.synchronize()
            fwd = counts()
            zero_counts()
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            bwd = counts()
        restored = torch.equal(s0.memory, m0)
        return loss.detach(), grads, fwd, bwd, restored, acct

    def checked_since(before):
        return {m: c - before[m] for m, c in checker.scatter_calls.items()}

    scatter_checked = dict(checker.scatter_calls)
    loss_s, g_sparse, fwd, bwd, restored, acct = fwd_bwd("sparse", None, True)
    print(f"[train] sparse forward launches {fwd}; backward launches {bwd}; "
          f"scatter_rows calls checked in lockstep "
          f"{checked_since(scatter_checked)}, each bit for bit")
    for name in FORWARD:
        require(fwd[name] == T, f"forward: {name} launched {fwd[name]} times")
        require(bwd[name] == 0, f"the backward launched {name} {bwd[name]} "
                f"times: it must launch no O(N) kernel")
    require(fwd["scatter_rows"] == 0 and bwd["scatter_rows"] >= T,
            f"scatter_rows launched {fwd['scatter_rows']} times in the "
            f"forward and {bwd['scatter_rows']} in the backward")
    require(restored, "the sparse backward did not restore the memory")
    require(torch.isfinite(loss_s).item(), "the loss is not finite")
    require(all(torch.isfinite(g).all().item() for g in g_sparse),
            "a gradient leaf is not finite")
    print(f"[train] sparse backward: memory restored bit for bit; loss "
          f"{loss_s.item():.6f}; {len(g_sparse)} gradient leaves finite")

    chunk = unroll_lib.suggest_chunk(cell, None, start_state(), xs)
    loss_c, g_chunk, fwd_c, bwd_c, restored_c, acct_c = fwd_bwd(
        "chunked", chunk, False)
    chunk_err = max((a - b).abs().max().item()
                    for a, b in zip(g_chunk, g_sparse))
    require(restored_c, "the chunked backward did not restore the memory")
    require(all(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                for a, b in zip(g_chunk, g_sparse)),
            f"chunked gradients differ from sparse ones (max err {chunk_err:.3g})")
    require(abs(loss_c.item() - loss_s.item()) <= TOL * abs(loss_s.item()),
            "chunked loss differs from the sparse loss")
    print(f"[train] chunked C={chunk}: gradients max err {chunk_err:.3g} "
          f"against sparse; backward launches {bwd_c} (the segment's "
          f"forward is recomputed once); memory restored bit for bit")

    # The main path: one make_task_train_step step, in lockstep.
    init_p, init_s, step_fn = training.make_task_train_step(
        training.ModelSpec("sam", cfg.memory, cfg.controller), LR,
        device=dev)
    params = pytree.tree_unflatten([p.clone() for p in flat_p], p_spec)
    opt_state = opt.rmsprop_init(params)
    scatter_checked = dict(checker.scatter_calls)
    zero_counts()
    with Intercept(ops, checker=checker):
        params, opt_state, loss, err = step_fn(params, opt_state, inputs,
                                               targets, mask)
    torch.cuda.synchronize()
    launches = counts()
    print(f"[train] main path: one make_task_train_step step, launches "
          f"{launches}; loss {loss.item():.6f}, bit error {err.item():.4f}; "
          f"scatter_rows calls checked in lockstep "
          f"{checked_since(scatter_checked)}")
    for name in FORWARD:
        require(launches[name] == T, f"train step: {name} launched "
                f"{launches[name]} times, expected {T} (forward only)")
    require(launches["scatter_rows"] >= T, "train step: scatter_rows "
            f"launched {launches['scatter_rows']} times")
    losses = [loss.item()]
    for _ in range(3):
        params, opt_state, loss, _ = step_fn(params, opt_state, inputs,
                                             targets, mask)
        losses.append(loss.item())
        require(torch.isfinite(loss).item() and all(
            torch.isfinite(p).all().item()
            for p in pytree.tree_leaves((params, opt_state))),
            "an RMSProp step produced a NaN or an infinity")
    print(f"[train] four RMSProp steps, losses {losses}: all finite")

    # A small training step: kernels on the card against plain on the CPU.
    small_spec = training.ModelSpec("sam", small.memory, small.controller)
    batch = copy_task(2, 5, 5, BITS, device="cpu",
                      generator=torch.Generator().manual_seed(4))
    results = {}
    for device in ("cpu", dev):
        s_init_p, s_init_s, s_unroll = training.build_model(small_spec,
                                                            device=device)
        leaves, spec_s = pytree.tree_flatten(
            s_init_p(torch.Generator().manual_seed(5)))
        leaves = [p.requires_grad_() for p in leaves]
        b_in, b_tgt, b_mask = (t.to(device) for t in batch)
        _, ys_small = s_unroll(pytree.tree_unflatten(leaves, spec_s),
                               s_init_s(2), b_in.transpose(0, 1))
        l_small = training.bits_loss(ys_small, b_tgt.transpose(0, 1),
                                     b_mask.transpose(0, 1))
        results[str(device)] = (l_small.item(), [
            g.cpu() for g in torch.autograd.grad(l_small, leaves)])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results[str(dev)]
    small_grad_err = max((a - b).abs().max().item()
                         for a, b in zip(g_gpu, g_cpu))
    require(abs(l_gpu - l_cpu) <= TOL * abs(l_cpu),
            f"small train step: loss {l_gpu} on the card, {l_cpu} on the CPU")
    require(all(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                for a, b in zip(g_gpu, g_cpu)),
            f"small train step: gradients differ (max err {small_grad_err:.3g})")
    print(f"[train] small step (N=1000, T=12) card vs CPU: loss rel err "
          f"{abs(l_gpu - l_cpu) / abs(l_cpu):.3g}, gradients max err "
          f"{small_grad_err:.3g}")

    # ---- 5. timing, on the step-21 inputs ----
    flush = torch.empty(32 << 20, device=dev)
    step = max(RECORD_STEPS)
    q, mem, beta, k, valid_n = rec.records[("fused_read_sweep", step)]
    la, n, _ = rec.records[("lra_topn", step)]
    m_t, l_t = wr[0].clone(), wr[1].clone()
    neg_la = (-la[:, :N]).contiguous()
    widx = wr[2]
    uniq = unique_rows(widx)
    J = widx.shape[1]
    # scatter_rows: the rollback's 'set' of step 21 and the read
    # cotangent's 'add', on buffers of the full (B, N+1, W) size.
    buf_set, buf_add = mem21.clone(), torch.zeros_like(mem21)
    g_add = scatter_cases["read cotangent (add)"][2]
    uniq_add = unique_rows(ridx21)
    b_set = torch.arange(B, device=dev)[:, None].expand(B, J)
    b_add = torch.arange(B, device=dev)[:, None].expand(B, H * K)
    widx_l, ridx_l = widx.long(), ridx21.long()
    rows = {
        "fused_read_sweep": dict(
            ms=time_ms(lambda: fused_read_sweep(q, mem, beta, k=k,
                                                valid_n=valid_n), 20, flush),
            plain_ms=time_ms(lambda: ref.fused_read_ref(q, mem, beta, k,
                                                        valid_n=valid_n),
                             5, flush),
            library_ms=None,
            bound=bound(4 * (B * N * W + 2 * B * H * W + B * H + 2 * B * H * K),
                        B * N * W * (2 * H + 2))),
        "sparse_write_update": dict(
            ms=time_ms(lambda: sparse_write_update(m_t, l_t, *wr[2:7],
                                                   delta=wr[7]), 50, flush),
            plain_ms=time_ms(lambda: ref.sparse_write_update_ref(
                m_t, l_t, *wr[2:7], wr[7]), 20, flush),
            library_ms=None,
            bound=bound(4 * (2 * uniq * W + 2 * uniq + 2 * B * J + B * H * W
                             + B * H + B), 2 * B * J * W)),
        "lra_topn": dict(
            ms=time_ms(lambda: lra_topn(la, n, valid_n=N), 50, flush),
            plain_ms=time_ms(lambda: ref.lra_topn_ref(la[:, :N], n), 20, flush),
            library_ms=time_ms(lambda: torch.topk(neg_la, n, dim=-1), 50, flush),
            bound=bound(4 * (B * N + B * n), B * N)),
        "scatter_rows": dict(
            ms=time_ms(lambda: scatter_rows(buf_set, widx, old21, mode="set"),
                       50, flush),
            plain_ms=time_ms(lambda: ref.scatter_rows_ref(buf_set, widx, old21,
                                                          "set"), 20, flush),
            library_ms=time_ms(lambda: buf_set.index_put_((b_set, widx_l),
                                                          old21), 50, flush),
            # 'set' reads only the row that wins each target (its last
            # column) and writes it once; every column's index is read.
            bound=bound(4 * (B * J + 2 * uniq * W), 0)),
    }
    scatter_add = dict(
        ms=time_ms(lambda: scatter_rows(buf_add, ridx21, g_add, mode="add"),
                   50, flush),
        plain_ms=time_ms(lambda: ref.scatter_rows_ref(buf_add, ridx21, g_add,
                                                      "add"), 20, flush),
        library_ms=time_ms(lambda: buf_add.index_put_(
            (b_add, ridx_l), g_add, accumulate=True), 50, flush),
        bound=bound(4 * (B * H * K + B * H * K * W + 2 * uniq_add * W),
                    B * H * K * W))
    # The rollout's time per step on the host clock: the median of five
    # synchronised T-step rollouts, each from a fresh state.
    # Its peak memory is counted above what the script already holds (the
    # recorded inputs of phase 2).
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rollouts = []
    for _ in range(5):
        fresh = model.init_state(B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            model(fresh, xs)
        torch.cuda.synchronize()
        rollouts.append((time.perf_counter() - t0) * 1e3 / T)
        del fresh
    step_ms = sorted(rollouts)[len(rollouts) // 2]
    peak = torch.cuda.max_memory_allocated() - held
    # The train step: the whole step (five, host clock), then its forward
    # and its backward apart, and its peak memory above what is held.
    train_ms, train_all = host_ms(lambda _: step_fn(params, opt_state, inputs,
                                                    targets, mask))
    leaves = [p.clone().requires_grad_() for p in flat_p]
    p_train = pytree.tree_unflatten(leaves, p_spec)
    fwd_out = {}

    def forward(s0):
        fwd_out["loss"] = training.bits_loss(
            unroll_lib.unroll(cell, p_train, s0, xs)[1], ts, ms)

    def setup_backward():
        s0 = start_state()
        forward(s0)
        return s0

    fwd_ms, fwd_all = host_ms(forward, setup=start_state)
    bwd_ms, bwd_all = host_ms(
        lambda _: torch.autograd.grad(fwd_out["loss"], leaves),
        setup=setup_backward)
    del fwd_out["loss"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_train = torch.cuda.memory_allocated()
    step_fn(params, opt_state, inputs, targets, mask)
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated() - held_train
    mem_ct_bytes = B * (N + 1) * W * 4
    # Where the train step's time goes: the device time of its kernels in
    # one step traced by torch.profiler, against the step's wall time.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step_fn(params, opt_state, inputs, targets, mask)
        torch.cuda.synchronize()
    on_device = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in on_device)
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[time] {name}: {r['ms']:.4f} ms (bound {r['bound'][0]:.4f} ms "
              f"by {r['bound'][1]}), plain {r['plain_ms']:.4f} ms, "
              f"library {lib}")
    print(f"[time] scatter_rows 'set' above is the rollback of step {step} "
          f"(J={J}, {uniq} unique rows; library = index_put_); 'add' (read "
          f"cotangent, {H * K} columns, {uniq_add} unique rows): "
          f"{scatter_add['ms']:.4f} ms (bound {scatter_add['bound'][0]:.6f} ms "
          f"by {scatter_add['bound'][1]}), plain {scatter_add['plain_ms']:.4f} "
          f"ms, library index_put_(accumulate=True) "
          f"{scatter_add['library_ms']:.4f} ms; launches per train step "
          f"{launches['scatter_rows']}")
    print(f"[time] rollout {step_ms:.3f} ms/step, median of "
          f"{', '.join(f'{r:.3f}' for r in rollouts)} (B={B}, N={N}, T={T}); "
          f"peak memory {peak / 2**30:.2f} GiB; write touches {uniq} unique "
          f"rows")
    print(f"[time] train step {train_ms:.2f} ms, median of "
          f"{', '.join(f'{t:.2f}' for t in train_all)} (sparse, B={B}, N={N}, "
          f"T={T}); forward {fwd_ms:.2f} ms (of "
          f"{', '.join(f'{t:.2f}' for t in fwd_all)}), backward {bwd_ms:.2f} "
          f"ms (of {', '.join(f'{t:.2f}' for t in bwd_all)})")
    print(f"[time] train step peak memory {train_peak / 2**30:.3f} GiB "
          f"({train_peak} B) against residual_accounting(mode='sparse') "
          f"{acct['residual_bytes']} B + one dense memory cotangent "
          f"{mem_ct_bytes} B = {acct['residual_bytes'] + mem_ct_bytes} B "
          f"(chunked C={chunk}: {acct_c['residual_bytes']} B)")
    if device_ms > 0:
        print(f"[time] train step on the device (torch.profiler, one step): "
              f"{device_ms:.2f} ms of kernels, {device_ms / train_ms:.1%} of "
              f"the {train_ms:.2f} ms step; by kernel (ms, launches): "
              + "; ".join(f"{k[:60]} {t:.3f} ({c})" for k, t, c in on_device[:8]))
    else:
        print("[time] train step on the device: not measured (the profiler "
              "recorded no device time)")

    # ---- 6. report ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    print(smi.stdout.strip().splitlines()[0])
    report = []
    for name, r in rows.items():
        replaces, source = REPLACES[name]
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": checker.err.get(name, 0.0),
                       "ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                       "library_ms": r["library_ms"]})
    report[-1]["add"] = {"ms": scatter_add["ms"],
                         "plain_ms": scatter_add["plain_ms"],
                         "bound_ms": scatter_add["bound"][0],
                         "library_ms": scatter_add["library_ms"]}
    print(json.dumps({"kernels": report, "near_ties": checker.near_ties,
                      "ms_per_step": step_ms, "peak_bytes": peak,
                      "forward_launches": fwd_launches,
                      "train_ms_per_step": train_ms, "train_fwd_ms": fwd_ms,
                      "train_bwd_ms": bwd_ms, "train_peak_bytes": train_peak,
                      "train_device_ms": device_ms or None,
                      "train_residual_bytes": acct["residual_bytes"],
                      "mem_ct_bytes": mem_ct_bytes,
                      "card_vs_cpu_grad_err": small_grad_err,
                      "chunked_vs_sparse_grad_err": chunk_err}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
