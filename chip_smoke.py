#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the SAM cell's forward path — the copy task at the paper's widths
(controller 100, H = K = 4, W = 32, δ = 0.005, f32 rows) with N = 2^20
memory rows, B = 8 and T = 42 — through the three hand-written CUDA
kernels, and fails (nonzero exit) if any phase fails:

1. build the kernels from `src/repro_torch/kernels/csrc/` with nvcc for
   sm_90a and print each kernel's registers, shared memory and spills;
2. hold each kernel against its plain PyTorch version at full width, on
   the inputs of a real rollout: the all-zero first step and step 21;
3. run the main path (`SAM.forward` = `sam_unroll`) in lockstep — at every
   step the plain versions run on the inputs the kernels got and the
   outputs are compared, the rollout going on with the kernels' results —
   and check that each kernel's launch counter reads exactly T;
4. time each kernel, its plain version and the one PyTorch call that
   computes the same function where there is one (CUDA events, L2 flushed
   before each launch), the rollout's ms per step and its peak memory;
5. print the card, one JSON line of per-kernel numbers, and last the
   ``{"ok": true, ...}`` line.

Tolerances: integer outputs exact; floats within 1e-5 (other summation
order, rsqrt rounding). Read indices may differ from the plain version's
only where the plain similarities of the swapped rows lie within 1e-6 of
each other; each such near-tie is counted and printed.

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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
B, T, MAX_LEN, BITS = 8, 42, 20, 8
N, W, H, K, HIDDEN, DELTA = 1 << 20, 32, 4, 4, 100, 0.005
RECORD_STEPS = (1, 21)
REPLACES = {
    "fused_read_sweep": ("src/repro/kernels/fused_read.py:85",
                         "src/repro_torch/kernels/csrc/fused_read.cu"),
    "sparse_write_update": ("src/repro/kernels/sparse_write.py:68",
                            "src/repro_torch/kernels/csrc/sparse_write.cu"),
    "lra_topn": ("src/repro/kernels/usage_argmin.py:71",
                 "src/repro_torch/kernels/csrc/lra_topn.cu"),
}


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


class Intercept:
    """Wraps the three ops of `repro_torch.kernels.ops` for one rollout.
    With a ``checker`` every call is compared with the plain version on
    the same inputs (lockstep); with ``record`` the inputs of the steps in
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
        self.saved = (ops.lra_topn, ops.fused_read, ops.sparse_write_update)
        lra0, read0, write0 = self.saved

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

        ops.lra_topn, ops.fused_read = lra_topn, fused_read
        ops.sparse_write_update = sparse_write_update
        return self

    def __exit__(self, *exc):
        (self.ops.lra_topn, self.ops.fused_read,
         self.ops.sparse_write_update) = self.saved
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


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run() -> None:
    require(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import sam
        from repro_torch.core.types import (LA_SCRATCH, ControllerConfig,
                                            MemoryConfig)
        from repro_torch.data.tasks import copy_task
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels.fused_read import fused_read_sweep
        from repro_torch.kernels.sparse_write import sparse_write_update
        from repro_torch.kernels.usage_argmin import lra_topn
    except ImportError as e:
        raise SmokeFailure(f"the port's sources are missing: {e}") from e
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {"fused_read_sweep": fused_read_sweep,
               "sparse_write_update": sparse_write_update,
               "lra_topn": lra_topn}

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
    inputs, _, _ = copy_task(B, MAX_LEN, MAX_LEN, BITS, device=dev,
                             generator=torch.Generator().manual_seed(1))
    xs = inputs.transpose(0, 1).contiguous()              # (T, B, D)
    require(xs.shape == (T, B, BITS + 2), f"xs has shape {tuple(xs.shape)}")

    # ---- 2. each kernel against its plain version, at full width ----
    with torch.inference_mode():
        with Intercept(ops, record=True) as rec:
            model(model.init_state(B), xs[:max(RECORD_STEPS)])
        checker = Checker(ref)
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

    # ---- 3. the main path, in lockstep ----
    for fn in kernels.values():
        fn.launches = 0
    state = model.init_state(B)
    with torch.inference_mode(), Intercept(ops, checker=checker):
        state, ys = model(state, xs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"[main] launches {launches} over T={T} steps; near-ties "
          f"{checker.near_ties}")
    for name, count in launches.items():
        require(count == T, f"{name} launched {count} times, expected {T}")
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
    print(f"[main] small rollout (N=1000, T=12) card vs CPU max err {small_err:.3g}")

    # ---- 4. timing, on the step-21 inputs ----
    flush = torch.empty(32 << 20, device=dev)
    step = max(RECORD_STEPS)
    q, mem, beta, k, valid_n = rec.records[("fused_read_sweep", step)]
    la, n, _ = rec.records[("lra_topn", step)]
    wr = rec.records[("sparse_write_update", step)]
    m_t, l_t = wr[0].clone(), wr[1].clone()
    neg_la = (-la[:, :N]).contiguous()
    widx = wr[2]
    uniq = len({(b, r) for b, row in enumerate(widx.tolist()) for r in row})
    J = widx.shape[1]
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
    }
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
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[time] {name}: {r['ms']:.4f} ms (bound {r['bound'][0]:.4f} ms "
              f"by {r['bound'][1]}), plain {r['plain_ms']:.4f} ms, "
              f"library {lib}")
    print(f"[time] rollout {step_ms:.3f} ms/step, median of "
          f"{', '.join(f'{r:.3f}' for r in rollouts)} (B={B}, N={N}, T={T}); "
          f"peak memory {peak / 2**30:.2f} GiB; write touches {uniq} unique "
          f"rows")

    # ---- 5. report ----
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
    print(json.dumps({"kernels": report, "near_ties": checker.near_ties,
                      "ms_per_step": step_ms, "peak_bytes": peak}))
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
