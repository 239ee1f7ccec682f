#!/usr/bin/env python3
"""Host and device ms a token of the LM's decode on one NVIDIA GPU, for
comparing two checkouts of the port in one call.

    python3 chip_decode_ab.py ROOT [--engine]

imports the port and `chip_smoke.py` from the checkout at ROOT, draws
`starcoder2_7b_sam` at full width (bf16 weights from seed 0), decodes a
32-token prompt with memory states at B = 4, then times five windows of
32 greedy `decode_step`s (host clock, synchronised; the median a token)
and one window under `torch.profiler` (device ms a token, top kernels).
Run it for each checkout in turns (parent, change, change, parent). With
``--engine`` it then runs `chip_smoke.engine_phase` on the same weights
(phase 12: the serving engine, its lockstep, the evict/restore round
trip and the rescale gate).
"""
from __future__ import annotations

import statistics
import sys
import time

import torch


def main() -> int:
    root = sys.argv[1]
    sys.path.insert(0, root)
    sys.path.insert(0, root + "/src")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import lm

    if not torch.cuda.is_available():
        print("chip_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    cfg = get_config("starcoder2_7b_sam")
    params = lm.init_params(cfg, seed=0, device=dev, dtype=cfg.compute_dtype)
    B, P, G = 4, 32, 32
    toks = torch.randint(0, cfg.vocab_size, (B, P),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    cache = lm.init_cache(cfg, B, 128, device=dev)
    mem = lm.init_memory_states(cfg, B, device=dev)
    _, cache, mem = lm.decode_scan(params, cfg, cache, toks, mem_states=mem)
    st = {"cache": cache, "mem": mem}

    def window():
        st["cache"] = {**st["cache"], "pos": torch.tensor(
            P, dtype=torch.int32, device=dev)}
        tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(G):
            logits, st["cache"], st["mem"] = lm.decode_step(
                params, cfg, st["cache"], tok, mem_states=st["mem"])
            tok = logits[:, -1].float().argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / G

    window()
    ts = [window() for _ in range(5)]
    dev_ms, on_dev = cs.device_time(window)
    print(f"[decode_ab] {root}: decode host ms/token median "
          f"{statistics.median(ts):.3f} of {[round(t, 3) for t in ts]}; "
          f"device {dev_ms / G:.3f} ms/token; top: "
          + "; ".join(f"{k[:50]} {t / G:.3f} ({c / G:g})"
                      for k, t, c in on_dev[:5]), flush=True)
    print(cs.card_line(), flush=True)
    if "--engine" in sys.argv[2:]:
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.fused_read import fused_read_sweep
        from repro_torch.kernels.sparse_write import sparse_write_update
        from repro_torch.kernels.usage_argmin import lra_topn
        kernels = {"flash_attention": flash_attention,
                   "fused_read_sweep": fused_read_sweep,
                   "sparse_write_update": sparse_write_update,
                   "lra_topn": lra_topn}

        def zero_counts():
            for fn in kernels.values():
                fn.launches = 0

        def counts():
            c = {name: 0 for name in cs.REPLACES}
            c.update({name: fn.launches for name, fn in kernels.items()})
            return c

        del st, cache, mem
        torch.cuda.empty_cache()
        res = cs.engine_phase(dev, ops, ref, cs.Checker(ref), zero_counts,
                              counts, params)
        print("[decode_ab] engine", {k: v for k, v in res.items()
                                     if not isinstance(v, (list, dict))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
