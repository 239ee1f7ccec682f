"""Serving entry points of the port, the JAX package's `launch/serve.py`.

`serve` is the static batch: prefill a lockstep batch of prompts with
`lm.decode_scan`, then decode greedy (or sampled) tokens one
`lm.decode_step` at a time. Like the JAX driver it passes no memory
states, so it runs no memory op. An audio config's prompt is frames of
N(0, 1) (B, prompt_len, d), and each chosen token is fed back as
``one_hot(token, d_model)``, JAX's: MusicGen's tokens of 1536 and up
(its vocabulary is 2048, d_model 1536) feed a zero frame (ROADMAP §C).
`serve_continuous` serves synthetic single-request users through the
continuous-batching engine (`launch/engine`), whose decode carries each
lane's memory states; the engine refuses an audio config, as JAX's.

    python -m repro_torch.launch.serve --arch starcoder2_7b_sam --full
    python -m repro_torch.launch.serve --continuous --requests 8 --full
    python -m repro_torch.launch.serve --arch h2o_danube_3_4b_sam --full
    python -m repro_torch.launch.serve --arch paligemma_3b_sam --full
    python -m repro_torch.launch.serve --arch deepseek_v2_236b_sam --full \
        --layers 4
    python -m repro_torch.launch.serve \
        --arch llama4_maverick_400b_a17b_sam --full --layers 2
    python -m repro_torch.launch.serve --arch musicgen_medium_sam --full
    python -m repro_torch.launch.serve --arch rwkv6_7b_sam --full
    python -m repro_torch.launch.serve --arch rwkv6_7b_sam --full \
        --continuous
    python -m repro_torch.launch.serve --arch hymba_1_5b_sam --full

run StarCoder2-7B (weights from ``--seed``, held in the bf16 compute
dtype: 15.8 GB), H2O-Danube3-4B (sliding window, a ring cache of
min(max_len, 4096) slots: 7.9 GB), PaliGemma-3B (2.67 B parameters with
its pad heads, 5.3 GB), DeepSeek-V2 (MLA and MoE; its 60 layers need
472 GB, so ``--layers 4`` keeps the dense layer and 3 MoE layers: 13.3 B
parameters, 26.6 GB) or Llama-4 Maverick (GQA with 40 heads padded to
48, MoE layers of 128 experts, top-1, one shared; its 48 layers need
1.57 TB, so ``--layers 2`` keeps two MoE layers: 34.7 B parameters,
69.4 GB), MusicGen-medium (frames in place of tokens, 24 heads padded to
48 at head dim 64: 1.6 B parameters, 3.3 GB) or RWKV-6 7B (the
attention-free RWKV block, whose decode state is O(1) in the length: 7.7
B parameters, 15.4 GB) or Hymba-1.5B (the hybrid block: windowed
attention beside a selective SSM, whose conv and state the decode
carries: 1.78 B parameters, 3.57 GB) at full width on the card, with or
without the ``_sam`` memory layer; without ``--full`` the reduced
config; ``--device cpu`` runs on the host.
PaliGemma is served with token prompts, as JAX serves it: the decode
attends causally from position 0 and has no image prefix (its prefill
with patch embeddings is `models.lm.prefill`). Yi-34B and
Mistral-Large-123B raise, naming ROADMAP item A9c.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.models import lm


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def one_hot(tok: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.nn.one_hot(tok, width)``: (B,) ints -> (B, width) f32, a row of
    zeros for a token outside [0, width)."""
    return (tok[:, None].long() == torch.arange(
        width, device=tok.device)).float()


def _select(logits: torch.Tensor, greedy: bool,
            generator: torch.Generator) -> torch.Tensor:
    """Next token from the last position's logits (B, 1, V): the argmax
    (the lowest index on ties), or a temperature-1 sample."""
    last = logits[:, -1].float()
    if greedy:
        return last.argmax(-1).to(torch.int32)
    return torch.multinomial(torch.softmax(last, -1), 1,
                             generator=generator)[:, 0].to(torch.int32)


def config(arch: str, use_reduced: bool = True, num_layers: int = None):
    """``arch``'s config: the reduced one unless ``use_reduced=False``,
    its depth cut to the first ``num_layers`` layers where given (the
    widths kept: DeepSeek-V2's 60 layers and Llama-4's 48 do not fit one
    card)."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return cfg


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32,
          gen_len: int = 32, max_len: int = 128, use_reduced: bool = True,
          seed: int = 0, greedy: bool = True, device="cuda",
          num_layers: int = None):
    """Serve one static batch of ``arch`` (`config`); see `_serve`."""
    cfg = config(arch, use_reduced, num_layers)
    return _serve(cfg, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                  max_len=max_len, seed=seed, greedy=greedy, device=device)


def _serve(cfg, *, batch, prompt_len, gen_len, max_len, seed, greedy=True,
           device="cuda", params=None, prompt=None):
    """``params`` and ``prompt`` (B, prompt_len) default to weights from
    ``seed`` (held in the compute dtype) and tokens in [1, V) from
    ``seed`` (an audio config's prompt: frames (B, prompt_len, d) of N(0,
    1)). Returns {"tokens" (B, gen_len): the token chosen after each
    decode step, "prefill_s", "decode_s", "decode_tok_per_s"}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    audio = cfg.frontend == "audio"
    if params is None:
        params = lm.init_params(cfg, seed=seed, device=device,
                                dtype=cfg.compute_dtype)
    if prompt is None and audio:
        prompt = torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                             device=device)
    elif prompt is None:
        prompt = torch.randint(1, cfg.vocab_size, (batch, prompt_len),
                               generator=gen, device=device)
    cache = lm.init_cache(cfg, batch, max_len, device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = lm.decode_scan(params, cfg, cache, prompt)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    tok = _select(logits, greedy, gen)
    toks = []
    t0 = time.perf_counter()
    for _ in range(gen_len):
        step_in = one_hot(tok, cfg.d_model)[:, None] if audio \
            else tok[:, None]
        logits, cache = lm.decode_step(params, cfg, cache, step_in)
        tok = _select(logits, greedy, gen)
        toks.append(tok)
    tokens = torch.stack(toks, dim=1)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": tokens, "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tok_per_s": batch * gen_len / max(decode_s, 1e-9)}


def serve_continuous(arch: str, *, lanes: int = 4, requests: int = 8,
                     prompt_len: int = 8, gen_len: int = 16,
                     max_len: int = 128, use_reduced: bool = True,
                     seed: int = 0, greedy: bool = True, device="cuda",
                     num_layers: int = None):
    """Serve ``requests`` synthetic single-request users of ``arch``
    (`config`) through the continuous-batching engine; see
    `_serve_continuous`. An audio config raises NotImplementedError (the
    engine feeds token ids)."""
    cfg = config(arch, use_reduced, num_layers)
    return _serve_continuous(cfg, lanes=lanes, requests=requests,
                             prompt_len=prompt_len, gen_len=gen_len,
                             max_len=max_len, seed=seed, greedy=greedy,
                             device=device)


def _serve_continuous(cfg, *, lanes, requests, prompt_len, gen_len,
                      max_len, seed, greedy=True, device="cuda",
                      params=None):
    """User i sends prompt_len tokens in [1, V) from ``seed``'s numpy
    generator (as the JAX package's draws them) and asks for gen_len
    tokens, sampled with seed i unless ``greedy``. ``params`` defaults to
    weights from ``seed``. Returns {"results", "wall_s", "steps",
    "tok_per_s"}."""
    from repro_torch.launch.engine import Request, ServeEngine

    rng = np.random.default_rng(seed)
    eng = ServeEngine(cfg, lanes=lanes, max_len=max_len, param_seed=seed,
                      params=params, device=device)
    t0 = time.time()
    results = eng.run([
        Request(user=f"user{i}",
                prompt=rng.integers(1, cfg.vocab_size, prompt_len).tolist(),
                max_new_tokens=gen_len, greedy=greedy, sample_seed=i)
        for i in range(requests)])
    wall = time.time() - t0
    total = sum(len(r["tokens"]) for r in results)
    return {"results": results, "wall_s": wall, "steps": eng.steps,
            "tok_per_s": total / max(wall, 1e-9)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_7b_sam")
    ap.add_argument("--batch", type=int, default=4,
                    help="static-batch size / engine lane count")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample", action="store_true",
                    help="categorical sampling instead of argmax")
    ap.add_argument("--full", action="store_true",
                    help="the published width (default: the reduced config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first LAYERS layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(launch/engine) instead of the static batch")
    ap.add_argument("--requests", type=int, default=8,
                    help="request count for --continuous")
    args = ap.parse_args()
    if args.continuous:
        res = serve_continuous(
            args.arch, lanes=args.batch, requests=args.requests,
            prompt_len=args.prompt_len, gen_len=args.gen_len,
            max_len=args.max_len, use_reduced=not args.full, seed=args.seed,
            greedy=not args.sample, device=args.device,
            num_layers=args.layers)
        print(f"served {len(res['results'])} requests in {res['steps']} "
              f"steps; {res['tok_per_s']:.1f} tok/s")
        return
    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen_len, max_len=args.max_len,
                use_reduced=not args.full, seed=args.seed,
                greedy=not args.sample, device=args.device,
                num_layers=args.layers)
    print(f"generated {tuple(res['tokens'].shape)} tokens; "
          f"prefill {res['prefill_s']:.2f}s, "
          f"decode {res['decode_tok_per_s']:.1f} tok/s")


if __name__ == "__main__":
    main()
