"""Batched serving: decode a static batch of requests against a KV cache,
the port of the JAX package's `examples/serve_batched.py`, for the
families the port runs (StarCoder2-7B, H2O-Danube3-4B with its sliding
window and ring cache, PaliGemma-3B served with token prompts as JAX
serves it, DeepSeek-V2 with MLA and MoE, Llama-4 Maverick with pad heads
over top-1 MoE, MusicGen-medium on frame embeddings, each chosen token
fed back as a one-hot frame, RWKV-6 7B with its O(1) decode state, and
Hymba-1.5B with its hybrid attention and SSM blocks). Another
architecture raises the registry's error, naming the ROADMAP item that
ports it.

    python -m repro_torch.examples.serve_batched --full
    python -m repro_torch.examples.serve_batched --arch h2o_danube_3_4b --full
    python -m repro_torch.examples.serve_batched --arch paligemma_3b --full
    python -m repro_torch.examples.serve_batched --arch deepseek_v2_236b \
        --full --layers 4
    python -m repro_torch.examples.serve_batched \
        --arch llama4_maverick_400b_a17b_sam --full --layers 2
    python -m repro_torch.examples.serve_batched --arch musicgen_medium \
        --full
    python -m repro_torch.examples.serve_batched --arch rwkv6_7b_sam --full
    python -m repro_torch.examples.serve_batched --arch hymba_1_5b_sam --full
    python -m repro_torch.examples.serve_batched --device cpu

serve the published width on the card (the default device; DeepSeek-V2's
60 layers and Llama-4's 48 need more than one card: ``--layers 4`` and
``--layers 2`` keep the first 4 and 2) or the reduced config on the
host.
"""
import argparse

from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published width (default: the reduced config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first LAYERS layers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen_len, max_len=args.prompt_len + args.gen_len,
                use_reduced=not args.full, device=args.device,
                num_layers=args.layers)
    print(f"[{args.arch}] generated {res['tokens'].shape[1]} tokens for "
          f"{res['tokens'].shape[0]} requests")
    print(f"prefill: {res['prefill_s']:.2f}s  "
          f"decode: {res['decode_tok_per_s']:.1f} tok/s ({args.device})")
    print("sample token ids:", res["tokens"][0][:10].tolist())


if __name__ == "__main__":
    main()
