"""Llama-4 Maverick (400B total, 17B active) — MoE 128 routed experts top-1
plus one shared expert, GQA kv=8, early-fusion multimodal (text path here).
[hf:meta-llama/Llama-4-Scout-17B-16E (series); unverified]
48L, d_model=5120, 40H, kv=8, d_ff=8192, vocab=202048.

The published config, as the JAX package's, with what JAX's has and
nothing more (no chunked attention, QK-norm or interleaved dense layers).
Its 48 layers (784.8 B parameters, 1.57 TB in bf16) do not fit one H100: the port serves it on
one card at full width with its depth cut to the first 2 of 48 layers
(two MoE layers: 34.7 B parameters, 69.4 GB in bf16), as
``dataclasses.replace(CONFIG, num_layers=2)``."""
from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b_a17b",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, d_expert=8192,
                  shared_experts=1, num_dense_layers=0),
    act="silu",
    rope_theta=5e5,
    pad_head_groups=6,    # 40H -> 48 padded q-heads
)
