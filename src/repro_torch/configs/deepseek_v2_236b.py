"""DeepSeek-V2 (236B, 21B active) — MLA (kv_lora=512) + MoE 160e top-6 with
2 shared experts; first layer dense.
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2]
60L, d_model=5120, 128H, d_expert=1536, vocab=102400.

The published config, as the JAX package's. Its 236 B parameters (472 GB
in bf16) do not fit one H100: the port serves it on one card at full
width with its depth cut to the first 4 of 60 layers (the dense layer 0
and 3 MoE layers: 13.3 B parameters, 26.6 GB in bf16), as
``dataclasses.replace(CONFIG, num_layers=4)``."""
from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek_v2_236b",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,        # MLA: no separate KV heads; kept for bookkeeping
    head_dim=192,            # nope (128) + rope (64)
    d_ff=12288,              # the dense first layer's FFN
    vocab_size=102400,
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                  shared_experts=2, num_dense_layers=1),
    act="silu",
)
