"""RWKV-6 "Finch" 7B — attention-free, data-dependent decay.
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b]
32L, d_model=4096, d_ff=14336 (channel-mix), vocab=65536, head_size=64."""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6_7b",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # d_model / head_size
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block="rwkv",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    act="relu_sq",           # channel-mix uses squared ReLU internally
)
