"""Hymba-1.5B — hybrid-head blocks: attention and Mamba heads in parallel,
SWA on most layers, ssm_state=16.
[arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base]
32L, d_model=1600, 25H, kv=5, d_ff=5504, vocab=32001."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba_1_5b",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    block="hybrid",
    window=1024,             # hymba uses SWA for most layers
    ssm=SSMConfig(state_size=16, expand=2, dt_rank=100, conv_width=4),
    act="silu",
    pad_head_groups=16,      # 25 heads -> 80 padded q-heads (16 a kv head)
)
