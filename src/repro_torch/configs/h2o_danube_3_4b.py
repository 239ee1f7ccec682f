"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818 (danube series); unverified]
24L, d_model=3840, 32H, kv=8, d_ff=10240, vocab=32000, SWA window 4096."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o_danube_3_4b",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    window=4096,             # mistral-style SWA -> bounded decode state
    act="silu",
)
