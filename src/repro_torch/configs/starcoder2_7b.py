"""StarCoder2-7B — dense GQA (kv=4), RoPE, GELU FFN.
[arXiv:2402.19173; hf:bigcode/starcoder2-7b]
32L, d_model=4608, 36H, kv=4, d_ff=18432, vocab=49152."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    act="gelu",              # non-gated GELU FFN
    rope_theta=1e5,
    pad_head_groups=12,      # 36H -> 48 q-heads in 4 groups of 12, 9 real
)
