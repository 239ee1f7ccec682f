"""MusicGen-medium — decoder-only over EnCodec tokens (audio frontend
STUBBED: the batch carries precomputed frame embeddings).
[arXiv:2306.05284; hf:facebook/musicgen-medium]
48L, d_model=1536, 24H, kv=24 (MHA), d_ff=6144, vocab=2048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_medium",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    frontend="audio",        # EnCodec frame embeddings come from the stub
    pad_head_groups=2,       # 24 MHA heads -> 48 padded (dead heads)
)
