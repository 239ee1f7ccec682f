"""PaliGemma-3B — SigLIP vision frontend (STUBBED: the batch carries 256
patch embeddings) + Gemma-2B decoder with prefix-LM attention over the
image prefix. MQA (kv=1), GeGLU, head_dim 256.
[arXiv:2407.07726; hf:google/paligemma-3b-pt-224]
18L, d_model=2048, 8H, kv=1, d_ff=16384, vocab=257216."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma_3b",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="geglu",
    frontend="vision",
    frontend_len=256,        # SigLIP patch embeddings (stub)
    prefix_lm=256,           # bidirectional attention over the image prefix
    tie_embeddings=True,     # gemma ties input/output embeddings
    loss_chunk=256,          # 257k vocab: smaller CE chunks
    pad_head_groups=16,      # 8 MQA heads -> 16 padded (dead heads)
)
