"""Model configuration of the LM, the JAX package's `models/config.py`
field for field.

One `ModelConfig` describes every architecture of the registry
(`repro_torch.configs`). The port's model code runs ``block="dense"``:
GQA attention (causal, windowed or prefix-LM, the vision frontend's patch
embeddings or the audio frontend's frame embeddings) or DeepSeek-V2's
MLA, each with an MLP or, with ``moe``, the mixture of experts after
``num_dense_layers`` dense layers; ``block="rwkv"`` with ``rwkv``'s
RWKV-6 block; and ``block="hybrid"``, GQA beside ``ssm``'s selective SSM
(`models/ssm.py`); with the optional SAM memory layer on f32 rows. With
``sparse_decode_blocks`` a GQA config without a window decodes through
the top-K block read of the KV cache (`attention.gqa_decode_sparse`)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora: int = 512
    q_lora: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    absorb: bool = False     # read by neither package: the decode absorbs


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    shared_experts: int = 0
    num_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    gate_lora: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 16
    expand: int = 2
    dt_rank: int = 64
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class MemoryLayerConfig:
    """SAM external memory attached to the LM: every `every_n_layers`-th
    block is followed by a sparse top-K read (§3.1) and a write to
    {previously read ∪ LRA} rows (§3.2) of a per-sequence (B, N+1, W)
    memory. The JAX field ``backend`` has no counterpart (the port
    dispatches by device). In training the segments run through the
    unroll engine in ``unroll_mode`` (naive, sparse or chunked, with
    ``unroll_chunk``). ``mem_dtype`` other than 'float32' is carried as
    data: the LM layer runs f32 rows (ROADMAP A9c)."""
    num_slots: int = 65536
    word_size: int = 128
    num_heads: int = 4
    k: int = 8
    every_n_layers: int = 4
    delta: float = 0.005
    segment: int = 512
    mem_dtype: str = "float32"
    unroll_mode: str = "sparse"
    unroll_chunk: "int | None" = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    block: str = "dense"            # dense | moe | rwkv | hybrid
    window: Optional[int] = None    # sliding-window attention
    prefix_lm: int = 0              # bidirectional prefix length (VLM)
    rope_theta: float = 10000.0
    act: str = "silu"               # silu (gated) | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    rwkv: Optional[RWKVConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[str] = None  # 'audio' | 'vision' (stubbed embeddings)
    frontend_len: int = 0
    memory: Optional[MemoryLayerConfig] = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    q_block: int = 512              # the attention's block sizes: S must be
    kv_block: int = 512             # a multiple of min(block, S)
    loss_chunk: int = 512
    causal_skip: bool = True
    sparse_decode_blocks: Optional[int] = None
    sparse_decode_block: int = 64
    # Pad each GQA head group to this many q-heads (dead heads: computed,
    # then zeroed by the head mask). None = no padding.
    pad_head_groups: Optional[int] = None

    @property
    def padded_heads(self) -> int:
        if self.pad_head_groups is None:
            return self.num_heads
        return self.num_kv_heads * self.pad_head_groups

    @property
    def q_heads_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads
