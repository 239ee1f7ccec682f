"""Architecture registry of the port, the JAX package's `configs/`.

``get_config(name)`` returns the published config (a ``_sam`` suffix adds
the default `MemoryLayerConfig`); ``reduced(cfg)`` a test-sized config of
the same family. The port runs StarCoder2-7B (causal, GELU MLP),
H2O-Danube3-4B (sliding window, gated SiLU MLP, head dim 120),
PaliGemma-3B (prefix-LM over a stubbed vision prefix, MQA with pad heads,
GeGLU MLP, head dim 256, tied embeddings), DeepSeek-V2-236B (MLA, a
dense first layer, then MoE layers) and Llama-4 Maverick (GQA with 40
heads padded to 48 over 8, MoE layers of 128 experts, top-1, one shared
expert, no dense layer), MusicGen-medium (the stubbed audio frontend:
frame embeddings in place of tokens; 24 MHA heads at head dim 64 padded
to 48, the GELU MLP), RWKV-6 7B (the attention-free RWKV block:
time-mix with a data-dependent decay, squared-ReLU channel-mix) and
Hymba-1.5B (the hybrid block: sliding-window GQA with 25 heads padded to
80 over 5 and a Mamba-style selective SSM on the same normed input,
averaged; the gated SiLU MLP). Yi-34B and Mistral-Large-123B, which need
more than one card, raise, naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import MemoryLayerConfig, ModelConfig

ARCH_IDS = (
    "rwkv6_7b",
    "starcoder2_7b",
    "yi_34b",
    "h2o_danube_3_4b",
    "mistral_large_123b",
    "musicgen_medium",
    "deepseek_v2_236b",
    "llama4_maverick_400b_a17b",
    "paligemma_3b",
    "hymba_1_5b",
)
PORTED = ("starcoder2_7b", "h2o_danube_3_4b", "paligemma_3b",
          "deepseek_v2_236b", "llama4_maverick_400b_a17b", "musicgen_medium",
          "rwkv6_7b", "hymba_1_5b")
# What each architecture the port does not run yet needs (ROADMAP §A).
NOT_PORTED = {
    "yi_34b": "A9c (dense GQA like StarCoder2, but 34B parameters need "
              "more than one H100; its registry entry comes with A9c)",
    "mistral_large_123b": "A9c (dense GQA, 123B parameters: more than one "
                          "H100)",
}


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name.endswith("_sam"):
        base = get_config(name[:-4])
        return dataclasses.replace(base, memory=MemoryLayerConfig())
    if name in NOT_PORTED:
        raise ValueError(f"{name} is not ported yet: ROADMAP item "
                         f"{NOT_PORTED[name]}")
    if name not in PORTED:
        raise ValueError(f"unknown architecture {name!r}: expected one of "
                         f"{ARCH_IDS}, optionally with '_sam'")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Test-sized config of the same family (`repro/configs/__init__.py::
    reduced` for the families the port runs): 2 layers, d 128, 4 heads
    over 2 kv heads, head_dim 32, no head padding, a window of 32 where
    the config has one, a vision prefix of 16 (``frontend_len`` and
    ``prefix_lm``) where it has one; 4 experts of 64, top-2 (or fewer), at
    most one dense layer where it has MoE; MLA's kv_lora 32, q_lora 48,
    rope 16, nope 32, v 32 where it has MLA; RWKV's head_size 32,
    decay_lora 16 and mix_lora 8 where it has RWKV; the SSM's state_size 8
    and dt_rank 16 where it has one; and a memory of 64
    slots of 16 with K = 4, a memory group per layer and segments of
    32."""
    kw = dict(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, q_block=64, kv_block=64, loss_chunk=64,
        remat=False, pad_head_groups=None)
    if cfg.window is not None:
        kw["window"] = 32
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(2, cfg.moe.top_k), d_expert=64,
            num_dense_layers=min(1, cfg.moe.num_dense_layers))
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora=32, q_lora=48, rope_head_dim=16,
            nope_head_dim=32, v_head_dim=32)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_size=32,
                                         decay_lora=16, mix_lora=8)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_size=8, dt_rank=16)
    if cfg.frontend == "vision":
        kw["frontend_len"] = 16
        kw["prefix_lm"] = 16
    if cfg.memory is not None:
        kw["memory"] = dataclasses.replace(
            cfg.memory, num_slots=64, word_size=16, k=4, every_n_layers=1,
            segment=32)
    return dataclasses.replace(cfg, **kw)
