"""Transformer block of the LM, the JAX package's `models/transformer.py`
for ``block="dense"``: pre-norm GQA attention (causal, within a sliding
window, or over a bidirectional prefix) and an MLP (GELU, gated SiLU or
GeGLU), each added to the residual stream. Any other family raises,
naming its ROADMAP item."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_defs, pdef, rms_norm


def require_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense GQA family the port runs: causal,
    sliding-window or prefix-LM attention, the GELU, gated SiLU or GeGLU
    MLP, no frontend or the (stubbed) vision one."""
    unported = (
        (cfg.block != "dense", f"block={cfg.block!r}"),
        (cfg.act not in ("gelu", "silu", "geglu"), f"the {cfg.act} MLP"),
        (cfg.mla is not None, "MLA"),
        (cfg.moe is not None, "MoE"),
        (cfg.frontend not in (None, "vision"), f"the {cfg.frontend} "
                                               f"frontend"),
        (cfg.sparse_decode_blocks is not None,
         "the sparse top-K decode (gqa_decode_sparse)"),
    )
    for flag, what in unported:
        if flag:
            raise ValueError(f"{cfg.name}: {what} is not ported yet "
                             f"(ROADMAP item A9c)")


def block_defs(cfg: ModelConfig):
    """Parameter defs of one dense block."""
    require_supported(cfg)
    d = cfg.d_model
    return {"ln1": pdef((d,), init="zeros"), "ln2": pdef((d,), init="zeros"),
            "attn": attn.attn_defs(cfg),
            "mlp": mlp_defs(d, cfg.d_ff,
                            gated=cfg.act in ("silu", "geglu"))}


def block_forward(p, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Prefill of one block, x (B, S, d) -> (B, S, d). (JAX also returns
    an auxiliary loss, which only MoE blocks make.)"""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_forward(p["attn"], cfg, h, positions)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.act)


def block_decode(p, cfg: ModelConfig, x: torch.Tensor, cache, pos):
    """One token through one block: x (B, 1, d), ``cache`` this layer's
    {"k", "v"} (updated in place), pos () or (B,). Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, kc, vc = attn.gqa_decode(p["attn"], cfg, h, cache["k"], cache["v"],
                                pos)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.act), dict(cache, k=kc, v=vc)


def layer_cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Cache shapes of one layer (the caller stacks a leading L): Smax =
    max_len, or min(max_len, window) slots of a ring with a window."""
    require_supported(cfg)
    smax = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, smax, cfg.num_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}
