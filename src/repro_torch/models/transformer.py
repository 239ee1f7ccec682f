"""Transformer block of the LM, the JAX package's `models/transformer.py`
for ``block="dense"``: pre-norm attention (GQA: causal, within a sliding
window, or over a bidirectional prefix; or DeepSeek-V2's MLA) and an MLP
(GELU, gated SiLU or GeGLU) or a mixture of experts, each added to the
residual stream. A block's parameter tree says which it runs: ``"moe"``
or ``"mlp"`` (JAX's ``moe_layer`` flag: a MoE config's leading dense
layers hold an MLP). Any other family raises, naming its ROADMAP item."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_defs, pdef, rms_norm


def require_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a family the port runs: ``block="dense"``
    with causal, sliding-window or prefix-LM GQA or MLA, the GELU, gated
    SiLU or GeGLU MLP or MoE, no frontend or the (stubbed) vision one."""
    unported = (
        (cfg.block != "dense", f"block={cfg.block!r}"),
        (cfg.act not in ("gelu", "silu", "geglu"), f"the {cfg.act} MLP"),
        (cfg.frontend not in (None, "vision"), f"the {cfg.frontend} "
                                               f"frontend"),
        (cfg.sparse_decode_blocks is not None,
         "the sparse top-K decode (gqa_decode_sparse)"),
    )
    for flag, what in unported:
        if flag:
            raise ValueError(f"{cfg.name}: {what} is not ported yet "
                             f"(ROADMAP item A9c)")


def block_defs(cfg: ModelConfig, *, moe_layer: Optional[bool] = None):
    """Parameter defs of one block; ``moe_layer`` overrides whether it
    holds the mixture of experts (default: where the config has one)."""
    require_supported(cfg)
    d = cfg.d_model
    defs = {"ln1": pdef((d,), init="zeros"), "ln2": pdef((d,), init="zeros"),
            "attn": attn.attn_defs(cfg)}
    if cfg.moe is not None if moe_layer is None else moe_layer:
        defs["moe"] = moe_lib.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(d, cfg.d_ff,
                               gated=cfg.act in ("silu", "geglu"))
    return defs


def _attention(p, cfg: ModelConfig, h, positions):
    if cfg.mla is not None:
        return attn.mla_forward(p["attn"], cfg, h, positions)
    return attn.gqa_forward(p["attn"], cfg, h, positions)


def _ffn(p, cfg: ModelConfig, h):
    """(the MLP's or the experts' output, the router's aux loss or 0)."""
    if "moe" in p:
        return moe_lib.moe_apply(p["moe"], cfg, h, cfg.act)
    return mlp_apply(p["mlp"], h, cfg.act), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def block_forward(p, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor):
    """Prefill of one block, x (B, S, d) -> (x (B, S, d), the aux loss: the
    router's in a MoE block, else 0), as JAX's."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _attention(p, cfg, h, positions)
    f, aux = _ffn(p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + f, aux


def block_decode(p, cfg: ModelConfig, x: torch.Tensor, cache, pos):
    """One token through one block: x (B, 1, d), ``cache`` this layer's
    {"k", "v"} or MLA's {"ckv"} (updated in place), pos () or (B,).
    Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, ckv = attn.mla_decode(p["attn"], cfg, h, cache["ckv"], pos)
        new_cache = dict(cache, ckv=ckv)
    else:
        a, kc, vc = attn.gqa_decode(p["attn"], cfg, h, cache["k"],
                                    cache["v"], pos)
        new_cache = dict(cache, k=kc, v=vc)
    x = x + a
    f, _ = _ffn(p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + f, new_cache


def layer_cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Cache shapes of one layer (the caller stacks a leading L): MLA's
    latent rows {"ckv": (B, max_len, kv_lora + rope)}; else {"k", "v"}
    of (B, Smax, Hkv, head_dim), Smax = max_len, or min(max_len, window)
    slots of a ring with a window."""
    require_supported(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": (batch, max_len, m.kv_lora + m.rope_head_dim)}
    smax = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, smax, cfg.num_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}
