"""Transformer block of the LM, the JAX package's `models/transformer.py`
for ``block="dense"``, ``"rwkv"`` and ``"hybrid"``. A dense block is
pre-norm attention (GQA: causal, within a sliding window, or over a
bidirectional prefix; or DeepSeek-V2's MLA) and an MLP (GELU, gated SiLU
or GeGLU) or a mixture of experts, each added to the residual stream; its
parameter tree says which it runs: ``"moe"`` or ``"mlp"`` (JAX's
``moe_layer`` flag: a MoE config's leading dense layers hold an MLP). A
hybrid block (Hymba's) runs the selective SSM (`models/ssm.py`, d_inner =
expand·d // 2) beside the attention on the same normed input and adds
the mean of the two; its decode carries the SSM's conv and state in the
cache beside k and v. An RWKV block (`models/rwkv.py`) is the pre-norm
time-mix and channel-mix; its prefill starts from zero shift and WKV
states, its decode carries them in the cache, {tm_shift, wkv, cm_shift}.
A GQA config with ``sparse_decode_blocks`` and no window decodes through
`attention.gqa_decode_sparse`, its cache holding the per-block key sums
``ksum``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_defs, pdef, rms_norm


def require_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a family the port runs: ``block="dense"``
    with causal, sliding-window or prefix-LM GQA or MLA, the GELU, gated
    SiLU or GeGLU MLP or MoE, ``block="hybrid"`` with an SSM and the gated
    SiLU MLP, or ``block="rwkv"`` with its squared-ReLU channel-mix; no
    frontend, or the (stubbed) vision or audio one."""
    rwkv = cfg.block == "rwkv"
    hybrid = cfg.block == "hybrid"
    unported = (
        (cfg.block not in ("dense", "rwkv", "hybrid"),
         f"block={cfg.block!r}"),
        (not rwkv and cfg.act not in ("gelu", "silu", "geglu"),
         f"the {cfg.act} MLP"),
        (rwkv and cfg.act != "relu_sq",
         f"the RWKV block with act={cfg.act!r}"),
        (hybrid and (cfg.act != "silu" or cfg.ssm is None
                     or cfg.mla is not None),
         f"the hybrid block with act={cfg.act!r}, ssm={cfg.ssm}, "
         f"mla={cfg.mla}"),
        (cfg.frontend not in (None, "vision", "audio"),
         f"the {cfg.frontend} frontend"),
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
    if cfg.block == "rwkv":
        return {**rwkv_lib.rwkv_defs(cfg), "ln1": pdef((d,), init="zeros"),
                "ln2": pdef((d,), init="zeros")}
    defs = {"ln1": pdef((d,), init="zeros"), "ln2": pdef((d,), init="zeros"),
            "attn": attn.attn_defs(cfg)}
    if cfg.moe is not None if moe_layer is None else moe_layer:
        defs["moe"] = moe_lib.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(d, cfg.d_ff,
                               gated=cfg.act in ("silu", "geglu"))
    if cfg.block == "hybrid":
        defs["ssm"] = ssm_lib.ssm_defs(cfg, _d_inner(cfg))
    return defs


def _d_inner(cfg: ModelConfig) -> int:
    """The hybrid block's SSM width: the attention and the SSM heads run
    in parallel at half the expanded width each."""
    return cfg.ssm.expand * cfg.d_model // 2


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
    router's in a MoE block, else 0), as JAX's. An RWKV block starts from
    zero states and drops the ones it ends with, as JAX's; so does a hybrid
    block's SSM."""
    if cfg.block == "rwkv":
        B, _, d = x.shape
        D = cfg.rwkv.head_size
        shift0 = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        wkv0 = torch.zeros((B, d // D, D, D), dtype=torch.float32,
                           device=x.device)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + rwkv_lib.time_mix(p["tm"], cfg, h, shift0, wkv0)[0]
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + rwkv_lib.channel_mix(p["cm"], cfg, h, shift0)[0]
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a = _attention(p, cfg, h, positions)
    if cfg.block == "hybrid":
        a = 0.5 * (a + ssm_lib.ssm_apply(p["ssm"], cfg, h)[0])
    x = x + a
    f, aux = _ffn(p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + f, aux


def block_decode(p, cfg: ModelConfig, x: torch.Tensor, cache, pos):
    """One token through one block: x (B, 1, d), ``cache`` this layer's
    {"k", "v"} (and "ksum" with the sparse decode, "conv" and "ssm" in a
    hybrid block), MLA's {"ckv"} or RWKV's {"tm_shift", "wkv",
    "cm_shift"} (updated in place), pos () or (B,) (an RWKV block reads
    none; the sparse decode takes ()). Returns (x, cache)."""
    if cfg.block == "rwkv":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        tm_out, tm_shift, wkv = rwkv_lib.time_mix(
            p["tm"], cfg, h, cache["tm_shift"], cache["wkv"],
            fixed_order=True)
        x = x + tm_out
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        cm_out, cm_shift = rwkv_lib.channel_mix(p["cm"], cfg, h,
                                                cache["cm_shift"])
        for key, new in (("tm_shift", tm_shift), ("wkv", wkv),
                         ("cm_shift", cm_shift)):
            cache[key].copy_(new)
        return x + cm_out, cache
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, ckv = attn.mla_decode(p["attn"], cfg, h, cache["ckv"], pos)
        new_cache = dict(cache, ckv=ckv)
    elif _sparse(cfg):
        a, kc, vc, ks = attn.gqa_decode_sparse(
            p["attn"], cfg, h, cache["k"], cache["v"], cache["ksum"], pos)
        new_cache = dict(cache, k=kc, v=vc, ksum=ks)
    else:
        a, kc, vc = attn.gqa_decode(p["attn"], cfg, h, cache["k"],
                                    cache["v"], pos)
        new_cache = dict(cache, k=kc, v=vc)
    if cfg.block == "hybrid":
        s_out, conv, state = ssm_lib.ssm_apply(
            p["ssm"], cfg, h, conv_state=cache["conv"],
            ssm_state=cache["ssm"], decode=True)
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(state)
        a = 0.5 * (a + s_out)
    x = x + a
    f, _ = _ffn(p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + f, new_cache


def _sparse(cfg: ModelConfig) -> bool:
    """Whether the decode is the sparse top-K block read (JAX's rule: a
    config with ``sparse_decode_blocks`` and no window)."""
    return cfg.sparse_decode_blocks is not None and cfg.window is None


def layer_cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """Cache shapes of one layer (the caller stacks a leading L): RWKV's
    states {"tm_shift", "cm_shift": (B, d), "wkv": (B, H, D, D)}, of no
    length; MLA's latent rows {"ckv": (B, max_len, kv_lora + rope)}; else
    {"k", "v"} of (B, Smax, Hkv, head_dim), Smax = max_len, or
    min(max_len, window) slots of a ring with a window; with the sparse
    decode "ksum" (B, max(1, Smax // block), Hkv, head_dim); in a hybrid
    block the SSM's "conv" (B, conv_width - 1, d_inner) and "ssm" (B,
    d_inner, state_size)."""
    require_supported(cfg)
    if cfg.block == "rwkv":
        return rwkv_lib.rwkv_state_shapes(cfg, batch)
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": (batch, max_len, m.kv_lora + m.rope_head_dim)}
    smax = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, smax, cfg.num_kv_heads, cfg.head_dim)
    shapes = {"k": shape, "v": shape}
    if _sparse(cfg):
        shapes["ksum"] = (batch, max(1, smax // cfg.sparse_decode_block),
                          cfg.num_kv_heads, cfg.head_dim)
    if cfg.block == "hybrid":
        d_inner = _d_inner(cfg)
        shapes["conv"] = (batch, cfg.ssm.conv_width - 1, d_inner)
        shapes["ssm"] = (batch, d_inner, cfg.ssm.state_size)
    return shapes
