"""Attention of the LM, the dense-GQA part of the JAX package's
`models/attention.py`: the training/prefill attention (`gqa_forward`,
through the causal attention kernel, `ops.flash_attention`, whose
backward is plain PyTorch in blocks of ``cfg.q_block`` query rows), the
single-token decode against a KV cache (`gqa_decode`, plain PyTorch, as
the JAX package computes it outside any kernel). Where the JAX forward
runs its jnp chunked online softmax (`chunked_attention`), the port runs
the kernel; the kernel's plain version is `kernels/ref.flash_attention_ref`.

A config with a prefix-LM (``cfg.prefix_lm``, PaliGemma's image prefix)
passes it to the kernel: every query of the prefill sees the keys below
it. The decode has no prefix, as JAX's has none: it attends causally over
the cache. A config with a sliding window (``cfg.window``, H2O-Danube3)
passes it to the kernel, and its decode cache is a ring of Smax =
min(max_len, window) slots (`models/transformer.py::layer_cache_shapes`):
position p writes slot p % Smax, and once p reaches Smax every slot is
valid. So the decode attends to the last Smax tokens, the prefill to the
last ``window``: with max_len < window the two differ, in JAX as here
(ROADMAP §C).

Layouts are the JAX package's: q (B, S, H, D), k and v (B, S, Hkv, D),
caches (B, Smax, Hkv, D). With ``cfg.pad_head_groups`` each kv head's
group is padded to that many query heads (PaliGemma: 8 heads over one kv
head padded to 16), which are computed and then zeroed by the head mask,
as in JAX. MLA is not ported (ROADMAP A9c): `models/transformer.py`
refuses such configs."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import pdef, peinsum, rope

_NEG = -1e30


def attn_defs(cfg: ModelConfig):
    d, Hkv, Dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    Hp = cfg.padded_heads    # dead pad heads: computed, then masked
    return {"wq": pdef((d, Hp, Dh)), "wk": pdef((d, Hkv, Dh)),
            "wv": pdef((d, Hkv, Dh)), "wo": pdef((Hp, Dh, d))}


def _head_mask(cfg: ModelConfig, dtype, device) -> Optional[torch.Tensor]:
    """(H_pad,) 1/0 mask of the real heads; each of the Hkv groups of
    ``pad_head_groups`` q-heads keeps its first H/Hkv."""
    if cfg.pad_head_groups is None:
        return None
    valid = torch.arange(cfg.pad_head_groups, device=device) \
        < cfg.q_heads_per_kv
    return valid.repeat(cfg.num_kv_heads).to(dtype)


def gqa_forward(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the training/prefill attention, causal
    within ``cfg.window`` when the config has one, every query seeing the
    first ``cfg.prefix_lm`` keys, through `ops.flash_attention` (the
    kernel on the card). S must be a
    multiple of min(q_block, S) and of min(kv_block, S), as the JAX
    package's chunked attention requires."""
    S = x.shape[1]
    qb, kb = min(cfg.q_block, S), min(cfg.kv_block, S)
    if S % qb or S % kb:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"attention blocks ({qb}, {kb})")
    q = peinsum("bsd,dhk->bshk", x, params["wq"])
    k = peinsum("bsd,dhk->bshk", x, params["wk"])
    v = peinsum("bsd,dhk->bshk", x, params["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, q_block=qb, window=cfg.window,
                            prefix=cfg.prefix_lm)
    mask = _head_mask(cfg, o.dtype, o.device)
    if mask is not None:
        o = o * mask[None, None, :, None]
    return peinsum("bshk,hkd->bsd", o, params["wo"])


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor, ring: bool) -> None:
    """Write new (B, 1, Hkv, D) at position ``pos`` of cache (B, Smax, Hkv,
    D), in place. A ``ring`` (a windowed config) writes slot pos % Smax
    for every lane. Otherwise a () position past the end writes the last
    slot (JAX's ``dynamic_update_slice`` clamps) and a lane whose (B,)
    position lies past the end keeps its cache (JAX's scatter drops it).
    No host sync."""
    B, Smax = cache.shape[:2]
    b = torch.arange(B, device=cache.device)
    new = new[:, 0].to(cache.dtype)
    if ring:
        cache[b, (pos % Smax).expand(B)] = new
        return
    if pos.dim() == 0:
        cache[b, pos.clamp(max=Smax - 1).expand(B)] = new
        return
    keep = (pos < Smax)[:, None, None]
    slot = pos.clamp(max=Smax - 1)
    cache[b, slot] = torch.where(keep, new, cache[b, slot])


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis in a fixed pairwise order: halves added
    elementwise until one value is left (a zero pad makes an odd length
    even). Every output element is then the same sum of the same terms
    whatever the other axes hold."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def gqa_decode(params, cfg: ModelConfig, x: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: torch.Tensor):
    """x: (B, 1, d); caches (B, Smax, Hkv, D). ``pos`` is a () int tensor
    for a lockstep batch or (B,) per-lane positions (each lane its own
    rope phase, cache slot and validity horizon). The caches are updated
    in place (JAX returns new ones). With ``cfg.window`` the caches are
    rings: slot pos % Smax, and every slot valid once pos >= Smax (JAX's
    `gqa_decode`). Returns (out (B, 1, d), k_cache, v_cache)."""
    B = x.shape[0]
    Smax = k_cache.shape[1]
    q = peinsum("bsd,dhk->bshk", x, params["wq"])
    k = peinsum("bsd,dhk->bshk", x, params["wk"])
    v = peinsum("bsd,dhk->bshk", x, params["wv"])
    ppos = pos.reshape(1, 1) if pos.dim() == 0 else pos[:, None]
    q = rope(q, ppos, cfg.rope_theta)
    k = rope(k, ppos, cfg.rope_theta)
    ring = cfg.window is not None
    _cache_write(k_cache, k, pos, ring)
    _cache_write(v_cache, v, pos, ring)

    H, Hkv = cfg.padded_heads, cfg.num_kv_heads
    qg = q.reshape(B, Hkv, H // Hkv, 1, -1).float()
    # Both products sum in a fixed order (`_tree_sum`), so a lane's bits
    # do not depend on how many lanes the batch holds; a batched GEMM may
    # pick another kernel, and another order, for another batch.
    s = _tree_sum(qg * k_cache.float().permute(0, 2, 1, 3)[:, :, None]) \
        * (q.shape[-1] ** -0.5)
    idx = torch.arange(Smax, device=x.device)
    if ring:
        valid = (idx <= (pos % Smax)[..., None]) | (pos[..., None] >= Smax)
    else:
        valid = idx <= pos[..., None]
    valid = valid.expand(B, Smax)
    s = torch.where(valid[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = _tree_sum(p[:, :, :, None, :]
                  * v_cache.float().permute(0, 2, 3, 1)[:, :, None])
    o = o.reshape(B, 1, H, -1).to(x.dtype)
    mask = _head_mask(cfg, o.dtype, o.device)
    if mask is not None:
        o = o * mask[None, None, :, None]
    return peinsum("bshk,hkd->bsd", o, params["wo"]), k_cache, v_cache
