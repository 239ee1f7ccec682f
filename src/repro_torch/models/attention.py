"""Attention of the LM, the dense-GQA part of the JAX package's
`models/attention.py`: the training/prefill attention (`gqa_forward`,
through the causal attention kernel, `ops.flash_attention`, whose
backward is plain PyTorch in blocks of ``cfg.q_block`` query rows), the
single-token decode against a KV cache (`gqa_decode`, plain PyTorch, as
the JAX package computes it outside any kernel). Where the JAX forward
runs its jnp chunked online softmax (`chunked_attention`), the port runs
the kernel; the kernel's plain version is `kernels/ref.flash_attention_ref`.
With ``cfg.sparse_decode_blocks`` the decode reads only the top blocks of
the cache by their key centroids (`gqa_decode_sparse`, plain PyTorch as
JAX's is plain JAX).

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
as in JAX.

DeepSeek-V2's multi-head latent attention (``cfg.mla``, JAX's
`_mla_qkv`, `mla_forward`, `mla_decode`): q comes from a q_lora-wide
latent, k and v from a kv_lora-wide one, and each head's q·k is its
nope_head_dim columns and rope_head_dim rotated ones, the latter shared
by all heads. The prefill (`mla_forward`) runs the attention kernel at
q·k nope + rope wide and v v_head_dim wide (192 and 128 at full width).
The decode (`mla_decode`) is the absorbed one: its cache holds the
normed latent and the rotated k columns, (B, Smax, kv_lora + rope), and
the scores are taken in the latent space (q_nope absorbed into wk_up);
plain PyTorch, as JAX computes it outside any kernel, its five products
summed in a fixed order (`_fixed_dot`)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import einsum, pdef, peinsum, rms_norm, rope

_NEG = -1e30
# Elements of f32 products `_fixed_dot` holds at once (256 MB).
_DOT_CHUNK = 1 << 26


def attn_defs(cfg: ModelConfig):
    d, Hkv, Dh = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m, H = cfg.mla, cfg.num_heads
        return {"wq_down": pdef((d, m.q_lora)),
                "q_norm": pdef((m.q_lora,), init="zeros"),
                "wq_up": pdef((m.q_lora, H,
                               m.nope_head_dim + m.rope_head_dim)),
                "wkv_down": pdef((d, m.kv_lora + m.rope_head_dim)),
                "kv_norm": pdef((m.kv_lora,), init="zeros"),
                "wk_up": pdef((m.kv_lora, H, m.nope_head_dim)),
                "wv_up": pdef((m.kv_lora, H, m.v_head_dim)),
                "wo": pdef((H, m.v_head_dim, d))}
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
    """Write new (B, 1, ...) at position ``pos`` of cache (B, Smax, ...):
    (Hkv, D) a head, or MLA's latent row. In place. A ``ring`` (a windowed
    config) writes slot pos % Smax
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
    keep = (pos < Smax).view((B,) + (1,) * (new.dim() - 1))
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


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of ``jax.lax.top_k(x, k)`` over the last axis: the k
    largest, largest first, the lower index first among equal values (a
    stable descending sort; `torch.topk` promises no order on ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def gqa_decode_sparse(params, cfg: ModelConfig, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      ksum: torch.Tensor, pos: torch.Tensor):
    """The top-K block decode, JAX's `gqa_decode_sparse`: SAM's sparse read
    applied to the KV cache. x (B, 1, d); caches (B, Smax, Hkv, D); ksum
    (B, nb, Hkv, D) the running key sum of each block of
    ``cfg.sparse_decode_block`` slots; pos a () int tensor (a lockstep
    batch: `lm.decode_step` refuses per-lane positions here, as JAX's).
    Plain PyTorch, as JAX's is plain JAX.

    The token's k and v are written at ``pos`` and its k added to its
    block's sum (in the cache dtype); each block's centroid, its sum over
    its written slots (at most bs, at least 1) in q's dtype, is scored
    against the query group (Σ over the group's heads and D); blocks past
    ``pos`` score ``_NEG`` and the current block gets +1e9, so it is
    always read; the top kb = min(sparse_decode_blocks, nb) blocks, in
    `lax.top_k`'s order (`top_k_indices`), are gathered and attended
    exactly over their slots at or below ``pos``. The scores, the
    softmax and the read are in q's dtype, the products summed in f32
    and rounded once. The caches and ksum are updated in place (JAX
    returns new ones). Returns (out (B, 1, d), k_cache, v_cache,
    ksum)."""
    B, Smax = x.shape[0], k_cache.shape[1]
    bs = cfg.sparse_decode_block
    nb = Smax // bs
    kb = min(cfg.sparse_decode_blocks, nb)
    H, Hkv, D = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    dev = x.device

    q = peinsum("bsd,dhk->bshk", x, params["wq"])
    k = peinsum("bsd,dhk->bshk", x, params["wk"])
    v = peinsum("bsd,dhk->bshk", x, params["wv"])
    q = rope(q, pos.reshape(1, 1), cfg.rope_theta)
    k = rope(k, pos.reshape(1, 1), cfg.rope_theta)
    _cache_write(k_cache, k, pos, ring=False)
    _cache_write(v_cache, v, pos, ring=False)
    # The written block's sum: JAX's gather clamps the block and its
    # scatter drops one past the end.
    b = torch.arange(B, device=dev)
    blk = pos // bs
    at = blk.clamp(max=ksum.shape[1] - 1).expand(B)
    upd = ksum[b, at] + k[:, 0].to(ksum.dtype)
    ksum[b, at] = torch.where(blk < ksum.shape[1], upd, ksum[b, at])

    qg = q.reshape(B, Hkv, H // Hkv, D)
    idx = torch.arange(nb, device=dev)
    counts = ((pos + 1) - idx * bs).clamp(0, bs).to(qg.dtype)
    cent = ksum[:, :nb].to(qg.dtype) / counts.clamp(min=1.0)[None, :, None,
                                                             None]
    bscore = torch.einsum("bhgd,bnhd->bhn", qg.float(),
                          cent.float()).to(qg.dtype)
    bscore = torch.where(idx <= blk, bscore, _NEG)
    bscore = bscore + (idx == blk).to(bscore.dtype) * 1e9
    top = top_k_indices(bscore, kb)                          # (B, Hkv, kb)

    sel = (top[..., None] * bs
           + torch.arange(bs, device=dev)).reshape(B, Hkv, kb * bs)
    bi = b[:, None, None]
    hi = torch.arange(Hkv, device=dev)[None, :, None]
    k_sel = k_cache[bi, sel, hi].to(qg.dtype)               # (B, Hkv, P, D)
    v_sel = v_cache[bi, sel, hi].to(qg.dtype)
    s = torch.einsum("bhgd,bhpd->bhgp", qg.float(),
                     k_sel.float()).to(qg.dtype) * (D ** -0.5)
    s = torch.where((sel <= pos)[:, :, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgp,bhpd->bhgd", p.float(), v_sel.float()).to(
        qg.dtype)
    o = o.reshape(B, 1, H, D).to(x.dtype)
    mask = _head_mask(cfg, o.dtype, o.device)
    if mask is not None:
        o = o * mask[None, None, :, None]
    return (peinsum("bshk,hkd->bsd", o, params["wo"]), k_cache, v_cache,
            ksum)


def gqa_decode_sparse_sharded(*args, **kwargs):
    """JAX's `gqa_decode_sparse_sharded`: the sparse decode with the cache
    sharded by sequence over a mesh. Not ported: raises."""
    raise ValueError("the sparse decode over a mesh (gqa_decode_sparse_"
                     "sharded) is not ported yet: ROADMAP item A11, item 4")


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# --------------------------------------------------------------------------

def _fixed_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis of a·b, broadcast, in f32 and `_tree_sum`'s
    order: every element the same sum of the same terms whatever the
    batch holds. Axis 1 (the heads) is taken a chunk at a time so the
    products never exceed _DOT_CHUNK elements."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    per = max(1, _DOT_CHUNK * shape[1] // math.prod(shape))
    parts = []
    for lo in range(0, shape[1], per):
        aa = a if a.shape[1] == 1 else a[:, lo:lo + per]
        bb = b if b.shape[1] == 1 else b[:, lo:lo + per]
        parts.append(_tree_sum(aa.float() * bb.float()))
    return torch.cat(parts, dim=1)


def _mla_qkv(params, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """JAX's `_mla_qkv`: x (B, S, d) -> q_nope (B, S, H, nope), q_rope (B,
    S, H, rope) rotated, the normed kv latent c (B, S, kv_lora) and k_rope
    (B, S, rope) rotated (through an added head axis)."""
    m = cfg.mla
    ql = rms_norm(einsum("bsd,dl->bsl", x, params["wq_down"]),
                  params["q_norm"], cfg.norm_eps)
    q = peinsum("bsl,lhk->bshk", ql, params["wq_up"])
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    ckv = einsum("bsd,dl->bsl", x, params["wkv_down"])
    c = rms_norm(ckv[..., :m.kv_lora], params["kv_norm"], cfg.norm_eps)
    k_rope = rope(ckv[:, :, None, m.kv_lora:], positions,
                  cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c, k_rope


def mla_forward(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the prefill, JAX's `mla_forward`. The
    heads' k is the up-projected latent's nope columns and the shared
    k_rope, broadcast over the H heads; the causal attention runs through
    `ops.flash_attention` at q·k nope + rope wide and v v_head_dim wide,
    scaled by (nope + rope)^-0.5. S must be a multiple of min(q_block, S)
    and of min(kv_block, S), as JAX's chunked attention requires."""
    m = cfg.mla
    B, S, _ = x.shape
    qb, kb = min(cfg.q_block, S), min(cfg.kv_block, S)
    if S % qb or S % kb:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"attention blocks ({qb}, {kb})")
    q_nope, q_rope, c, k_rope = _mla_qkv(params, cfg, x, positions)
    k_nope = peinsum("bsl,lhk->bshk", c, params["wk_up"])
    v = peinsum("bsl,lhk->bshk", c, params["wv_up"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, cfg.num_heads, m.rope_head_dim)], dim=-1)
    o = ops.flash_attention(q, k, v, q_block=qb)
    return peinsum("bshk,hkd->bsd", o, params["wo"])


def mla_decode(params, cfg: ModelConfig, x: torch.Tensor,
               ckv_cache: torch.Tensor, pos: torch.Tensor):
    """The absorbed decode, JAX's `mla_decode`: x (B, 1, d), the latent
    cache (B, Smax, kv_lora + rope), pos () or (B,) (each lane its own
    rope phase, slot and horizon). The token's normed latent and rotated
    k_rope are written at ``pos`` (in place; a () position past the end
    writes the last slot, a lane past it writes nothing, as JAX's update
    and scatter), the cache is read in x's dtype, q_nope is absorbed into
    wk_up (q_eff), and the scores q_eff·c + q_rope·k_rope, scaled by
    (nope + rope)^-0.5 and masked past ``pos``, weight the latent rows,
    which wv_up then wo project out. The five products over heads, cache
    and latent sum in a fixed order (`_fixed_dot`), so a lane's bits do
    not depend on how many lanes the batch holds. Returns (out (B, 1, d),
    ckv_cache)."""
    m = cfg.mla
    B, Smax = x.shape[0], ckv_cache.shape[1]
    ppos = pos.reshape(1, 1) if pos.dim() == 0 else pos[:, None]
    q_nope, q_rope, c, k_rope = _mla_qkv(params, cfg, x, ppos)
    _cache_write(ckv_cache, torch.cat([c, k_rope], dim=-1), pos, ring=False)
    cache = ckv_cache.to(x.dtype)
    c_all, kr_all = cache[..., :m.kv_lora], cache[..., m.kv_lora:]

    # q_eff (B, H, L) = q_nope · wk_upᵀ, emitted in q_nope's dtype.
    q_eff = _fixed_dot(q_nope[:, 0, :, None, :],
                       params["wk_up"].permute(1, 0, 2)[None]).to(
        q_nope.dtype)
    s = _fixed_dot(q_eff[:, :, None, :], c_all[:, None]) \
        + _fixed_dot(q_rope[:, 0, :, None, :], kr_all[:, None])
    s = s * (m.nope_head_dim + m.rope_head_dim) ** -0.5        # (B, H, T)
    valid = (torch.arange(Smax, device=x.device) <= pos[..., None]).expand(
        B, Smax)
    p = torch.softmax(torch.where(valid[:, None, :], s, _NEG), dim=-1)
    o_lat = _fixed_dot(p[:, :, None, :],
                       c_all.transpose(1, 2)[:, None]).to(x.dtype)
    o = _fixed_dot(o_lat[:, :, None, :],
                   params["wv_up"].permute(1, 2, 0)[None]).to(o_lat.dtype)
    return peinsum("bshk,hkd->bsd", o[:, None], params["wo"]), ckv_cache
