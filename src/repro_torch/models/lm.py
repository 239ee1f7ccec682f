"""The top-level LM, the JAX package's `models/lm.py` for ``block="dense"``
(causal, sliding-window or prefix-LM GQA, or MLA; GELU, gated SiLU or
GeGLU MLP, or MoE after ``moe.num_dense_layers`` leading dense layers,
held apart as ``dense_blocks``; a stubbed vision frontend whose patch
embeddings the batch carries, or a stubbed audio frontend whose frame
embeddings take the tokens' place), ``block="hybrid"`` (Hymba's: the
windowed attention beside a selective SSM, whose decode cache holds the
SSM's conv and state beside k and v) and ``block="rwkv"`` (RWKV-6, whose
decode cache is its O(1) state): embeddings, the dense blocks, the stack of
blocks with a SAM memory layer after every group, the final norm and the
head (tied to the embeddings where the config says so). `forward`
and `loss_fn` train (under autograd, the blocks under
`torch.utils.checkpoint` with ``cfg.remat``, the memory layers through the
unroll engine); `prefill` (the full-sequence forward, whose attention is
the causal attention kernel) and `decode_step`/`decode_scan` against a KV
cache, with or without memory states, serve under inference mode.

Dtypes follow JAX: the weights are cast to the compute dtype per call
(`_cast`, a no-op on weights already held in it). A memory layer adds its
f32 reads to the stream, which promotes a bf16 stream to f32 after the
first memory group in `forward`/`prefill` (later blocks then run f32
activations against bf16 weights); `decode_step` casts the read back to
the stream's dtype. Caches and memory states are updated in place (JAX
returns new ones).

The layer grouping is JAX's, faults included (ROADMAP §C): with memory,
the n_dense leading dense blocks run first, then n_groups = max(1, L //
every_n_layers) groups of per = (L - n_dense) // n_groups of the other
blocks, so where per·n_groups < L - n_dense the trailing blocks run
nowhere (`paligemma_3b_sam`: 18 layers in 4 groups of 4, blocks 16 and 17
skipped; `deepseek_v2_236b_sam`: 60 layers, 1 dense and 15 groups of 3,
blocks 46-59 skipped; by `forward`, `prefill` and a `decode_step` with
memory states; a `decode_step` without memory states runs them all).
Llama-4's cut to 2 of 48 layers has no dense layer and one group (max(1,
2 // 4)) of both blocks, so none is skipped. The cache stacks the dense
layers first, as JAX's."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.models import sam_layer
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (einsum, embed_apply, embed_defs,
                                       init_from_defs, lane_einsum, pdef,
                                       rms_norm, stack_defs, torch_dtype,
                                       tree_map)


def _n_groups(cfg: ModelConfig) -> int:
    return max(1, cfg.num_layers // cfg.memory.every_n_layers)


def _n_dense(cfg: ModelConfig) -> int:
    """The leading dense layers of a MoE config (0 without MoE)."""
    return cfg.moe.num_dense_layers if cfg.moe is not None else 0


def _per_group(cfg: ModelConfig, n_groups: int) -> int:
    """Blocks a memory group runs: JAX's (L - n_dense) // n_groups."""
    return (cfg.num_layers - _n_dense(cfg)) // n_groups


def param_defs(cfg: ModelConfig):
    n_dense = _n_dense(cfg)
    defs = {"embed": embed_defs(cfg.vocab_size, cfg.d_model),
            "blocks": stack_defs(tfm.block_defs(cfg),
                                 cfg.num_layers - n_dense),
            "final_norm": pdef((cfg.d_model,), init="zeros")}
    if n_dense:
        defs["dense_blocks"] = stack_defs(
            tfm.block_defs(cfg, moe_layer=False), n_dense)
    if not cfg.tie_embeddings:
        defs["lm_head"] = pdef((cfg.d_model, cfg.vocab_size))
    if cfg.memory is not None:
        defs["memory"] = stack_defs(sam_layer.memory_defs(cfg),
                                    _n_groups(cfg))
    return defs


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                dtype: Optional[str] = None):
    """Weights from ``seed`` (a `torch.Generator` on ``device``), held in
    ``dtype`` (default: ``cfg.param_dtype``). Holding them in the compute
    dtype is what `_cast` would do on every call, done once."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_from_defs(param_defs(cfg), gen,
                          torch_dtype(dtype or cfg.param_dtype), device)


def _cast(params, cfg: ModelConfig):
    cd = torch_dtype(cfg.compute_dtype)
    return tree_map(lambda t: t.to(cd) if t.is_floating_point() else t,
                    params)


def _layer(stacked, i: int):
    return tree_map(lambda t: t[i], stacked)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings times √d; the scale is rounded to the compute
    dtype first, as JAX converts a Python scalar to the array's dtype."""
    cd = torch_dtype(cfg.compute_dtype)
    x = embed_apply(params["embed"], tokens, cd)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=cd, device=x.device)


def _embed_inputs(params, cfg: ModelConfig, batch):
    """JAX's `_embed_inputs`: the token embeddings (`_embed`), after the
    (B, frontend_len, d) ``batch["patch_embeds"]`` of a vision config,
    cast to the compute dtype and not scaled; for an audio config the (B,
    S, d) ``batch["frame_embeds"]`` alone, cast and not scaled (it reads
    no tokens; ``embed`` stays in the tree, unused, as in JAX); and the
    positions 0 .. S-1 over the whole sequence, (1, S)."""
    if cfg.frontend == "audio":
        x = batch["frame_embeds"].to(torch_dtype(cfg.compute_dtype))
        return x, torch.arange(x.shape[1], device=x.device)[None, :]
    x = _embed(params, cfg, batch["tokens"])
    if cfg.frontend == "vision" and cfg.frontend_len:
        if "patch_embeds" not in batch:
            raise ValueError(f"{cfg.name}: a batch of a vision config needs "
                             f"'patch_embeds' (B, {cfg.frontend_len}, "
                             f"{cfg.d_model}) beside 'tokens'")
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)[None, :]


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    cd = torch_dtype(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return params["embed"]["tok"].to(cd).T
    return params["lm_head"].to(cd)


def _block(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """One block -> (x, its aux loss); under autograd with ``cfg.remat``
    its activations are recomputed in the backward (JAX's
    ``jax.checkpoint`` with ``nothing_saveable``), the memory layers
    never. That holds for a block whose input needs no gradient too (an
    audio config's first block reads the batch's frames)."""
    if cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad
                                   for t in pytree.tree_leaves(p))):
        return checkpoint(tfm.block_forward, p, cfg, x, positions,
                          use_reentrant=False)
    return tfm.block_forward(p, cfg, x, positions)


def _run_stack(stacked, cfg: ModelConfig, x, positions, layers):
    """The blocks ``layers`` of a stack in turn -> (x, their aux losses
    summed from 0, in order, as JAX's scan carries them)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in layers:
        x, a = _block(_layer(stacked, i), cfg, x, positions)
        aux = aux + a
    return x, aux


def forward(params, cfg: ModelConfig, batch):
    """batch {"tokens": (B, S_t) int[, "patch_embeds": (B, P, d)]}, or an
    audio config's {"frame_embeds": (B, S, d)} -> (final hidden states (B,
    S, d), S = P + S_t, the auxiliary loss: the routers', summed stack by
    stack; 0 without MoE). A vision config needs the patch embeddings
    (`_embed_inputs`). The dense blocks run first.
    With a memory, the other blocks run in groups and each group is
    followed by `sam_layer.memory_layer_seq`; one memory state, zero at
    the start, runs through all the groups, as JAX threads one through its
    loop (and, as JAX, runs no block past the last whole group: module
    docstring). Differentiable in the weights when they require grad."""
    x, positions = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_dense = _n_dense(cfg)
    if n_dense:
        x, a = _run_stack(_cast(params["dense_blocks"], cfg), cfg, x,
                          positions, range(n_dense))
        aux = aux + a
    blocks = _cast(params["blocks"], cfg)
    if cfg.memory is None:
        x, a = _run_stack(blocks, cfg, x, positions,
                          range(cfg.num_layers - n_dense))
        aux = aux + a
    else:
        n_groups = _n_groups(cfg)
        per = _per_group(cfg, n_groups)
        state = sam_layer.init_memory_state(cfg, x.shape[0], device=x.device)
        mem_params = _cast(params["memory"], cfg)
        for g in range(n_groups):
            x, a = _run_stack(blocks, cfg, x, positions,
                              range(g * per, (g + 1) * per))
            aux = aux + a
            x, state = sam_layer.memory_layer_seq(_layer(mem_params, g), cfg,
                                                  x, state)
    x = rms_norm(x, _cast(params["final_norm"], cfg), cfg.norm_eps)
    return x, aux


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch):
    """The full-sequence forward under inference mode; returns the last
    position's logits (B, 1, V) in the promoted dtype of the hidden state
    and the head."""
    hidden, _ = forward(params, cfg, batch)
    return einsum("bsd,dv->bsv", hidden[:, -1:], _head_weight(params, cfg))


def chunked_ce(head_w: torch.Tensor, hidden: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor, chunk: int):
    """Mean cross-entropy over the unmasked positions, ``chunk`` positions
    at a time, so the (B, S, V) logits never exist whole: each chunk's f32
    logits, their log-sum-exp and the target's logit. A ragged tail is
    padded with masked positions. hidden (B, S, d), targets (B, S) int,
    mask (B, S) f32."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S + pad, chunk):
        hc, tc = hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk]
        mc = mask[:, lo:lo + chunk]
        logits = einsum("bsd,dv->bsv", hc, head_w).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, tc.long()[..., None])[..., 0]
        tot = tot + ((lse - picked) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch {"tokens" (B, S), "targets" (B, S_t)[, "mask" (B, S_t)][,
    "patch_embeds"]}, or an audio config's {"frame_embeds" (B, S, d),
    "targets" (B, S)[, "mask"]} -> (loss, {"ce", "aux"}): `chunked_ce`
    over the last S_t positions in chunks of ``cfg.loss_chunk`` (a vision
    prefix predicts nothing), plus the auxiliary loss (the routers',
    `forward`)."""
    hidden, aux = forward(params, cfg, batch)
    targets = batch["targets"]
    hidden = hidden[:, -targets.shape[1]:]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    ce = chunked_ce(_head_weight(params, cfg), hidden, targets, mask,
                    cfg.loss_chunk)
    return ce + aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------
# Serving: cache and memory states, decode
# --------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """(L, B, Smax, Hkv, D) shapes of k and v: Smax = max_len, or
    min(max_len, window) for a windowed config, whose cache is a ring; or
    MLA's latent rows, ckv (L, B, max_len, kv_lora + rope); or RWKV's
    states, tm_shift and cm_shift (L, B, d) and wkv (L, B, H, D, D), which
    max_len does not size; with the sparse decode the block key sums
    ksum (L, B, nb, Hkv, D); in a hybrid block the SSM's conv (L, B, K-1,
    d_inner) and ssm (L, B, d_inner, N) beside k and v. The layers stack
    as the blocks run: the dense ones first."""
    per_layer = tfm.layer_cache_shapes(cfg, batch, max_len)
    return {k: (cfg.num_layers,) + v for k, v in per_layer.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               per_lane_pos: bool = False, *, device="cuda"):
    """Zero caches of `cache_shapes` (k and v, a ring of min(max_len,
    window) slots with a window, which any position fits; MLA's ckv;
    ksum; the SSM's conv; or RWKV's states) in the compute dtype, RWKV's
    wkv and the SSM's state in f32 whatever it is (JAX's); and ``pos``: ()
    int32, or (B,) per-lane positions with ``per_lane_pos``."""
    cd = torch_dtype(cfg.compute_dtype)
    cache = {k: torch.zeros(v, dtype=torch.float32 if k in ("wkv", "ssm")
                            else cd, device=device)
             for k, v in cache_shapes(cfg, batch, max_len).items()}
    cache["pos"] = torch.zeros((batch,) if per_lane_pos else (),
                               dtype=torch.int32, device=device)
    return cache


def init_memory_states(cfg: ModelConfig, batch: int, *,
                       per_lane_step: bool = False, device="cuda"):
    """One `sam_layer.MemoryState` per memory group; ``per_lane_step``
    carries each state's step as (B, 1), so every lane stamps usage with
    its own step. None for a config without memory."""
    if cfg.memory is None:
        return None
    states = []
    for _ in range(_n_groups(cfg)):
        st = sam_layer.init_memory_state(cfg, batch, device=device)
        if per_lane_step:
            st = st._replace(step=torch.zeros((batch, 1), dtype=torch.int32,
                                              device=device))
        states.append(st)
    return tuple(states)


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                mem_states=None):
    """tokens (B, 1) int, or an audio config's frame embeddings (B, 1, d),
    cast to the compute dtype and not scaled. ``cache["pos"]`` is () or
    (B,). With
    ``mem_states`` (`init_memory_states`) each memory group's blocks are
    followed by one SAM read and write of the token's hidden state, whose
    read is added back in the stream's dtype. The dense blocks run first,
    on the cache's first layers. Returns (logits (B, 1, V), cache) — plus
    the new memory states when ``mem_states`` was given. The cache (k and
    v, with ksum, conv and ssm where the config has them; ckv or RWKV's
    states) and the memory states are updated in place. The head's
    product runs through `layers.lane_einsum`, so a lane's logits do not
    depend on how many lanes the batch holds. A per-lane ``pos`` with
    ``cfg.sparse_decode_blocks`` raises NotImplementedError, as JAX's: the
    block sums assume a lockstep position."""
    pos = cache["pos"]
    if pos.dim() and cfg.sparse_decode_blocks is not None:
        raise NotImplementedError(
            "per-lane decode positions are not supported with "
            "sparse_decode_blocks (the block-centroid ring assumes a "
            "lockstep position)")
    if cfg.frontend == "audio":
        x = tokens.to(torch_dtype(cfg.compute_dtype))
    else:
        x = _embed(params, cfg, tokens)
    n_dense = _n_dense(cfg)
    blocks = _cast(params["blocks"], cfg)
    new_cache = {key: t for key, t in cache.items() if key != "pos"}

    def run(stacked, i, at, x):
        """Block i of ``stacked`` on the cache's layer ``at``."""
        layer_cache = {key: t[at] for key, t in new_cache.items()}
        x, _ = tfm.block_decode(_layer(stacked, i), cfg, x, layer_cache, pos)
        return x

    if n_dense:
        dense = _cast(params["dense_blocks"], cfg)
        for i in range(n_dense):
            x = run(dense, i, i, x)
    new_mem = None
    if mem_states is not None:
        if cfg.memory is None:
            raise ValueError("mem_states passed but cfg.memory is None")
        per = _per_group(cfg, len(mem_states))
        mem_params = _cast(params["memory"], cfg)
        new_mem = []
        for g, state in enumerate(mem_states):
            for i in range(g * per, (g + 1) * per):
                x = run(blocks, i, n_dense + i, x)
            state, out = sam_layer.memory_access(_layer(mem_params, g), cfg,
                                                 x[:, 0], state)
            new_mem.append(state)
            x = x + out[:, None, :].to(x.dtype)
    else:
        for i in range(cfg.num_layers - n_dense):
            x = run(blocks, i, n_dense + i, x)
    x = rms_norm(x, _cast(params["final_norm"], cfg), cfg.norm_eps)
    logits = lane_einsum("bsd,dv->bsv", x, _head_weight(params, cfg))
    new_cache["pos"] = pos + 1
    if mem_states is not None:
        return logits, new_cache, tuple(new_mem)
    return logits, new_cache


@torch.inference_mode()
def decode_scan(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                mem_states=None):
    """Consume tokens (B, T), or an audio config's frames (B, T, d), one
    `decode_step` at a time. Returns (logits (B, 1, V) of the last
    position, cache) — plus the memory states when ``mem_states`` was
    given."""
    B, T = tokens.shape[:2]
    logits = torch.zeros((B, 1, cfg.vocab_size),
                         dtype=torch_dtype(cfg.compute_dtype),
                         device=tokens.device)
    mem = mem_states
    for t in range(T):
        if mem is None:
            logits, cache = decode_step(params, cfg, cache,
                                        tokens[:, t:t + 1])
        else:
            logits, cache, mem = decode_step(params, cfg, cache,
                                             tokens[:, t:t + 1],
                                             mem_states=mem)
    if mem_states is not None:
        return logits, cache, mem
    return logits, cache
