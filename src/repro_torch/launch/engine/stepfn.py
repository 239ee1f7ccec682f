"""The engine's per-step functions, the JAX package's `launch/engine/
stepfn.py`: one decode step for the whole lane batch with per-lane token
selection, the multi-token prefill, and the lane insert.

Every lane advances every step — a prefilling lane consumes its next
prompt token, a generating lane the token it sampled last step — so a
step is one fixed-shape program whichever requests occupy which lanes:
admit and evict change data, never shape.

Sampling is per-lane and placement-invariant: lane ``b`` draws with the
key ``fold_in(fold_in(PRNGKey(0), seed_b), counter_b)`` of JAX 0.9's
default PRNG (threefry-2x32, ``jax_threefry_partitionable`` on), computed
here with integer tensor ops on the lanes' device (uint32 words held in
int64, masked to 32 bits), and the token is JAX's Gumbel-max draw
``argmax(logits - log(-log(u)))`` over those bits. The keys and bits equal
``jax.random``'s bit for bit, so a sampled lane gives JAX's token (the
logarithms may differ from XLA's by an ulp); the draw depends on (seed,
counter) only, wherever the scheduler places the request.

The cache and the memory states are updated in place; the engine runs
these under ``torch.inference_mode``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000              # the bits of 1.0f


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """JAX's Threefry-2x32 hash (20 rounds, `prng._threefry2x32_lowering`)
    of the counter words (x0, x1) under the key words (k0, k1): int64
    tensors of uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: keys (..., 2), data (...) int32 (a
    negative value wraps to its uint32) -> keys (..., 2): the hash of the
    counter pair (0, data)."""
    d = data.to(torch.int64) & _MASK
    o0, o1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], -1)


def sample_keys(seeds: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """(B, 2) int64 key words ``fold_in(fold_in(PRNGKey(0), seed),
    counter)`` per lane; ``PRNGKey(0)``'s words are (0, 0)."""
    root = torch.zeros(seeds.shape + (2,), dtype=torch.int64,
                       device=seeds.device)
    return fold_in(fold_in(root, seeds), counters)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per row of keys (B, 2): the hash of
    the counter pairs (0, i), i < n, its two words XORed; (B, n) int64."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    return b0 ^ b1


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` per row ("low" mode): u uniform in
    [tiny, 1) from the top 23 bits, then -log(-log(u)); (B, n) f32."""
    bits = (random_bits(keys, n) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # JAX: max(tiny, floats · (1 - tiny) + tiny), and 1 - tiny is 1.0f.
    u = torch.clamp_min(floats + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def select(logits: torch.Tensor, greedy, seeds: torch.Tensor,
           counters: torch.Tensor) -> torch.Tensor:
    """Each lane's token from its f32 logits (B, V): the argmax (the lowest
    index on ties) where ``greedy`` (a host bool array), else
    ``jax.random.categorical`` of its key. The draw runs only when some
    lane samples."""
    tok = logits.argmax(-1).to(torch.int32)
    greedy = np.asarray(greedy, bool)
    if greedy.all():
        return tok
    noise = gumbel(sample_keys(seeds, counters), logits.shape[-1])
    sampled = (noise + logits).argmax(-1).to(torch.int32)
    keep = torch.as_tensor(greedy, device=logits.device)
    return torch.where(keep, tok, sampled)


def engine_step(params, cfg, cache, mem_states, tokens, greedy, seeds,
                counters):
    """One decode step of every lane. ``tokens`` (B, 1) int32: each lane's
    input (its prompt token while prefilling, else its last emitted
    token); ``greedy`` (B,) host bools; ``seeds``, ``counters`` (B,) int32
    on the lanes' device. Returns (next_tok (B,) int32, logits (B, V) f32,
    cache, mem_states)."""
    if mem_states is None:
        logits, cache = lm.decode_step(params, cfg, cache, tokens)
    else:
        logits, cache, mem_states = lm.decode_step(
            params, cfg, cache, tokens, mem_states=mem_states)
    logits = logits[:, -1].float()
    return select(logits, greedy, seeds, counters), logits, cache, \
        mem_states


def prefill_scan(params, cfg, cache, mem_states, tokens):
    """Consume tokens (B, T) in T decode steps (`lm.decode_scan`), with no
    selection: prompt tokens whose successors are known. Returns (cache,
    mem_states)."""
    if mem_states is None:
        _, cache = lm.decode_scan(params, cfg, cache, tokens)
        return cache, None
    _, cache, mem_states = lm.decode_scan(params, cfg, cache, tokens,
                                          mem_states=mem_states)
    return cache, mem_states


def lane_insert(cache, mem_states, lane: int, sess_cache, pos, sess_mem):
    """Copy one session's column into lane ``lane`` of the live batch, in
    place: its cache columns (each (L, 1, ...)), its position (1,) and its
    memory states (batch 1, field for field; None without a memory). The
    session's tensors are copied, never aliased."""
    for k, v in cache.items():
        if k == "pos":
            v[lane:lane + 1].copy_(pos)
        else:
            v[:, lane].copy_(sess_cache[k][:, 0])
    if mem_states is not None:
        for live, warm in zip(mem_states, sess_mem):
            for full, one in zip(live, warm):
                full[lane].copy_(one[0])
