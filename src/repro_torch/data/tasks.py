"""The NTM tasks of the paper (§4.2): copy, associative recall and
priority sort, with the layouts of `repro/data/tasks.py`. Inputs are
binary vectors of width ``bits`` plus two flag channels; targets and mask
cover the answer span only. Each task draws its random parts from
``generator`` (numpy or torch draws can be given instead, so two
implementations can be fed the same inputs) and returns batch-major
(inputs (B, T, bits+2), targets (B, T, bits), mask (B, T)); the models
take time-major inputs (``inputs.transpose(0, 1)``)."""
from __future__ import annotations

import math

import numpy as np
import torch


def _given(x, dtype=np.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=dtype))


def _coins(shape, generator) -> torch.Tensor:
    return torch.bernoulli(torch.full(shape, 0.5), generator=generator)


def _out(device, *tensors):
    return tuple(t.to(device) for t in tensors)


def copy_task(batch: int, length: int, max_len: int, bits: int = 8, *,
              generator: torch.Generator | None = None, seq=None,
              device="cuda"):
    """Copy a length-``length`` sequence after the delimiter. Padded time
    T = 2·max_len + 2; a start flag (channel ``bits``) and a delimiter flag
    (channel ``bits+1``). The bits come from ``seq`` ((batch, max_len,
    bits) 0/1) when given, else from fair coin flips."""
    T = 2 * max_len + 2
    seq = _coins((batch, max_len, bits), generator) if seq is None \
        else _given(seq)
    seq = seq * (torch.arange(max_len) < length)[None, :, None]
    inputs = torch.zeros((batch, T, bits + 2))
    inputs[:, 0, bits] = 1.0                                   # start flag
    inputs[:, 1:1 + max_len, :bits] = seq
    inputs[:, length + 1, bits + 1] += 1.0                     # delimiter
    targets = torch.zeros((batch, T, bits))
    targets[:, length + 2:2 * length + 2] = seq[:, :length]
    t = torch.arange(T)
    mask = ((t >= length + 2) & (t < 2 * length + 2)).float()
    return _out(device, inputs, targets, mask.expand(batch, T).clone())


def associative_recall_task(batch: int, num_items: int, max_items: int,
                            bits: int = 8, item_len: int = 3, *,
                            generator: torch.Generator | None = None,
                            items=None, q_idx=None, device="cuda"):
    """Store ``num_items`` items of ``item_len`` vectors; after the query
    flag (channel ``bits``) one stored item is shown and the item after it
    must be produced. Padded time T = (max_items + 2)·item_len + 2. The
    items come from ``items`` ((batch, max_items, item_len, bits) 0/1) and
    the queried item from ``q_idx`` ((batch,) in [0, max(num_items - 1,
    1))) when given, else from ``generator``. The query overwrites whole
    input rows, its flag channels zero, as in the reference."""
    T = (max_items + 2) * item_len + 2
    items = _coins((batch, max_items, item_len, bits), generator) \
        if items is None else _given(items)
    items = items * (torch.arange(max_items) < num_items)[None, :, None, None]
    if q_idx is None:
        q_idx = torch.randint(0, max(num_items - 1, 1), (batch,),
                              generator=generator)
    q_idx = _given(q_idx, np.int64)
    b = torch.arange(batch)
    query, answer = items[b, q_idx], items[b, q_idx + 1]

    inputs = torch.zeros((batch, T, bits + 2))
    inputs[:, :max_items * item_len, :bits] = items.reshape(batch, -1, bits)
    qpos = num_items * item_len
    inputs[:, qpos, bits] += 1.0                               # query flag
    inputs[:, qpos + 1:qpos + 1 + item_len] = torch.nn.functional.pad(
        query, (0, 2))
    targets = torch.zeros((batch, T, bits))
    a0 = qpos + 1 + item_len
    targets[:, a0:a0 + item_len] = answer
    t = torch.arange(T)
    mask = ((t >= a0) & (t < a0 + item_len)).float()
    return _out(device, inputs, targets, mask.expand(batch, T).clone())


def priority_sort_task(batch: int, num_items: int, max_items: int,
                       bits: int = 8, top_k_frac: float = 0.8, *,
                       generator: torch.Generator | None = None, vecs=None,
                       prio=None, device="cuda"):
    """Given ``num_items`` (vector, priority) pairs (the priority in
    channel ``bits``), after the flag (channel ``bits+1``) output the top
    ceil(0.8·num_items) vectors by descending priority (paper: 20 -> 16).
    Padded time T = 2·max_items + 2. The vectors come from ``vecs``
    ((batch, max_items, bits) 0/1) and the priorities from ``prio``
    ((batch, max_items) in [-1, 1)) when given, else from ``generator``.
    Dead items take priority -2.0; equal priorities rank the lower index
    first (a stable sort, as ``lax.top_k``); the answer count is the
    ceiling of 0.8·num_items taken in f32, as the reference computes it."""
    T = 2 * max_items + 2
    vecs = _coins((batch, max_items, bits), generator) if vecs is None \
        else _given(vecs)
    prio = (torch.rand((batch, max_items), generator=generator) * 2.0 - 1.0
            if prio is None else _given(prio))
    alive = (torch.arange(max_items) < num_items)[None, :]
    prio = torch.where(alive, prio, -2.0)
    order = torch.sort(prio, dim=-1, descending=True, stable=True).indices
    sorted_vecs = vecs[torch.arange(batch)[:, None], order]

    inputs = torch.zeros((batch, T, bits + 2))
    inputs[:, :max_items, :bits] = vecs * alive[..., None]
    inputs[:, :max_items, bits] = prio * alive
    inputs[:, num_items, bits + 1] += 1.0                      # flag
    targets = torch.zeros((batch, T, bits))
    targets[:, num_items + 1:num_items + 1 + max_items] = sorted_vecs
    n_out = math.ceil(np.float32(top_k_frac * num_items))
    t = torch.arange(T)
    mask = ((t >= num_items + 1) & (t < num_items + 1 + n_out)).float()
    return _out(device, inputs, targets, mask.expand(batch, T).clone())
