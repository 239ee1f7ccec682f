"""Persistent per-user memory sessions, the JAX package's `launch/engine/
sessions.py`: an LRU host-side store with disk spill, holding what a
user's session needs between requests — the SAM memory states, the
KV-cache columns, the position and the token counter.

Sessions are host copies (CPU tensors that share no storage with the live
batch) in the canonical single-device layout (shards = 1, one scratch
row): `put` brings any slot-sharded memory or usage leaf (rows N + S)
back to it with `mem_shard.from_shard_layout`, the re-layout a
checkpoint restore applies. Beyond ``capacity`` hot sessions the least
recently used one spills to ``spill_dir`` through `checkpoint/ckpt.py`
(the JAX package's format, ``mem_layout=(num_slots, 1)`` recorded), and
`take` or `peek` restores it; ``spills`` and ``restores`` count both.
"""
from __future__ import annotations

import os
import shutil
from collections import OrderedDict
from typing import Any, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.types import SLOT_LEAVES
from repro_torch.distributed.mem_shard import from_shard_layout


class _Spec:
    """A leaf's shape and dtype: a restore template that holds no data."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _host(tree):
    """Every tensor leaf copied to the CPU, as a normal (not inference)
    tensor of its own storage."""
    def copy(_, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        with torch.inference_mode(False):
            return leaf.detach().to("cpu", copy=True)
    return ckpt.map_with_path(copy, tree)


def _canonical(tree, num_slots: int):
    """Slot-sharded memory and usage leaves (rows N + S, S > 1 dividing N)
    in the canonical (B, N+1, ...) layout; everything else as it is."""
    def conv(path, leaf):
        name = path.rsplit("/", 1)[-1].lstrip(".")
        if name not in SLOT_LEAVES or getattr(leaf, "ndim", 0) < 2:
            return leaf
        shards = leaf.shape[1] - num_slots
        if shards <= 1 or num_slots % shards:
            return leaf
        return from_shard_layout(leaf, num_slots, shards)
    return ckpt.map_with_path(conv, tree)


class SessionStore:
    """user -> canonical-layout session tree, LRU, disk-spillable.

    ``num_slots`` enables the canonicalizing re-layout of memory and usage
    leaves (None: trees are stored as they are — memoryless sessions).
    ``capacity`` bounds the number of hot (in-RAM) sessions; older
    sessions spill to ``spill_dir`` (required with a capacity) and restore
    on `take`."""

    def __init__(self, num_slots: Optional[int] = None,
                 capacity: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        if capacity is not None and (capacity < 1 or spill_dir is None):
            raise ValueError(
                "capacity needs >= 1 hot sessions and a spill_dir to evict "
                "the overflow to")
        self.num_slots = num_slots
        self.capacity = capacity
        self.spill_dir = spill_dir
        self._hot: OrderedDict[str, Any] = OrderedDict()
        self._spilled: dict[str, tuple[str, Any]] = {}   # user -> (dir, tmpl)
        self.spills = 0
        self.restores = 0

    # -- core API ----------------------------------------------------------

    def put(self, user: str, tree) -> None:
        """Store ``user``'s session: slot leaves in the canonical layout,
        every tensor copied to the host."""
        if self.num_slots is not None:
            tree = _canonical(tree, self.num_slots)
        self._hot[user] = _host(tree)
        self._hot.move_to_end(user)
        self._drop_spilled(user)          # the fresh copy supersedes it
        self._maybe_spill()

    def take(self, user: str):
        """Remove and return ``user``'s session tree (CPU tensors),
        restoring it from disk if it was spilled. None for an unknown user
        (a cold session: the caller builds a fresh state)."""
        if user in self._hot:
            return self._hot.pop(user)
        if user in self._spilled:
            return self._restore(user)
        return None

    def peek(self, user: str):
        """``user``'s session tree without removing it from the store
        (restored into the hot set first if it was spilled); None for an
        unknown user. Lets a caller validate a request against the stored
        state before committing to `take`."""
        if user in self._spilled:
            self._hot[user] = self._restore(user)
            self._maybe_spill()
        return self._hot.get(user)

    def __contains__(self, user: str) -> bool:
        return user in self._hot or user in self._spilled

    def __len__(self) -> int:
        return len(self._hot) + len(self._spilled)

    @property
    def users(self):
        return list(self._hot) + list(self._spilled)

    # -- spill machinery ---------------------------------------------------

    def _session_dir(self, user: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in user)
        return os.path.join(self.spill_dir, f"session_{safe}")

    def _restore(self, user: str):
        directory, template = self._spilled.pop(user)
        tree, _ = ckpt.restore_checkpoint(directory, template)
        shutil.rmtree(directory, ignore_errors=True)
        self.restores += 1
        return tree

    def _maybe_spill(self) -> None:
        if self.capacity is None:
            return
        while len(self._hot) > self.capacity:
            user, tree = self._hot.popitem(last=False)    # LRU-oldest
            directory = self._session_dir(user)
            mem_layout = (None if self.num_slots is None
                          else (self.num_slots, 1))
            ckpt.save_checkpoint(directory, 0, tree, mem_layout=mem_layout)
            self._spilled[user] = (directory, ckpt.map_with_path(
                lambda _, t: _Spec(t) if isinstance(t, torch.Tensor) else t,
                tree))
            self.spills += 1

    def _drop_spilled(self, user: str) -> None:
        if user in self._spilled:
            directory, _ = self._spilled.pop(user)
            shutil.rmtree(directory, ignore_errors=True)
