"""Continuous-batching scheduler, the JAX package's `launch/engine/
scheduler.py`: a fixed set of batch lanes, a FIFO request queue, and
admit/evict bookkeeping.

The scheduler is pure host-side state — it never touches tensors. The
engine (launch/engine/engine.py) asks it *which* lane serves *which*
request; moving session state in and out of the batched device buffers is
the engine's job. Admission is strictly FIFO (no starvation: a request can
never be overtaken by a later submission), eviction frees the lane
immediately, and a freed lane is refillable on the same engine step — the
request-interleaving idiom of streaming generation servers.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional


@dataclasses.dataclass
class Request:
    """One serving request for one user's session.

    ``prompt`` is a list of prompt token ids fed one per engine step while
    the lane prefills; sampling starts when the prompt is exhausted and
    stops after ``max_new_tokens`` sampled tokens. ``greedy`` selects
    argmax vs per-lane categorical sampling (seeded by ``sample_seed`` and
    the session's token counter, so a request's sample stream is invariant
    to lane placement and batch composition)."""

    user: str
    prompt: list
    max_new_tokens: int
    greedy: bool = True
    sample_seed: int = 0
    arrival: float = 0.0            # bench bookkeeping (wall-clock)
    id: int = -1

    # Filled in while the request is being served.
    prefill_done: int = 0           # prompt tokens consumed so far
    generated: int = 0              # tokens sampled so far
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def prefilling(self) -> bool:
        return self.prefill_done < len(self.prompt)

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens


class Scheduler:
    """FIFO admission over a fixed number of lanes.

    * ``submit`` enqueues a request (never blocks, never reorders);
    * ``admit`` drains the queue into free lanes — in submission order —
      and returns the new ``(lane, request)`` assignments;
    * ``evict`` frees a lane (the engine calls it the step a request
      finishes), making it admittable on the very same step.

    With ``replicas > 1`` the lanes split into equal per-replica pools —
    replica r owns lanes [r·lpr, (r+1)·lpr) with lpr = lanes/replicas —
    and the scheduler tracks **session-to-replica affinity**: eviction
    records which replica's pool held the user, and a returning user's
    request prefers a free lane in that replica, falling back to the
    lowest free lane anywhere — the engine restores the session from the
    `SessionStore` into whichever lane it gets, so a miss never costs
    correctness. Admission stays strictly FIFO over *requests*; only the
    lane choice consults affinity, so determinism is unchanged."""

    def __init__(self, lanes: int, replicas: int = 1):
        if lanes < 1:
            raise ValueError(f"need at least one lane, got {lanes}")
        if replicas < 1 or lanes % replicas:
            raise ValueError(
                f"lanes={lanes} must split evenly over replicas={replicas}")
        self.lanes = lanes
        self.replicas = replicas
        self.lanes_per_replica = lanes // replicas
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}      # lane -> request
        self.affinity: dict[str, int] = {}        # user -> last replica
        self._free: list[int] = list(range(lanes - 1, -1, -1))
        self._ids = itertools.count()

    def replica_of(self, lane: int) -> int:
        return lane // self.lanes_per_replica

    def submit(self, req: Request) -> Request:
        if req.id < 0:
            req.id = next(self._ids)
        self.queue.append(req)
        return req

    def admit(self) -> list[tuple[int, Request]]:
        """Assign queued requests to free lanes, FIFO; lowest lane first.

        A request for a user who is *currently active* in some lane is
        held back (two live lanes for one user would fork the session) —
        later requests for other users may overtake it, but requests for
        the same user keep their submission order."""
        admitted: list[tuple[int, Request]] = []
        deferred: deque[Request] = deque()
        busy = {r.user for r in self.active.values()}
        while self._free and self.queue:
            req = self.queue.popleft()
            if req.user in busy:
                deferred.append(req)
                continue
            lane = self._pick_lane(req.user)
            self.active[lane] = req
            busy.add(req.user)
            admitted.append((lane, req))
        self.queue.extendleft(reversed(deferred))
        return admitted

    def _pick_lane(self, user: str) -> int:
        """Pop the lowest free lane in the user's affinity replica, else
        the lowest free lane anywhere (`_free` is sorted descending, so
        the lowest lane sits at the end)."""
        pref = self.affinity.get(user)
        if pref is not None:
            for i in range(len(self._free) - 1, -1, -1):
                if self.replica_of(self._free[i]) == pref:
                    return self._free.pop(i)
        return self._free.pop()

    def evict(self, lane: int) -> Request:
        req = self.active.pop(lane)
        self.affinity[req.user] = self.replica_of(lane)
        self._free.append(lane)
        self._free.sort(reverse=True)     # deterministic: lowest lane first
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.active) or bool(self.queue)

    @property
    def free_lanes(self) -> int:
        return len(self._free)
