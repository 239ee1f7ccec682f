"""The continuous-batching serving engine, the JAX package's `launch/
engine/engine.py`.

A `ServeEngine` owns a fixed number of batch lanes (the batch dimension
of the cache and the memory states on its device) and a `SessionStore`
of per-user state. Each `step()`:

1. admits queued requests into free lanes (scheduler, FIFO) — a lane
   freed by an eviction is refillable on the same step;
2. runs one decode step for the whole batch (`stepfn.engine_step`: every
   lane advances, a prompt token while prefilling, else its last emitted
   token), whose memory groups run the read, write and LRA kernels;
3. updates each request's progress and evicts finished lanes, copying
   each finished user's session (KV-cache columns, position, memory
   states, token counter) out to the store.

A user's next request resumes the session in whichever lane the
scheduler picks, and decode continues as if never interrupted.

Determinism (tests/test_torch_engine.py, `chip_smoke.py` phase 12): every
decode and memory op is per batch row and sampling keys derive from
(request seed, token counter) only, so within one lane count a request's
tokens and final memory state are bit-identical whether it ran
uninterrupted or was evicted and restored across engine instances,
whatever lanes it landed in and whoever its neighbours were.

The cache and memory states are updated in place (JAX donates them), so
an evicted lane is copied out before the next step, and the cold-session
template is copied into a lane, never aliased. The mutations run under
``torch.inference_mode``, as the decode does. The engine runs on one
device; serving under a mesh is ROADMAP A11, item 4.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.engine import stepfn
from repro_torch.launch.engine.scheduler import Request, Scheduler
from repro_torch.launch.engine.sessions import SessionStore
from repro_torch.models import lm

MESH_ITEM = ("serving on a mesh (the LM memory layer sharded by slots) is "
             "ROADMAP A11, item 4")


class ServeEngine:
    """Continuous-batching server for one model over ``lanes`` batch lanes
    on ``device``.

    ``params`` defaults to weights from ``param_seed``, held in the
    compute dtype. ``replicas`` splits the lanes into equal per-replica
    pools with session-to-replica affinity (launch/engine/scheduler.py);
    `rescale()` is the live join/leave event. ``session_capacity`` and
    ``spill_dir`` bound the in-RAM session store with LRU disk spill, or
    ``session_store`` shares one store between engines. An audio config
    raises NotImplementedError, as JAX's engine does. An RWKV session is
    its O(1) state {tm_shift, wkv, cm_shift}, but ``max_len`` bounds it
    all the same, as in JAX (ROADMAP §C)."""

    def __init__(self, cfg, *, lanes: int = 4, max_len: int = 128,
                 param_seed: int = 0, params=None,
                 replicas: Optional[int] = None,
                 session_capacity: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 session_store: Optional[SessionStore] = None,
                 device="cuda", mesh=None):
        if mesh is not None:
            raise ValueError(MESH_ITEM)
        if cfg.frontend == "audio":
            raise NotImplementedError(
                "the serving engine feeds token ids, not audio frames")
        self.cfg = cfg
        self.max_len = max_len
        self.device = torch.device(device)
        self.replicas = self._resolve_replicas(lanes, replicas)
        self.params = params if params is not None else lm.init_params(
            cfg, seed=param_seed, device=self.device,
            dtype=cfg.compute_dtype)
        self._build_batch(lanes)
        self.scheduler = Scheduler(lanes, replicas=self.replicas)
        self.sessions = session_store if session_store is not None else \
            SessionStore(
                num_slots=cfg.memory.num_slots if cfg.memory else None,
                capacity=session_capacity, spill_dir=spill_dir)
        self._out: dict[int, list] = {}             # request id -> tokens
        self.steps = 0
        self.last_logits = None

    @staticmethod
    def _resolve_replicas(lanes: int, replicas: Optional[int]) -> int:
        if replicas is None:
            return 1
        if replicas < 1 or lanes % replicas:
            raise ValueError(
                f"lanes={lanes} must split evenly over replicas={replicas}")
        return replicas

    def _build_batch(self, lanes: int) -> None:
        """(Re)build everything whose shape carries the lane count: the
        batched cache and memory states, the cold-session template and the
        host-side per-lane registers."""
        cfg, dev = self.cfg, self.device
        self.lanes = lanes
        self.cache = lm.init_cache(cfg, lanes, self.max_len,
                                   per_lane_pos=True, device=dev)
        self.mem = lm.init_memory_states(cfg, lanes, per_lane_step=True,
                                         device=dev)
        # Cold-session template, built once: admission copies it into a
        # lane as a warm restore copies a session.
        self._fresh_cache = {k: torch.zeros_like(v[:, :1])
                             for k, v in self.cache.items() if k != "pos"}
        self._zero_pos = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._fresh_mem = lm.init_memory_states(cfg, 1, per_lane_step=True,
                                                device=dev)
        # Host-side per-lane registers (what the next step consumes).
        self._feed = np.zeros(lanes, np.int32)      # next input token
        self._greedy = np.ones(lanes, bool)
        self._seeds = np.zeros(lanes, np.int32)
        self._counters = np.zeros(lanes, np.int32)  # session token counters

    # -- request API -------------------------------------------------------

    def submit(self, req: Request) -> Request:
        if not req.prompt:
            raise ValueError("a request needs at least one prompt token")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.arrival == 0.0:
            req.arrival = time.time()
        return self.scheduler.submit(req)

    @torch.inference_mode()
    def step(self) -> list:
        """Advance the batch one token; returns results of any requests
        that finished this step (possibly empty). A request that cannot
        fit raises after the step's other admissions are done."""
        rejected = None
        for lane, req in self.scheduler.admit():
            try:
                self._admit_lane(lane, req)
            except ValueError as e:
                rejected = rejected or e
        if rejected is not None:
            raise rejected
        if not self.scheduler.active:
            return []
        self._prefill_scan_hop()

        dev = self.device
        tokens = torch.as_tensor(self._feed[:, None], device=dev)
        next_tok, self.last_logits, self.cache, self.mem = \
            stepfn.engine_step(
                self.params, self.cfg, self.cache, self.mem, tokens,
                self._greedy, torch.as_tensor(self._seeds, device=dev),
                torch.as_tensor(self._counters, device=dev))
        # Block on the tokens: the latencies measure compute, not the
        # launch queue.
        toks = next_tok.cpu().numpy()
        now = time.time()
        self.steps += 1

        finished = []
        for lane in sorted(self.scheduler.active):
            req = self.scheduler.active[lane]
            self._counters[lane] += 1
            if req.prefilling:
                req.prefill_done += 1
                if req.prefilling:            # more prompt to feed
                    self._feed[lane] = req.prompt[req.prefill_done]
                    continue
                req.first_token_time = now    # last prompt token consumed:
            req.generated += 1                # this step's output counts
            self._out[req.id].append(int(toks[lane]))
            self._feed[lane] = toks[lane]
            if req.done:
                req.finish_time = now
                self._evict_lane(lane)
                finished.append(self._result(req))
        return finished

    def run(self, requests=None) -> list:
        """Submit ``requests`` (optional) and step until the queue and all
        lanes drain; returns results in completion order."""
        for r in requests or []:
            self.submit(r)
        results = []
        while self.scheduler.has_work:
            results.extend(self.step())
        return results

    # -- elastic scale events ----------------------------------------------

    @torch.inference_mode()
    def rescale(self, *, replicas: Optional[int] = None,
                lanes: Optional[int] = None, mesh=None) -> None:
        """Live join/leave event: change the replica count without
        restarting any request. Every in-flight request is parked through
        the ordinary eviction path (its lane copied into the
        `SessionStore`), the batch is rebuilt at the new lane count, and the
        parked requests re-enter the queue in submission order, ahead of
        the waiting backlog, with their progress intact. ``lanes`` defaults
        to keeping the per-replica lane count; ``replicas`` to 1."""
        if mesh is not None:
            raise ValueError(MESH_ITEM)
        per_replica = self.lanes // self.replicas
        inflight = sorted((self.scheduler.active[lane]
                           for lane in self.scheduler.active),
                          key=lambda r: r.id)
        for lane in sorted(self.scheduler.active):
            self._evict_lane(lane)
        queued = list(self.scheduler.queue)
        old = self.scheduler

        replicas = 1 if replicas is None else replicas
        if lanes is None:
            lanes = per_replica * replicas
        self.replicas = self._resolve_replicas(lanes, replicas)
        self._build_batch(lanes)

        sched = Scheduler(lanes, replicas=self.replicas)
        sched._ids = old._ids         # request ids stay globally unique
        sched.affinity = {u: r for u, r in old.affinity.items()
                          if r < self.replicas}
        sched.queue.extend(inflight + queued)
        self.scheduler = sched

    # -- lane <-> session movement ----------------------------------------

    def _admit_lane(self, lane: int, req: Request) -> None:
        # Validate against the stored session before taking it: a rejected
        # request leaves the session in the store and the lane free. The
        # budget counts only the remaining prompt and generation, so a
        # request resuming after a rescale is not counted twice. A windowed
        # config's cache is a ring, which any length fits (JAX's check).
        sess = self.sessions.peek(req.user)
        pos = 0 if sess is None else int(sess["pos"][0])
        need = (len(req.prompt) - req.prefill_done
                + req.max_new_tokens - req.generated)
        if pos + need > self.max_len and self.cfg.window is None:
            self.scheduler.evict(lane)
            raise ValueError(
                f"user {req.user!r}: session at position {pos} cannot fit "
                f"{len(req.prompt)} prompt + {req.max_new_tokens} new "
                f"tokens in max_len={self.max_len}")
        sess = self.sessions.take(req.user)
        if sess is None:
            self._reset_lane(lane)
        else:
            self._restore_lane(lane, sess)
        # A fresh request feeds its first prompt token; one resuming after
        # a rescale feeds wherever it stopped — the next prompt token, or
        # mid-generation the last token it emitted.
        self._out.setdefault(req.id, [])
        self._feed[lane] = (req.prompt[req.prefill_done] if req.prefilling
                            else self._out[req.id][-1])
        self._greedy[lane] = req.greedy
        self._seeds[lane] = req.sample_seed

    def _reset_lane(self, lane: int) -> None:
        """Cold session: zero KV columns, position 0, a fresh memory state
        (zero rows, the staggered usage table, step 0)."""
        stepfn.lane_insert(self.cache, self.mem, lane, self._fresh_cache,
                           self._zero_pos, self._fresh_mem)
        self._counters[lane] = 0

    def _restore_lane(self, lane: int, sess) -> None:
        """Warm session: its canonical-layout columns copied into
        ``lane``."""
        stepfn.lane_insert(self.cache, self.mem, lane, sess["cache"],
                           sess["pos"], sess.get("mem"))
        self._counters[lane] = int(sess["counter"])

    def _prefill_scan_hop(self) -> None:
        """Run the shared mid-prompt stretch as one `stepfn.prefill_scan`.

        Fires only when the queue is drained and every active request is
        still prefilling, and stops one token short of the shortest
        remaining prompt, so every emission boundary (last prompt token,
        first sampled token, `first_token_time`) stays on the ordinary
        one-token step. It replaces exactly n ordinary steps and advances
        `steps`, the counters and the prompt cursors by the same n."""
        reqs = self.scheduler.active
        if self.scheduler.queue or not reqs:
            return
        if any(not r.prefilling for r in reqs.values()):
            return
        n = min(len(r.prompt) - r.prefill_done for r in reqs.values()) - 1
        if n < 1:
            return
        feed = np.zeros((self.lanes, n), np.int32)
        for lane, r in reqs.items():
            feed[lane] = r.prompt[r.prefill_done:r.prefill_done + n]
        self.cache, self.mem = stepfn.prefill_scan(
            self.params, self.cfg, self.cache, self.mem,
            torch.as_tensor(feed, device=self.device))
        self.steps += n
        for lane, r in reqs.items():
            self._counters[lane] += n
            r.prefill_done += n
            self._feed[lane] = r.prompt[r.prefill_done]

    def _evict_lane(self, lane: int) -> None:
        """Copy ``lane``'s session out to the store (the store copies each
        tensor to the host) and free the lane."""
        req = self.scheduler.evict(lane)
        sess = {
            "cache": {k: v[:, lane:lane + 1]
                      for k, v in self.cache.items() if k != "pos"},
            "pos": self.cache["pos"][lane:lane + 1],
            "counter": int(self._counters[lane]),
        }
        if self.mem is not None:
            sess["mem"] = tuple(type(st)(*(t[lane:lane + 1] for t in st))
                                for st in self.mem)
        self.sessions.put(req.user, sess)

    def _result(self, req: Request) -> dict:
        return {
            "id": req.id,
            "user": req.user,
            "tokens": self._out.pop(req.id),
            "prompt_len": len(req.prompt),
            "arrival": req.arrival,
            "first_token_time": req.first_token_time,
            "finish_time": req.finish_time,
        }
