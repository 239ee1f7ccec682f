"""Fault tolerance and straggler handling of the training loop, the port of
`repro/distributed/fault_tolerance.py`.

One process, so failures are injected (``failure_hook``): the control
flow is the reference's.

* `ResilientLoop` wraps a step function with checkpoints on an
  `AsyncCheckpointer` every ``ckpt_every`` steps and at the end, a restore
  of the newest one on restart (`restore_or`), bounded retries of a step
  that raises `TransientError` (once they run out, a save, committed
  before the error goes on), and a straggler detector. As in JAX, a
  resumed run takes its batches from the start of the iterator it is
  given: the batches the killed run consumed are not skipped (ROADMAP
  §C).
* `StragglerPolicy` judges a step by its time against the median of the
  last ``window``: 'slow' beyond ``deadline_factor`` times the median,
  'reshard' after ``max_slow_steps`` slow steps in a row. The loop then
  saves and calls ``on_reshard`` with the state: a hook only, since the
  elastic relayout onto fewer devices is ROADMAP A11 item 6.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint


@dataclasses.dataclass
class StragglerPolicy:
    deadline_factor: float = 3.0
    max_slow_steps: int = 5
    window: int = 32

    def __post_init__(self):
        self._times: list = []
        self._slow = 0

    def reset(self):
        """Forget the timings and the streak (after a 'reshard': the new
        layout has its own normal step time, and its first steps judged
        against the old median would all read slow)."""
        self._times = []
        self._slow = 0

    def observe(self, dt: float) -> str:
        """Returns 'ok', 'slow' or 'reshard'. The first 8 steps after a
        start or a reset are only observed."""
        self._times.append(dt)
        self._times = self._times[-self.window:]
        med = sorted(self._times)[len(self._times) // 2]
        if len(self._times) >= 8 and dt > self.deadline_factor * med:
            self._slow += 1
            if self._slow >= self.max_slow_steps:
                self.reset()
                return "reshard"
            return "slow"
        self._slow = 0
        return "ok"


class TransientError(RuntimeError):
    """A failure worth retrying (a preemption, a collective's timeout)."""


@dataclasses.dataclass
class ResilientLoop:
    step_fn: Callable                   # (state, batch) -> (state, metrics)
    ckpt_dir: str
    ckpt_every: int = 100
    max_retries: int = 3
    straggler: StragglerPolicy = dataclasses.field(
        default_factory=StragglerPolicy)
    on_reshard: Optional[Callable] = None
    failure_hook: Optional[Callable] = None      # failure injection: (step)

    def __post_init__(self):
        self._ckpt = AsyncCheckpointer(self.ckpt_dir)

    def restore_or(self, state_template):
        """(the newest checkpoint restored into ``state_template``'s
        structure, the step after it), or (the template, 0)."""
        state, step = restore_checkpoint(self.ckpt_dir, state_template)
        if state is None:
            return state_template, 0
        return state, step + 1

    def run(self, state, batches, start_step: int, num_steps: int,
            log_every: int = 50):
        """Steps ``start_step`` .. ``num_steps`` - 1, a batch each from
        ``batches``. Returns (state, [(step, metrics)] every ``log_every``
        steps); the final state is committed to disk when it returns."""
        metrics_log = []
        step = start_step
        while step < num_steps:
            batch = next(batches)
            retries = 0
            while True:
                t0 = time.time()
                try:
                    if self.failure_hook is not None:
                        self.failure_hook(step)
                    state, metrics = self.step_fn(state, batch)
                    break
                except TransientError:
                    retries += 1
                    if retries > self.max_retries:
                        # Committed before the error leaves: the writer is
                        # a daemon thread, which an exiting process kills.
                        self._ckpt.save(step, state)
                        self._ckpt.wait()
                        raise
            dt = time.time() - t0
            if (self.straggler.observe(dt) == "reshard"
                    and self.on_reshard is not None):
                self._ckpt.save(step, state)
                state = self.on_reshard(state)
            if step % self.ckpt_every == 0 and step > start_step:
                self._ckpt.save(step, state)
            if step % log_every == 0:
                metrics_log.append((step, metrics))
            step += 1
        self._ckpt.save(step - 1, state)
        self._ckpt.wait()
        return state, metrics_log

    def close(self):
        """Stop the checkpoint writer after the saves it holds."""
        self._ckpt.close()
