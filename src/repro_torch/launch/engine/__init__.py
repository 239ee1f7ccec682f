"""The continuous-batching serving engine with persistent per-user memory
sessions, the JAX package's `launch/engine/`:

* `Request`, `Scheduler` — FIFO lane assignment (scheduler.py);
* `SessionStore` — canonical-layout LRU session store with disk spill
  (sessions.py);
* `stepfn` — the whole-batch decode step and its sampler (stepfn.py);
* `ServeEngine` — ties them together (engine.py).
"""
from repro_torch.launch.engine.engine import ServeEngine
from repro_torch.launch.engine.scheduler import Request, Scheduler
from repro_torch.launch.engine.sessions import SessionStore

__all__ = ["Request", "Scheduler", "SessionStore", "ServeEngine"]
