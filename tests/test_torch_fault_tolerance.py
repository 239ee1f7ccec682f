"""The port's checkpointed training loop (`distributed/fault_tolerance.py`:
`ResilientLoop`, `StragglerPolicy`, `TransientError`), its asynchronous
checkpointer (`checkpoint/ckpt.py::AsyncCheckpointer`) and `train(ckpt_dir=)`
(`launch/train.py`), on the CPU, mirroring `tests/test_fault_tolerance.py`
and the checkpointer test of `tests/test_launch_misc.py`, and against the
JAX package's loop where it decides something (what it saves, when).

Stricter than JAX on purpose (ROADMAP §C), each pinned here: `wait`
returns only once the last save is committed, and raises the writer's
first error; `close` commits every queued save. Copied from JAX on
purpose: a resumed run takes its batches from the start of its iterator,
and the save made when a step's retries run out holds the state from
before that step under that step's number.

`train(ckpt_dir=)` runs the reduced `starcoder2_7b_sam` at B = 1, S = 64:
4 steps killed after 2 and resumed; the restored weights and AdamW state
are those saved, bit for bit.
"""
from __future__ import annotations

import os
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.distributed import fault_tolerance as jft
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.checkpoint import ckpt
from repro_torch.distributed import fault_tolerance as ft_mod
from repro_torch.distributed.fault_tolerance import (ResilientLoop,
                                                     StragglerPolicy,
                                                     TransientError)
from repro_torch.launch import train as train_mod


def _counter_step(state, batch):
    return state + 1, {"loss": float(state), "batch": batch}


def _saved_steps(loop):
    """Record the steps ``loop`` hands its checkpointer."""
    steps = []
    save = loop._ckpt.save

    def spy(step, tree):
        steps.append(step)
        return save(step, tree)

    loop._ckpt.save = spy
    return steps


def _flaky(fails, error=TransientError):
    """A failure hook that raises ``error`` ``fails[step]`` times."""
    left = dict(fails)

    def hook(step):
        if left.get(step, 0) > 0:
            left[step] -= 1
            raise error("injected")
    return hook


def test_resilient_loop_retries_transient_errors_as_jax_does(tmp_path):
    """Two failures at step 3 are retried; the state, the metrics log and
    the saves equal those of JAX's loop on the same schedule; the final
    save is committed when `run` returns."""
    runs = {}
    for name, Loop, error, zero in (
            ("port", ResilientLoop, TransientError, torch.zeros(())),
            ("jax", jft.ResilientLoop, jft.TransientError, jnp.zeros(()))):
        loop = Loop(_counter_step, str(tmp_path / name), ckpt_every=2,
                    failure_hook=_flaky({3: 2}, error))
        saves = _saved_steps(loop)
        state, log = loop.run(zero, iter(range(100)), 0, 6, log_every=2)
        runs[name] = (int(state), [(s, m["batch"]) for s, m in log], saves)
        loop._ckpt.close()
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == 6 and runs["port"][2] == [2, 4, 5]
    assert latest_step(str(tmp_path / "port")) == 5


def test_resilient_loop_saves_then_raises_when_retries_run_out(tmp_path):
    """When the retries of step 3 run out, the loop saves the state from
    before step 3 under step 3's number and raises, as JAX's does, so a
    restart resumes at step 4 and step 3's update is never made: a fault
    of the reference that the port copies on purpose (ROADMAP §C), which
    keeps the checkpoint steps JAX's. The port's save is committed before
    the error leaves `run`."""
    loop = ResilientLoop(_counter_step, str(tmp_path / "port"),
                         ckpt_every=100, max_retries=2,
                         failure_hook=_flaky({3: 3}))
    with pytest.raises(TransientError):
        loop.run(torch.zeros(()), iter(range(100)), 0, 6)
    state, step = restore_checkpoint(str(tmp_path / "port"), torch.zeros(()))
    assert step == 3 and int(state) == 3         # steps 0, 1 and 2 only
    state, start = loop.restore_or(torch.zeros(()))
    assert start == 4
    state, _ = loop.run(state, iter(range(100)), start, 6)
    assert int(state) == 5                       # 6 steps, 5 updates
    loop.close()

    jloop = jft.ResilientLoop(_counter_step, str(tmp_path / "jax"),
                              ckpt_every=100, max_retries=2,
                              failure_hook=_flaky({3: 3}, jft.TransientError))
    with pytest.raises(jft.TransientError):
        jloop.run(jnp.zeros(()), iter(range(100)), 0, 6)
    jloop._ckpt.close()
    jstate, jstart = jloop.restore_or(jnp.zeros(()))
    assert (int(jstate), jstart) == (3, 4)


def test_resilient_loop_resumes_and_restarts_its_batches(tmp_path):
    """A run stopped by a non-transient error at step 5 resumes at the step
    after its last save, with the saved state; its batch iterator starts
    again from the first batch, as JAX's does (ROADMAP §C: the batches the
    stopped run consumed are not skipped)."""
    def stop(step):
        if step == 5:
            raise RuntimeError("killed")

    seen = []

    def step_fn(state, batch):
        seen.append(batch)
        return state + 1, {}

    loop = ResilientLoop(step_fn, str(tmp_path), ckpt_every=2,
                         failure_hook=stop)
    with pytest.raises(RuntimeError, match="killed"):
        loop.run(torch.zeros(()), iter(range(100)), 0, 8)
    loop._ckpt.wait()
    loop.close()
    resumed = ResilientLoop(step_fn, str(tmp_path), ckpt_every=2)
    state, start = resumed.restore_or(torch.zeros(()))
    assert (start, int(state)) == (5, 5)
    seen.clear()
    state, _ = resumed.run(state, iter(range(100)), start, 8)
    assert int(state) == 8 and seen == [0, 1, 2]
    resumed.close()

    jloop = jft.ResilientLoop(lambda s, b: (s + 1, {}), str(tmp_path))
    jstate, jstart = jloop.restore_or(jnp.zeros(()))
    assert (jstart, int(jstate)) == (8, 8)       # the port's files, in JAX
    jloop._ckpt.close()


@pytest.mark.parametrize("policy", [jft.StragglerPolicy, StragglerPolicy],
                         ids=["jax", "port"])
def test_straggler_policy_verdicts_match_jax(policy):
    """The verdicts of JAX's `tests/test_fault_tolerance.py` (slow, then
    reshard; the re-baseline after it), and the port's equal JAX's over a
    mixed sequence of step times."""
    p = policy(deadline_factor=2.0, max_slow_steps=2)
    assert [p.observe(0.1) for _ in range(10)] == ["ok"] * 10
    assert [p.observe(1.0), p.observe(1.0)] == ["slow", "reshard"]
    assert all(p.observe(1.0) == "ok" for _ in range(10))
    assert p.observe(5.0) == "slow"
    times = np.random.default_rng(0).choice([0.1, 0.1, 0.1, 0.5, 2.0], 200)
    a = jft.StragglerPolicy(deadline_factor=3.0, max_slow_steps=3, window=16)
    b = StragglerPolicy(deadline_factor=3.0, max_slow_steps=3, window=16)
    verdicts = [(a.observe(t), b.observe(t)) for t in times]
    assert all(x == y for x, y in verdicts)
    assert {x for x, _ in verdicts} == {"ok", "slow", "reshard"}


def test_reshard_saves_and_calls_the_hook(tmp_path, monkeypatch):
    """On a 'reshard' verdict the loop saves, then hands the state to
    ``on_reshard`` (a hook: the elastic relayout is ROADMAP A11). Step
    times come from a fake clock: 1 s a step, 10 s for step 9."""
    clock = [0.0]
    monkeypatch.setattr(ft_mod, "time",
                        types.SimpleNamespace(time=lambda: clock[0]))

    def step_fn(state, batch):
        clock[0] += 10.0 if int(state) == 9 else 1.0
        return state + 1, {}

    called = []
    loop = ResilientLoop(step_fn, str(tmp_path), ckpt_every=100,
                         straggler=StragglerPolicy(deadline_factor=2.0,
                                                   max_slow_steps=1),
                         on_reshard=lambda s: called.append(int(s)) or s)
    saves = _saved_steps(loop)
    loop.run(torch.zeros(()), iter(range(100)), 0, 12)
    assert called == [10] and saves == [9, 11]
    loop.close()


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"a": torch.ones(4) * step})
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    tree, step = restore_checkpoint(str(tmp_path), {"a": torch.zeros(4)})
    assert step == 3 and torch.equal(tree["a"], torch.full((4,), 3.0))
    assert not ck.errors
    ck.close()


def test_async_checkpointer_copies_before_save_returns(tmp_path):
    """The tree is copied to the host on the calling thread: an in-place
    update right after `save` does not reach the checkpoint."""
    ck = AsyncCheckpointer(str(tmp_path))
    w = torch.zeros(3)
    ck.save(1, {"w": w})
    w.add_(5.0)
    ck.wait()
    tree, _ = restore_checkpoint(str(tmp_path), {"w": torch.zeros(3)})
    assert torch.equal(tree["w"], torch.zeros(3))
    ck.close()


def test_wait_returns_only_when_the_last_save_is_committed(tmp_path,
                                                           monkeypatch):
    """A writer slowed down: JAX's `wait` returns once the queue is empty,
    while the last save is still being written; the port's returns after
    it is committed (stricter on purpose, ROADMAP §C)."""
    from repro.checkpoint import ckpt as jckpt
    results = {}
    for name, module, Ckpt, leaf in (
            ("port", ckpt, AsyncCheckpointer, torch.ones(2)),
            ("jax", jckpt, jckpt.AsyncCheckpointer, jnp.ones(2))):
        slow_save = module.save_checkpoint

        def save(*args, slow_save=slow_save, **kw):
            time.sleep(1.0)
            return slow_save(*args, **kw)
        monkeypatch.setattr(module, "save_checkpoint", save)
        ck = Ckpt(str(tmp_path / name))
        ck.save(7, {"a": leaf})
        ck.wait()
        results[name] = latest_step(str(tmp_path / name))
        ck.close()
    assert results == {"port": 7, "jax": None}


def test_close_returns_when_every_queued_save_is_committed(tmp_path,
                                                          monkeypatch):
    """`close` stops the writer only after the saves it holds are on disk
    (JAX's gives it 10 s): `train(ckpt_dir=)` closes its loop while an
    error leaves, and a queued save is then not lost."""
    slow_save = ckpt.save_checkpoint

    def save(*args, **kw):
        time.sleep(0.3)
        return slow_save(*args, **kw)
    monkeypatch.setattr(ckpt, "save_checkpoint", save)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(2)})
    ck.save(2, {"a": torch.ones(2)})
    ck.close()
    assert not ck._worker.is_alive() and not ck.errors
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_2"]


def test_wait_raises_a_writer_error(tmp_path, monkeypatch):
    def broken(*args, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "save_checkpoint", broken)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert len(ck.errors) == 1
    ck.close()


# --------------------------------------------------------------------------
# train(ckpt_dir=) on the reduced LM
# --------------------------------------------------------------------------

TRAIN_KW = dict(steps=4, batch=1, seq=64, device="cpu", use_reduced=True,
                ckpt_every=1, log_every=1)


def test_train_with_a_checkpoint_dir_kills_and_resumes(tmp_path,
                                                       monkeypatch):
    saved, restored = {}, []

    def kill(step):
        if step == 2:
            raise RuntimeError("killed")
    hooks = [kill, None]

    class Spy(ResilientLoop):
        def __post_init__(self):
            super().__post_init__()
            self.failure_hook = hooks.pop(0)
            save = self._ckpt.save

            def spy(step, tree):
                saved[step] = pytree.tree_map(lambda t: t.clone(), tree)
                return save(step, tree)
            self._ckpt.save = spy

        def restore_or(self, template):
            out = super().restore_or(template)
            # A copy: the run then updates the parameters in place.
            restored.append(pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                out))
            return out

    monkeypatch.setattr(train_mod, "ResilientLoop", Spy)
    with pytest.raises(RuntimeError, match="killed"):
        train_mod.train(ckpt_dir=str(tmp_path), **TRAIN_KW)
    assert sorted(saved) == [1]
    (params, opt_state), log = train_mod.train(ckpt_dir=str(tmp_path),
                                               **TRAIN_KW)
    (r_params, r_opt), start = restored[-1]
    assert start == 2 and int(r_opt.count) == 2
    for a, b in zip(pytree.tree_leaves(saved[1]),
                    pytree.tree_leaves((r_params, r_opt))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [s for s, _ in log] == [2, 3] and sorted(saved) == [1, 3]
    assert int(opt_state.count) == 4
    assert all(np.isfinite(m["loss"]) for _, m in log)
    with pytest.raises(NotImplementedError, match="A11"):
        train_mod.train(ckpt_dir=str(tmp_path), mesh=object(), **TRAIN_KW)
