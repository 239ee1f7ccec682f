"""The port's continuous-batching serving engine (`repro_torch.launch.
engine`: scheduler, sampler, sessions, `ServeEngine`, `serve_continuous`)
against the JAX package's, on the CPU, at the reduced `starcoder2_7b_sam`
(2 layers, d 128, a memory group per layer of 64 slots of 16, K = 4) at
f32 compute, with JAX's weights (`init_params(PRNGKey(0))`) carried
across by `convert.lm_params_from_jax`.

- The scheduler: the JAX suite's five scheduler scenarios
  (`tests/test_serve_engine.py`), every lane assignment equal.
- The sampler: keys and random bits equal `jax.random`'s bit for bit;
  the sampled token equals `jax.random.categorical`'s wherever the top
  two perturbed logits lie more than 1e-5 apart (the logarithms of the
  Gumbel draw may differ from XLA's by an ulp).
- The engine against JAX's on the same requests (greedy and sampled,
  lane churn with a refill on the finishing step, a cold session
  mid-batch): token streams equal; the final sessions' cache, memory and
  read weights within `SLICE_TOL` = 1e-4 of max(1, |value|), the bar of
  the whole decode slice in `tests/test_torch_lm.py` (torch and XLA sum
  in other orders, and the drift compounds over the steps: 3e-6 after the
  5 steps of a 2-token prompt and 4 tokens, 1.6e-5 after the 11 of the
  cold scenario's long request), usage, positions, steps, counters and
  the rows read exactly (each read's rows as a set with
  their weights, as `tests/test_torch_lm.py` compares them). The prompts
  were chosen so that no read of an active lane has a near-tie straddling
  K (asserted: rows written from zero by one head in one step are
  parallel, so their similarities tie within 1e-6, and torch and XLA may
  order them either way).
- In the port alone: the evict/restore round trip across two engines
  sharing a store with a disk spill between them, bit for bit; a rejected
  request keeps its session and its lane; a live `rescale` 4 → 2 → 4
  lanes, bit for bit; `serve_continuous`.
- A session JAX's engine left (spilled to disk by its `SessionStore`, or
  taken and converted by `convert.session_from_jax`) continues in the
  port's engine with JAX's tokens.

JAX's engine makes new jitted step functions per instance; a
module-scoped patch memoizes its step factories by config so that it
compiles once per shape.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import engine as jengine
from repro.launch.engine import engine as jengine_mod
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import (Request, Scheduler, ServeEngine,
                                       SessionStore, stepfn)
from repro_torch.models import lm

ARCH = "starcoder2_7b_sam"
SLICE_TOL = 1e-4
READ_MARGIN = 1e-6
# Prompts with no read near-tie at K in any active lane (module docstring).
MODES_PROMPT = [261, 322]
CHURN_PROMPT = [39, 9]
COLD = dict(long=[319, 297], x=[460, 153], y=[461], cold=[344])
ROUND = dict(u=[416, 332, 467, 258], noise=[310, 497], other=[373, 324, 278])


def _configs():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)),
                               compute_dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(ARCH)),
                              compute_dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    """(JAX config, port config, port weights converted from JAX's) with
    JAX's step factories memoized for the module."""
    jcfg, cfg = _configs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        for name in ("make_engine_step", "make_prefill_scan",
                     "make_lane_insert"):
            mp.setattr(jengine_mod, name,
                       functools.lru_cache(getattr(jengine_mod, name)))
        yield jcfg, cfg, tp


# --------------------------------------------------------------------------
# Helpers
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _reads(eng, seen):
    """Record every read of the engine's active lanes as (q, memory, k,
    valid_n)."""
    fused_read = ops.fused_read

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        out = fused_read(q, mem, beta, k, valid_n=valid_n)
        act = sorted(eng.scheduler.active)
        seen.append((q[act].clone(), mem[act].clone(), k, valid_n))
        return out

    ops.fused_read = record
    try:
        yield
    finally:
        ops.fused_read = fused_read


def _assert_read_margins(seen):
    """No read has rows within READ_MARGIN of its K-th similarity (f64) on
    both sides of K, but for exactly equal rows (both sides order those by
    index)."""
    assert seen
    for q, mem, k, valid_n in seen:
        sims = torch.einsum("bhw,bnw->bhn", ref._normalize(q.double()),
                            ref._normalize(mem[:, :valid_n].double()))
        v = sims.sort(dim=-1, descending=True).values[..., k - 1:k]
        band = (sims - v).abs() <= READ_MARGIN
        straddles = (sims > v + READ_MARGIN).sum(-1) + band.sum(-1) > k
        inexact = (band & (sims != v)).any(-1)
        assert not (straddles & inexact).any(), "a read near-tie at K"


def _jax_engine(jcfg, **kw):
    return jengine.ServeEngine(jcfg, **kw)


def _port_engine(cfg, tp, **kw):
    return ServeEngine(cfg, params=tp, device="cpu", **kw)


def _run_port(eng, requests, seen=None):
    with _reads(eng, seen) if seen is not None else contextlib.nullcontext():
        return eng.run(requests)


def _by_user(results):
    return {r["user"]: r["tokens"] for r in results}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    want = _np(want).astype(np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, atol=SLICE_TOL * scale,
                               rtol=0)


def _sorted_read(idx, w):
    idx, w = _np(idx), _np(w)
    order = np.argsort(idx, axis=-1, kind="stable")
    return (np.take_along_axis(idx, order, -1),
            np.take_along_axis(w, order, -1))


def _assert_session_matches_jax(got, want):
    """A port session against a JAX one: floats within SLICE_TOL of the
    scale, integers exact, reads as sets with their weights."""
    for key in ("k", "v"):
        _close(got["cache"][key], want["cache"][key])
    np.testing.assert_array_equal(_np(got["pos"]), np.asarray(want["pos"]))
    assert int(got["counter"]) == int(want["counter"])
    for g, w in zip(got["mem"], want["mem"], strict=True):
        _close(g.memory, w.memory)
        np.testing.assert_array_equal(_np(g.last_access),
                                      np.asarray(w.last_access))
        np.testing.assert_array_equal(_np(g.step), np.asarray(w.step))
        g_idx, g_w = _sorted_read(g.read_idx, g.read_w)
        w_idx, w_w = _sorted_read(w.read_idx, w.read_w)
        np.testing.assert_array_equal(g_idx, w_idx)
        _close(g_w, w_w)


def _assert_sessions_bit_equal(a, b):
    for key in ("k", "v"):
        assert torch.equal(a["cache"][key], b["cache"][key])
    assert torch.equal(a["pos"], b["pos"])
    assert int(a["counter"]) == int(b["counter"])
    for sa, sb in zip(a["mem"], b["mem"], strict=True):
        for name in sa._fields:
            assert torch.equal(getattr(sa, name), getattr(sb, name)), name


# --------------------------------------------------------------------------
# The scheduler: the JAX suite's scenarios on both sides
# --------------------------------------------------------------------------

def _admitted(s):
    return [(lane, r.user, list(r.prompt)) for lane, r in s.admit()]


def _fifo(S, R):
    s = S(lanes=2)
    for i in range(5):
        s.submit(R(f"u{i}", [1], 1))
    out = [_admitted(s), _admitted(s), s.free_lanes]
    s.evict(0)
    return out + [s.free_lanes, _admitted(s)]


def _lowest_lane(S, R):
    s = S(lanes=3)
    for i in range(3):
        s.submit(R(f"u{i}", [1], 1))
    out = [_admitted(s)]
    s.evict(2)
    s.evict(0)
    for u in ("v0", "v1"):
        s.submit(R(u, [2], 1))
    return out + [_admitted(s)]


def _no_starvation(S, R):
    s = S(lanes=2)
    for i in range(20):
        s.submit(R(f"u{i}", [1], 1))
    served = []
    while s.has_work:
        served.append(_admitted(s))
        for lane in list(s.active):
            s.evict(lane)
    return served


def _hold_back(S, R):
    s = S(lanes=2)
    for r in (R("a", [1], 1), R("a", [2], 1), R("b", [1], 1),
              R("c", [1], 1)):
        s.submit(r)
    out = [_admitted(s)]
    s.evict(1)
    out.append(_admitted(s))
    s.evict(0)
    s.evict(1)
    return out + [_admitted(s)]


def _replicas(S, R):
    try:
        S(lanes=5, replicas=2)
        refused = False
    except ValueError as e:
        refused = "split evenly" in str(e)
    s = S(lanes=4, replicas=2)
    for i in range(4):
        s.submit(R(f"u{i}", [1], 1))
    out = [refused, s.lanes_per_replica, _admitted(s)]
    s.evict(2)
    s.evict(0)
    out.append(dict(s.affinity))
    s.submit(R("u2", [1], 1))
    out.append(_admitted(s))
    s.affinity["u9"] = 1
    s.submit(R("u9", [1], 1))
    return out + [_admitted(s)]


@pytest.mark.parametrize("scenario", [_fifo, _lowest_lane, _no_starvation,
                                      _hold_back, _replicas],
                         ids=lambda f: f.__name__.strip("_"))
def test_scheduler_matches_jax(scenario):
    want = scenario(jengine.Scheduler, jengine.Request)
    got = scenario(Scheduler, Request)
    assert got == want and want


# --------------------------------------------------------------------------
# The sampler
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, -1234567])
def test_sampler_keys_and_bits_match_jax(seed):
    for counter in range(4):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), jnp.int32(seed)), jnp.int32(counter))
        got = stepfn.sample_keys(torch.tensor([seed], dtype=torch.int32),
                                 torch.tensor([counter], dtype=torch.int32))
        np.testing.assert_array_equal(got[0].numpy().astype(np.uint32),
                                      np.asarray(jax.random.key_data(key)))
        np.testing.assert_array_equal(
            stepfn.random_bits(got, 1000)[0].numpy().astype(np.uint32),
            np.asarray(jax.random.bits(key, (1000,))))


def test_sampled_token_matches_jax_categorical():
    """64 rows of logits (V = 512) per counter 0-3, per-row seeds: the
    port's draw equals `jax.random.categorical` under the engine's keys
    wherever the top two perturbed logits lie more than 1e-5 apart (all
    but a handful)."""
    rng = np.random.default_rng(0)
    B, V = 64, 512
    seeds = rng.integers(-2 ** 31, 2 ** 31, B).astype(np.int32)
    compared = 0
    for counter in range(4):
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        counters = np.full(B, counter, np.int32)
        want = np.asarray(jax.vmap(lambda s, c, lg: jax.random.categorical(
            jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), s),
                               c), lg))(seeds, counters, logits))
        t_seeds, t_counters = torch.tensor(seeds), torch.tensor(counters)
        t_logits = torch.tensor(logits)
        got = stepfn.select(t_logits, np.zeros(B, bool), t_seeds,
                            t_counters).numpy()
        noisy = stepfn.gumbel(stepfn.sample_keys(t_seeds, t_counters), V) \
            + t_logits
        top2 = noisy.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1] > 1e-5).numpy()
        np.testing.assert_array_equal(got[clear], want[clear])
        compared += int(clear.sum())
        greedy = stepfn.select(t_logits, np.ones(B, bool), t_seeds,
                               t_counters).numpy()
        np.testing.assert_array_equal(greedy, logits.argmax(-1))
    assert compared >= 4 * B - 4


# --------------------------------------------------------------------------
# The engine against JAX's
# --------------------------------------------------------------------------

def _modes(R, greedy, seed):
    return [[R(user="u", prompt=MODES_PROMPT, max_new_tokens=4,
               greedy=greedy, sample_seed=seed)]]


def _churn(R):
    return [[R(user=f"u{i}", prompt=CHURN_PROMPT, max_new_tokens=2)
             for i in range(3)]]


def _cold(R):
    long_ = lambda: R(user="long", prompt=COLD["long"], max_new_tokens=10)
    cold = lambda: R(user="cold", prompt=COLD["cold"], max_new_tokens=3)
    return [[long_()], [cold()],
            [long_(), R(user="x", prompt=COLD["x"], max_new_tokens=2),
             R(user="y", prompt=COLD["y"], max_new_tokens=2), cold()]]


SCENARIOS = {
    "greedy": functools.partial(_modes, greedy=True, seed=0),
    "sampled": functools.partial(_modes, greedy=False, seed=1),
    "sampled_seed_2": functools.partial(_modes, greedy=False, seed=2),
    "churn_refill": _churn,
    "cold_mid_batch": _cold,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_jax(models, name):
    """Each run of the scenario in a fresh 2-lane engine on both sides:
    the same tokens, the same engine steps, and every user's final
    session."""
    jcfg, cfg, tp = models
    runs = SCENARIOS[name]
    port_out, seen = [], []
    for jreqs, treqs in zip(runs(jengine.Request), runs(Request)):
        je = _jax_engine(jcfg, lanes=2, max_len=64)
        te = _port_engine(cfg, tp, lanes=2, max_len=64)
        want = _by_user(je.run(jreqs))
        got = _by_user(_run_port(te, treqs, seen))
        assert got == want
        assert te.steps == je.steps
        for user in want:
            _assert_session_matches_jax(te.sessions.take(user),
                                        je.sessions.take(user))
        port_out.append(got)
    _assert_read_margins(seen)
    if name == "churn_refill":        # 3 steps a request, 2 waves
        assert te.steps == 6
    if name == "cold_mid_batch":      # neighbour unperturbed, cold fresh
        assert port_out[2]["long"] == port_out[0]["long"]
        assert port_out[2]["cold"] == port_out[1]["cold"]
    if name.startswith("sampled"):
        assert port_out[0]["u"] != _by_user(_run_port(
            _port_engine(cfg, tp, lanes=2, max_len=64),
            _modes(Request, True, 0)[0]))["u"]


# --------------------------------------------------------------------------
# The port alone: evict/restore, rejection, rescale, serve_continuous
# --------------------------------------------------------------------------

def _u(**kw):
    return Request(user="u", greedy=False, sample_seed=42, **kw)


def _noise(max_new_tokens=6):
    return Request(user="noise", prompt=ROUND["noise"],
                   max_new_tokens=max_new_tokens, greedy=False,
                   sample_seed=7)


def test_evict_restore_round_trip_is_bit_exact(models, tmp_path):
    """User u (sampled) 8 tokens uninterrupted against 4 + 4 across two
    engines sharing a store of one hot session: u spills to disk when its
    neighbour finishes, and comes back in another lane beside another
    neighbour."""
    _, cfg, tp = models
    e1 = _port_engine(cfg, tp, lanes=3, max_len=64)
    full = _by_user(e1.run([_u(prompt=ROUND["u"], max_new_tokens=8),
                            _noise()]))
    sess_full = e1.sessions.take("u")

    store = SessionStore(num_slots=cfg.memory.num_slots, capacity=1,
                         spill_dir=str(tmp_path / "spill"))
    a = _port_engine(cfg, tp, lanes=3, max_len=64, session_store=store)
    first = _by_user(a.run([_u(prompt=ROUND["u"], max_new_tokens=4),
                            _noise(max_new_tokens=8)]))["u"]
    assert store.spills == 1 and "u" in store
    b = _port_engine(cfg, tp, lanes=3, max_len=64, session_store=store)
    b.submit(Request(user="other", prompt=ROUND["other"], max_new_tokens=9,
                     greedy=False, sample_seed=5))    # takes lane 0
    res = b.run([_u(prompt=[first[-1]], max_new_tokens=4)])
    assert store.restores == 1
    assert first + _by_user(res)["u"] == full["u"]
    _assert_sessions_bit_equal(b.sessions.take("u"), sess_full)
    spilled = [d for _, dirs, _ in os.walk(tmp_path / "spill") for d in dirs]
    assert spilled and not any(d.startswith("tmp_") for d in spilled)


def test_rejected_request_keeps_session_and_lane(models):
    _, cfg, tp = models
    eng = _port_engine(cfg, tp, lanes=2, max_len=16)
    eng.run([Request(user="u", prompt=[3, 7], max_new_tokens=4)])
    before = eng.sessions.peek("u")
    eng.submit(Request(user="u", prompt=[5], max_new_tokens=16))
    with pytest.raises(ValueError, match="cannot fit"):
        eng.run()
    assert eng.sessions.peek("u") is before     # not consumed
    assert eng.scheduler.free_lanes == 2        # the lane is free again
    res = eng.run([Request(user="u", prompt=[2], max_new_tokens=2)])
    assert len(res) == 1 and len(res[0]["tokens"]) == 2
    assert int(eng.sessions.peek("u")["pos"][0]) == 7


def test_rejection_leaves_the_other_admissions_whole(models):
    """Two admissions in one step, the first rejected: the second lane is
    still set up, so its tokens equal a run without the rejected request
    (JAX's engine raises before setting it up, and its next step fails
    with a KeyError: ROADMAP §C)."""
    _, cfg, tp = models
    alone = _by_user(_port_engine(cfg, tp, lanes=2, max_len=16).run(
        [Request(user="w", prompt=[6, 1], max_new_tokens=3)]))
    eng = _port_engine(cfg, tp, lanes=2, max_len=16)
    eng.run([Request(user="v", prompt=[4], max_new_tokens=2),
             Request(user="u", prompt=[3, 7], max_new_tokens=4)])
    eng.submit(Request(user="u", prompt=[5], max_new_tokens=16))
    eng.submit(Request(user="w", prompt=[6, 1], max_new_tokens=3))
    with pytest.raises(ValueError, match="cannot fit"):
        eng.step()
    assert _by_user(eng.run()) == alone


def test_live_rescale_is_bit_exact(models):
    """A 2-replica engine of 4 lanes shrinks to 1 replica (2 lanes)
    mid-decode and grows back: tokens and the final session equal an
    uninterrupted run; request ids keep counting."""
    _, cfg, tp = models
    P1, P2 = ROUND["u"], [5]
    ref_eng = _port_engine(cfg, tp, lanes=4, max_len=64, replicas=2)
    tok_ref = _by_user(ref_eng.run([_u(prompt=P1, max_new_tokens=8),
                                    _noise()]))
    tok_ref2 = ref_eng.run([_u(prompt=P2, max_new_tokens=4)])[0]["tokens"]
    sess_ref = ref_eng.sessions.take("u")

    eng = _port_engine(cfg, tp, lanes=4, max_len=64, replicas=2)
    eng.submit(_u(prompt=P1, max_new_tokens=8))
    eng.submit(_noise())
    done = []
    for _ in range(6):
        done.extend(eng.step())
    assert any(r.user == "u" for r in eng.scheduler.active.values())
    eng.rescale(replicas=1)
    assert eng.replicas == 1 and eng.lanes == 2
    while eng.scheduler.has_work:
        done.extend(eng.step())
    assert _by_user(done) == tok_ref
    eng.rescale(replicas=2, lanes=4)
    follow = eng.submit(_u(prompt=P2, max_new_tokens=4))
    assert follow.id > max(r["id"] for r in done)
    assert eng.run()[0]["tokens"] == tok_ref2
    _assert_sessions_bit_equal(eng.sessions.take("u"), sess_ref)


def test_serve_continuous(models):
    _, cfg, tp = models
    res = tserve.serve_continuous(ARCH, lanes=2, requests=3, prompt_len=2,
                                  gen_len=2, max_len=32, device="cpu")
    assert len(res["results"]) == 3
    assert all(len(r["tokens"]) == 2 for r in res["results"])
    assert res["tok_per_s"] > 0 and res["steps"] == 6
    # The same requests through an engine built by hand, on JAX's weights.
    got = tserve._serve_continuous(cfg, lanes=2, requests=3, prompt_len=2,
                                   gen_len=2, max_len=32, seed=0,
                                   device="cpu", params=tp)
    eng = _port_engine(cfg, tp, lanes=2, max_len=32)
    rng = np.random.default_rng(0)
    want = eng.run([Request(user=f"user{i}", prompt=rng.integers(
        1, cfg.vocab_size, 2).tolist(), max_new_tokens=2, sample_seed=i)
        for i in range(3)])
    assert _by_user(got["results"]) == _by_user(want)


# --------------------------------------------------------------------------
# A JAX session continued by the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["spilled_to_disk", "converted"])
def test_jax_session_continues_in_port(models, tmp_path, route):
    """JAX's engine serves u 4 tokens beside a longer neighbour into a
    store of one hot session, so u spills to disk. The port takes that
    session (the spill directory through `checkpoint.ckpt`, or JAX's
    restored tree through `convert.session_from_jax`) and continues u for
    4 more tokens: JAX's tokens and session."""
    from repro_torch.checkpoint import ckpt
    jcfg, cfg, tp = models
    spill = tmp_path / "jax_spill"
    jstore = jengine.SessionStore(num_slots=jcfg.memory.num_slots,
                                  capacity=1, spill_dir=str(spill))
    ju = dict(user="u", greedy=False, sample_seed=42)
    je = _jax_engine(jcfg, lanes=3, max_len=64, session_store=jstore)
    first = _by_user(je.run([
        jengine.Request(prompt=ROUND["u"], max_new_tokens=4, **ju),
        jengine.Request(user="noise", prompt=ROUND["noise"],
                        max_new_tokens=8, greedy=False, sample_seed=7)]))
    assert jstore.spills == 1
    shutil.copytree(spill / "session_u", tmp_path / "copy")
    if route == "converted":
        sess = convert.session_from_jax(jstore.peek("u"), device="cpu")
    else:
        cache = lm.init_cache(cfg, 1, 64, per_lane_pos=True, device="cpu")
        template = {"cache": {k: cache[k] for k in ("k", "v")},
                    "pos": cache["pos"], "counter": 0,
                    "mem": lm.init_memory_states(cfg, 1, per_lane_step=True,
                                                 device="cpu")}
        sess, _ = ckpt.restore_checkpoint(str(tmp_path / "copy"), template)
    want = je.run([jengine.Request(prompt=[first["u"][-1]],
                                   max_new_tokens=4, **ju)])
    te = _port_engine(cfg, tp, lanes=3, max_len=64)
    te.sessions.put("u", sess)
    seen = []
    got = _run_port(te, [Request(prompt=[first["u"][-1]], max_new_tokens=4,
                                 **ju)], seen)
    _assert_read_margins(seen)
    assert _by_user(got) == _by_user(want)
    _assert_session_matches_jax(te.sessions.take("u"), je.sessions.take("u"))


def test_refusals(models, tmp_path):
    _, cfg, tp = models
    with pytest.raises(ValueError, match="ROADMAP A11, item 4"):
        ServeEngine(cfg, params=tp, device="cpu", mesh=object())
    eng = _port_engine(cfg, tp, lanes=2)
    with pytest.raises(ValueError, match="ROADMAP A11, item 4"):
        eng.rescale(mesh=object())
    with pytest.raises(ValueError, match="split evenly"):
        _port_engine(cfg, tp, lanes=3, replicas=2)
    with pytest.raises(ValueError, match="spill_dir"):
        SessionStore(num_slots=64, capacity=1)
    with pytest.raises(ValueError, match="prompt token"):
        eng.submit(Request(user="u", prompt=[], max_new_tokens=1))
