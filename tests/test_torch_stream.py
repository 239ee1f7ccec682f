"""The streaming trainer of the port (`core/training.py`:
`make_streaming_train_step`, `train_task_streaming`, `TrainLoopState`) and
the redo that keeps a carry live across chunks (`core/unroll.py::
roll_forward`), on the CPU, against the JAX package.

* Chunk steps against JAX's `make_streaming_train_step`: the same weights,
  optimizer state, carry and numpy inputs, three chunks with the carry
  threaded, for ``sam`` (sparse, chunked, naive; the JAX side also under
  ``pallas-interpret`` once), ``sam_ann``, ``sam`` on bf16 and int8 rows,
  ``sdnc`` and ``dam``. After every chunk: loss, bit error, every
  parameter, the RMSProp accumulators and every carry leaf.
* The redo: after a sparse or chunked backward, `roll_forward` gives every
  dense buffer of the forward's final state back bit for bit (``sam`` on
  f32, bf16 and int8 rows, ``sam_ann``, ``sdnc`` on f32 and bf16 rows),
  and a step from it runs; its log is O(T·J·W) (the same bytes at two N).
  Two chained unrolls, then roll_forward: the second one's buffers.
* The loop, mirroring `tests/test_streaming_ckpt.py`: the loop state's
  round trip, a legacy checkpoint, unknown leaves and a mismatched
  structure, a mid-episode kill and resume against an uninterrupted run
  (bit for bit), the curriculum's level; the (episode, chunk, level)
  history and the checkpoint steps against JAX's `train_task_streaming`;
  streaming checkpoints (f32 and int8 rows) across the two packages.

Sizes: B = 2, N = 32, W = 16, H = 2, K = 2, hidden 16, 4 bits, the copy
task with max_len 5 (T = 12), chunks of 4.

The chunk steps start from nonzero RMSProp accumulators, as
`tests/test_torch_train.py` and `tests/test_torch_dtypes.py` do: from
zero ones RMSProp's first update is ±lr·√10 whatever |g|, so a gradient
that cancels to ~0 turns rounding into an O(lr) step (the AdamW note of
ROADMAP §C).

Tolerances (ROADMAP north star): floats within 1e-5 (loss, parameters,
accumulators, float carry leaves); integer carry leaves exact (usage
tables, read indices, LSH buckets and cursors, int8 codes); int8 scales
within rtol 1e-6 (`tests/test_torch_dtypes.py`: torch and XLA sum the
controller in other orders, and a scale carries its last bit). bf16
rows bit for bit, as `tests/test_torch_dtypes.py` holds them from equal
weights: so on bf16 rows each chunk starts from JAX's weights,
accumulators and carry. Threaded on its own weights, which agree with
JAX's to 1e-5 and not bit for bit, the port's bf16 rows drift a bf16 ulp
at a time where a write rounds the other way (12 of 2,112 elements one
ulp apart after the third chunk, and more as rows are written again).
"""
from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.checkpoint import ckpt as jckpt
from repro.core import training as jtraining
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core import dnc, training, unroll
from repro_torch.core.cell import SAMCell, SDNCCell
from repro_torch.core.sam import SAMConfig
from repro_torch.core.types import (ControllerConfig, MemoryConfig,
                                    tree_bytes)
from repro_torch.data.curriculum import Curriculum
from repro_torch.data.tasks import copy_task
from repro_torch.optim import optimizers as opt

TOL = 1e-5
SCALE_RTOL = 1e-6
B, N, W, H, K, HIDDEN, BITS = 2, 32, 16, 2, 2, 16, 4
MAX_LEN, CHUNK, LR = 5, 4, 1e-3
LSH = dict(lsh_tables=2, lsh_bits=3, lsh_bucket_size=8)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _mem_kw(dtype="float32", n=N):
    return dict(num_slots=n, word_size=W, num_heads=H, k=K, mem_dtype=dtype,
                **LSH)


def _specs(kind, dtype="float32", mode="sparse", backend="ref"):
    chunk = 2 if mode == "chunked" else None
    ctl = dict(input_size=BITS + 2, hidden_size=HIDDEN, output_size=BITS)
    jspec = jtraining.ModelSpec(
        kind, JaxMemoryConfig(backend=backend, **_mem_kw(dtype)),
        JaxControllerConfig(**ctl), sparse_bptt=mode != "naive",
        bptt_chunk=chunk)
    spec = training.ModelSpec(
        kind, MemoryConfig(**_mem_kw(dtype)), ControllerConfig(**ctl),
        sparse_bptt=mode != "naive", bptt_chunk=chunk)
    return jspec, spec


def _to_port(jtree, template):
    """A JAX tree (numpy leaves) in the structure of the port's
    ``template``, leaf for leaf in the checkpoints' path order (bf16
    through `convert`)."""
    paths = [p for p, _ in ckpt.flatten_with_paths(template)]
    jflat = ckpt.flatten_with_paths(jtree)
    assert [p for p, _ in jflat] == paths
    leaves = [convert.memory_from_jax(x, device="cpu")
              if str(np.asarray(x).dtype) == "bfloat16"
              else torch.tensor(np.asarray(x)) for _, x in jflat]
    return ckpt._unflatten(template, iter(leaves))


def _assert_carry(carry, jcarry):
    got, want = (ckpt.flatten_with_paths(t) for t in (carry, _numpy(jcarry)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), np.asarray(w).view(np.int16),
                err_msg=path)
            continue
        g = np.asarray(g)
        if not np.issubdtype(np.asarray(w).dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif path.endswith("mem_scale"):
            np.testing.assert_allclose(g, w, rtol=SCALE_RTOL, atol=0,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=path)


def _assert_tree(got, want):
    for (path, g), (_, w) in zip(ckpt.flatten_with_paths(got),
                                 ckpt.flatten_with_paths(_numpy(want))):
        np.testing.assert_allclose(np.asarray(g), w, atol=TOL, rtol=TOL,
                                   err_msg=path)


# --------------------------------------------------------------------------
# Chunk steps against JAX's make_streaming_train_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype,mode,backend", [
    ("sam", "float32", "sparse", "ref"),
    ("sam", "float32", "sparse", "pallas-interpret"),
    ("sam", "float32", "chunked", "ref"),
    ("sam", "float32", "naive", "ref"),
    ("sam_ann", "float32", "sparse", "ref"),
    ("sam", "int8", "sparse", "ref"),
    ("sam", "bfloat16", "sparse", "ref"),
    ("sdnc", "float32", "sparse", "ref"),
    ("dam", "float32", "naive", "ref")])
def test_chunk_steps_match_jax(kind, dtype, mode, backend):
    jspec, spec = _specs(kind, dtype, mode, backend)
    j_init, j_init_s, j_chunk = jtraining.make_streaming_train_step(jspec, LR)
    _, init_s, chunk_step = training.make_streaming_train_step(
        spec, LR, device="cpu")
    jparams = _numpy(j_init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(7)
    j_opt = jopt.RMSPropState(acc=jax.tree.map(
        lambda p: (0.01 + rng.random(p.shape)).astype(np.float32) * 1e-3,
        jparams))
    jcarry = j_init_s(B)
    params = convert.params_from_jax(jparams, device="cpu")
    opt_state = convert.opt_state_from_jax(_numpy(j_opt), device="cpu")
    carry = _to_port(_numpy(jcarry), init_s(B))
    j_chunk = jax.jit(j_chunk)

    seq = np.random.default_rng(5).integers(0, 2, (B, MAX_LEN, BITS))
    batch = copy_task(B, MAX_LEN - 1, MAX_LEN, BITS, seq=seq, device="cpu")
    xs, ts, ms = (t.transpose(0, 1).contiguous() for t in batch)
    assert xs.shape[0] == 3 * CHUNK
    for c in range(3):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        if c and dtype == "bfloat16":
            params = convert.params_from_jax(_numpy(jparams), device="cpu")
            opt_state = convert.opt_state_from_jax(_numpy(j_opt),
                                                   device="cpu")
            carry = _to_port(_numpy(jcarry), carry)
        jparams, j_opt, jcarry, j_loss, j_err = j_chunk(
            jparams, j_opt, jcarry,
            *(jnp.asarray(t[sl].numpy()) for t in (xs, ts, ms)))
        params, opt_state, carry, loss, err = chunk_step(
            params, opt_state, carry, xs[sl], ts[sl], ms[sl])
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=TOL,
                                   atol=TOL)
        assert err.item() == float(j_err)
        _assert_tree(params, jparams)
        _assert_tree(opt_state.acc, j_opt.acc)
        _assert_carry(carry, jcarry)
        assert all(not t.requires_grad for t in pytree.tree_leaves(carry)
                   if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------------
# The redo
# --------------------------------------------------------------------------

def _cell(kind, dtype, n=N):
    mem = MemoryConfig(ann="lsh" if kind == "sam_ann" else "exact",
                       **_mem_kw(dtype, n))
    ctl = ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                           output_size=BITS)
    if kind == "sdnc":
        return SDNCCell(dnc.DNCConfig(mem, ctl, sparse=True))
    return SAMCell(SAMConfig(mem, ctl))


def _grad_params(cell, seed=0):
    leaves, spec = pytree.tree_flatten(
        cell.init_params(torch.Generator().manual_seed(seed), device="cpu"))
    return pytree.tree_unflatten([p.requires_grad_() for p in leaves], spec)


def _xs(T=9, seed=0):
    return torch.tensor(np.random.default_rng(seed).integers(
        0, 2, (T, B, BITS + 2)), dtype=torch.float32)


def _buffers(cell, state):
    return {p: unroll._get(state, p) for p in cell.dense_buffers}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("mode,chunk", [("sparse", None), ("chunked", 4)])
@pytest.mark.parametrize("kind,dtype", [
    ("sam", "float32"), ("sam", "bfloat16"), ("sam", "int8"),
    ("sam_ann", "float32"), ("sdnc", "float32"), ("sdnc", "bfloat16")])
def test_roll_forward_gives_the_final_state_back(kind, dtype, mode, chunk):
    """Two unrolls in a row from one carry: after each backward every
    dense buffer is rolled back; roll_forward gives the forward's final
    buffers back bit for bit, and the next unroll steps from them."""
    cell = _cell(kind, dtype)
    params = _grad_params(cell)
    state = cell.init_state(B, device="cpu")
    for seed in (0, 1):
        final, ys = unroll.unroll(cell, params, state, _xs(seed=seed),
                                  mode=mode, chunk=chunk)
        want = {p: b.detach().clone()
                for p, b in _buffers(cell, final).items()}
        ys.square().sum().backward()
        assert not torch.equal(_bits(final.memory), _bits(want["memory"]))
        assert unroll.roll_forward(final) is final
        for p, b in _buffers(cell, final).items():
            assert torch.equal(_bits(b), _bits(want[p])), p
        state = pytree.tree_map(
            lambda t: t.detach() if isinstance(t, torch.Tensor) else t, final)
    with torch.no_grad():
        cell.step(params, state, _xs()[0])


def _log_bytes(kind, n, mode, chunk):
    cell = _cell(kind, "float32", n)
    final, ys = unroll.unroll(cell, _grad_params(cell),
                              cell.init_state(B, device="cpu"), _xs(),
                              mode=mode, chunk=chunk)
    ys.sum().backward()
    logs = final.memory.redo_logs
    assert len(logs) == 1 and len(logs[0][1]) == _xs().shape[0]
    return tree_bytes([log for _, log in logs]), cell, final


@pytest.mark.parametrize("kind", ["sam", "sdnc"])
def test_redo_log_is_o_of_t_j_w(kind):
    """The log holds T steps of J rows (and the SDNC's link rows): the same
    bytes at N = 32 and N = 64, and no more than the residuals'."""
    for mode, chunk in (("sparse", None), ("chunked", 4)):
        small, cell, final = _log_bytes(kind, N, mode, chunk)
        large, _, _ = _log_bytes(kind, 2 * N, mode, chunk)
        assert small == large
        assert small <= _xs().shape[0] * cell.step_residual_bytes(final)


def test_roll_forward_after_chained_unrolls():
    """Two unrolls chained over one memory (as the LM's memory groups):
    their backwards run in reverse order and roll the buffers back to the
    first one's start; roll_forward gives the second one's final buffers
    back. Before its backward, roll_forward refuses."""
    cell = _cell("sam", "float32")
    params = _grad_params(cell)
    s0 = cell.init_state(B, device="cpu")
    m0 = s0.memory.clone()
    s1, ys1 = unroll.unroll(cell, params, s0, _xs(seed=1), mode="sparse")
    s2, ys2 = unroll.unroll(cell, params, s1, _xs(seed=2), mode="chunked",
                            chunk=3)
    want = {p: b.detach().clone() for p, b in _buffers(cell, s2).items()}
    with pytest.raises(RuntimeError, match="not run its backward"):
        unroll.roll_forward(s2)
    (ys1.sum() + ys2.square().sum()).backward()
    assert torch.equal(s2.memory, m0)
    with pytest.raises(RuntimeError, match="roll_forward"):
        cell.step(params, s2, _xs()[0])
    unroll.roll_forward(s2)
    for p, b in _buffers(cell, s2).items():
        assert torch.equal(b, want[p]), p
    with torch.no_grad():
        cell.step(params, s2, _xs()[0])


# --------------------------------------------------------------------------
# The loop (tests/test_streaming_ckpt.py on the port)
# --------------------------------------------------------------------------

LOOP_KW = dict(episodes=2, chunk=4, batch=2, level=3, max_level=4, bits=8,
               lr=1e-3, seed=0)
LOOP_MEM = dict(num_slots=16, word_size=8, num_heads=1, k=2)
LOOP_CTL = dict(input_size=10, hidden_size=16, output_size=8)


def _loop_spec(dtype="float32"):
    return training.ModelSpec("sam", MemoryConfig(mem_dtype=dtype, **LOOP_MEM),
                              ControllerConfig(**LOOP_CTL))


def _jax_loop_spec(dtype="float32"):
    return jtraining.ModelSpec(
        "sam", JaxMemoryConfig(mem_dtype=dtype, **LOOP_MEM),
        JaxControllerConfig(**LOOP_CTL))


def _stream(spec, **kw):
    return training.train_task_streaming(spec, "copy", device="cpu",
                                         **{**LOOP_KW, **kw})


def test_loop_state_roundtrips(tmp_path):
    loop = training.init_loop_state(8)._replace(
        episode=torch.tensor(3, dtype=torch.int32),
        cursor=torch.tensor(5, dtype=torch.int32),
        streak=torch.tensor(2, dtype=torch.int32),
        err_sum=torch.tensor(1.5), err_cnt=torch.tensor(4, dtype=torch.int32))
    tree = {"loop": loop, "params": {"w": torch.ones(3)}}
    ckpt.save_checkpoint(str(tmp_path), 11, tree)
    restored, step = ckpt.restore_checkpoint(str(tmp_path), tree)
    assert step == 11
    assert int(restored["loop"].cursor) == 5
    assert int(restored["loop"].level) == 8
    for a, b in zip(pytree.tree_leaves(tree), pytree.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # JAX's loop state has the same fields, paths and dtypes.
    jloop = _numpy(jtraining.init_loop_state(8))
    assert [(p, np.asarray(x).dtype) for p, x in
            ckpt.flatten_with_paths(jloop)] == [
        (p, np.asarray(x).dtype) for p, x in ckpt.flatten_with_paths(
            _numpy_tree(training.init_loop_state(8)))]


def _numpy_tree(tree):
    return pytree.tree_map(lambda t: t.numpy(), tree)


def test_legacy_checkpoint_loads_unchanged(tmp_path):
    """A params/opt-only tree restores into the trainer's template: its
    leaves bit for bit, carry and loop from the template."""
    ckpt.save_checkpoint(str(tmp_path), 2, {"params": {"w": torch.arange(4.)},
                                            "opt": {"ms": torch.ones(4)}})
    template = {"params": {"w": torch.zeros(4)}, "opt": {"ms": torch.zeros(4)},
                "carry": torch.zeros((2, 2)),
                "loop": training.init_loop_state(4)}
    restored, step = ckpt.restore_checkpoint(str(tmp_path), template,
                                             fill_missing=True)
    assert step == 2
    assert torch.equal(restored["params"]["w"], torch.arange(4.))
    assert torch.equal(restored["opt"]["ms"], torch.ones(4))
    assert torch.equal(restored["carry"], torch.zeros((2, 2)))
    assert int(restored["loop"].episode) == 0
    assert int(restored["loop"].level) == 4


def test_fill_missing_rejects_unknown_leaves_and_strict_rejects_structure(
        tmp_path):
    ckpt.save_checkpoint(str(tmp_path / "a"), 1, {
        "params": {"w": torch.ones(2)}, "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="no counterpart"):
        ckpt.restore_checkpoint(str(tmp_path / "a"),
                                {"params": {"w": torch.zeros(2)}},
                                fill_missing=True)
    ckpt.save_checkpoint(str(tmp_path / "b"), 1,
                         {"params": {"w": torch.ones(2)}})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore_checkpoint(str(tmp_path / "b"), {
            "params": {"w": torch.zeros(2)},
            "loop": training.init_loop_state(2)})


@functools.lru_cache(maxsize=None)
def _uninterrupted(dtype="float32"):
    return _stream(_loop_spec(dtype))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mid_episode_resume_matches_uninterrupted(tmp_path, dtype):
    """Killed after 2 chunks (mid-episode 0), resumed and killed after 4
    (mid-episode 1), then resumed to the end: the history goes on at the
    saved cursor, as the uninterrupted run's, and the parameters equal
    that run's bit for bit."""
    p_ref, h_ref = _uninterrupted(dtype)
    run = str(tmp_path / "run")
    for stop in (2, 4):
        _, h1 = _stream(_loop_spec(dtype), ckpt_dir=run, ckpt_every=1,
                        stop_after_chunks=stop)
    assert len(h1) == 2
    p_res, h2 = _stream(_loop_spec(dtype), ckpt_dir=run, ckpt_every=1)
    assert (h2[0]["episode"], h2[0]["chunk"]) == (1, 1)
    assert 4 + len(h2) == len(h_ref)
    assert h_ref[4:] == h2
    for a, b in zip(pytree.tree_leaves(p_ref), pytree.tree_leaves(p_res)):
        assert torch.equal(a, b)


def test_streaming_curriculum_state_restores(tmp_path):
    kw = dict(episodes=3, level=2, max_level=8,
              ckpt_dir=str(tmp_path / "run"), ckpt_every=1)
    cur = Curriculum(start_level=2, threshold=1e9, patience=1)
    _stream(_loop_spec(), curriculum=cur, **kw)
    assert cur.level > 2
    cur2 = Curriculum(start_level=2, threshold=1e9, patience=1)
    _, history = _stream(_loop_spec(), curriculum=cur2, **kw)
    assert history == [] and cur2.level == cur.level


def _saves(monkeypatch, module):
    steps = []
    save = module.save_checkpoint

    def spy(directory, step, tree, mem_layout=None):
        steps.append(step)
        return save(directory, step, tree, mem_layout=mem_layout)

    monkeypatch.setattr(module, "save_checkpoint", spy)
    return steps


def test_history_and_checkpoint_steps_match_jax(tmp_path, monkeypatch):
    """Without a curriculum, the same arguments give JAX's (episode, chunk,
    level) sequence and its checkpoint steps, killed and resumed too."""
    kw = dict(LOOP_KW, chunk=3, max_level=5)
    j_steps, steps = _saves(monkeypatch, jckpt), _saves(monkeypatch, ckpt)
    for stop in (3, None):
        _, jh = jtraining.train_task_streaming(
            _jax_loop_spec(), "copy", ckpt_dir=str(tmp_path / "jax"),
            ckpt_every=2, stop_after_chunks=stop, **kw)
        _, h = training.train_task_streaming(
            _loop_spec(), "copy", ckpt_dir=str(tmp_path / "port"),
            ckpt_every=2, stop_after_chunks=stop, device="cpu", **kw)
        key = [(r["episode"], r["chunk"], r["level"]) for r in h]
        assert key == [(r["episode"], r["chunk"], r["level"]) for r in jh]
    assert steps == j_steps and len(steps) > 4
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "port"))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_streaming_checkpoints_cross_packages(tmp_path, dtype):
    """A JAX streaming checkpoint ({params, opt, carry, loop}) restores into
    the port's template bit for bit, the port's into JAX's; the two
    manifests of the same point are identical."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(LOOP_KW, ckpt_every=1, stop_after_chunks=2)
    jtraining.train_task_streaming(_jax_loop_spec(dtype), "copy",
                                   ckpt_dir=jdir, **kw)
    _stream(_loop_spec(dtype), ckpt_dir=pdir, **{k: v for k, v in kw.items()
                                                 if k not in LOOP_KW})
    manifests = [json.load(open(os.path.join(d, "step_2", "manifest.json")))
                 for d in (jdir, pdir)]
    assert manifests[0] == manifests[1]
    leaves = manifests[0]["leaves"]

    spec = _loop_spec(dtype)
    init_p, init_s, _ = training.make_streaming_train_step(spec,
                                                           device="cpu")
    params = init_p(torch.Generator().manual_seed(9))
    template = {"params": params, "opt": opt.rmsprop_init(params),
                "carry": init_s(2), "loop": training.init_loop_state(1)}
    got, step = ckpt.restore_checkpoint(jdir, template)
    assert step == 2
    for entry, (path, leaf) in zip(leaves, ckpt.flatten_with_paths(got)):
        assert entry["path"] == path
        want = np.load(os.path.join(jdir, "step_2", entry["file"]))
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=path)

    jspec = _jax_loop_spec(dtype)
    j_init, j_init_s, _ = jtraining.make_streaming_train_step(jspec)
    jparams = j_init(jax.random.PRNGKey(9))
    jtemplate = {"params": jparams, "opt": jopt.rmsprop_init(jparams),
                 "carry": j_init_s(2), "loop": jtraining.init_loop_state(1)}
    jgot, jstep = jckpt.restore_checkpoint(pdir, jtemplate)
    assert jstep == 2
    for entry, (path, leaf) in zip(leaves,
                                   ckpt.flatten_with_paths(_numpy(jgot))):
        assert entry["path"] == path
        want = np.load(os.path.join(pdir, "step_2", entry["file"]))
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=path)


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="A11"):
        _stream(_loop_spec(), mesh=object())
