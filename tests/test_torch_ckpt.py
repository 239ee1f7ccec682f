"""The port's checkpoints (`repro_torch.checkpoint.ckpt`) and session store
(`launch/engine/sessions.py`) against the JAX package's, on the CPU.

A checkpoint written by either package restores in the other bit for
bit: SAM states stepped by JAX on f32, bf16 and int8 rows (f32, int32,
bf16, int8 and `mem_scale` leaves; an LSH index) and a bf16 LM serving
session. The port writes the same files as JAX, byte for byte, manifest
included. JAX's own `restore_checkpoint` cannot load a bf16 leaf (numpy
reads its '<V2' file as raw bytes, which `jnp.asarray` refuses): that
holds for JAX's files and the port's alike (ROADMAP §C), so the bf16
cases are held by the byte equality and by the port's restore.

The shims against JAX's: the format-1 pad of memory and usage, the
float↔int8 migration (the port scales by fl(1/127), as `core/quant.py`
and the compiled JAX quantizer do, where JAX's numpy twin divides: scales
within one ulp, codes equal wherever the scales are), the f32↔bf16 change
of a memory leaf, a manifest of 2 shards restored into the canonical
layout, and the refusals: a re-partitioned LSH index (P > 1) names ROADMAP
A11.
"""
from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import sam as jsam
from repro.core.types import ControllerConfig, MemoryConfig
from repro.distributed import elastic
from repro.launch import engine as jengine
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core.quant import quantize_rows
from repro_torch.core.types import LA_SCRATCH
from repro_torch.launch.engine import SessionStore

B, N, W, H, K = 2, 32, 8, 2, 2
LSH = dict(ann="lsh", lsh_tables=2, lsh_bits=3, lsh_bucket_size=8)


def _jax_state(mem_dtype="float32", ann=None, steps=3, seed=0):
    mem = MemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K,
                       mem_dtype=mem_dtype, **(LSH if ann else {}))
    cfg = jsam.SAMConfig(mem, ControllerConfig(6, 16, 6))
    params = jsam.init_params(jax.random.PRNGKey(seed), cfg)
    state = jsam.init_state(B, cfg, params=params)
    xs = jax.random.normal(jax.random.PRNGKey(seed + 1), (steps, B, 6))
    state, _ = jsam.sam_unroll(params, cfg, state, xs)
    return jax.tree.map(np.asarray, state)


def _jax_session():
    """A bf16 LM serving session of JAX's engine (reduced StarCoder2)."""
    cfg = jax_reduced(jax_get_config("starcoder2_7b_sam"))
    eng = jengine.ServeEngine(cfg, lanes=2, max_len=16)
    eng.run([jengine.Request(user="u", prompt=[3, 7], max_new_tokens=3)])
    return eng.sessions.take("u")


def _port_tree(case, jtree):
    if case == "lm_session_bf16":
        return convert.session_from_jax(jtree, device="cpu")
    return convert.state_from_jax(jtree, device="cpu")


def _bits(x):
    """A leaf's bytes and dtype name (bf16 as its 16-bit patterns)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16"
        return x.numpy().tobytes(), str(x.dtype)[6:]
    x = np.asarray(x)
    return x.tobytes(), str(x.dtype)


def _assert_bits(got_tree, want_tree):
    got = ckpt.flatten_with_paths(got_tree)
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        gb, gd = _bits(g)
        wb, wd = _bits(w)
        # A Python int comes back as a 0-d int64 tensor; JAX keeps int32.
        if np.ndim(w) == 0 and gd != wd:
            assert int(g) == int(w), path
            continue
        assert (gd, gb) == (wd, wb), path


CASES = ["float32", "bfloat16", "int8", "lm_session_bf16"]


@pytest.fixture(scope="module")
def trees():
    out = {}
    for case in CASES:
        jtree = _jax_session() if case == "lm_session_bf16" else \
            _jax_state(case, ann="lsh" if case == "float32" else None)
        out[case] = (jtree, _port_tree(case, jtree))
    return out


@pytest.mark.parametrize("case", CASES)
def test_jax_saves_port_restores(trees, tmp_path, case):
    jtree, ttree = trees[case]
    jckpt.save_checkpoint(str(tmp_path), 5, jtree)
    got, step = ckpt.restore_checkpoint(str(tmp_path), ttree)
    assert step == 5
    _assert_bits(got, jtree)


@pytest.mark.parametrize("case", CASES)
def test_port_writes_jax_files_and_jax_restores(trees, tmp_path, case):
    jtree, ttree = trees[case]
    jdir = jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jtree,
                                 mem_layout=(N, 1))
    tdir = ckpt.save_checkpoint(str(tmp_path / "port"), 2, ttree,
                                mem_layout=(N, 1))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    if case in ("bfloat16", "lm_session_bf16"):
        for d in (tmp_path / "jax", tmp_path / "port"):
            with pytest.raises(TypeError, match="V2"):
                jckpt.restore_checkpoint(str(d), jtree)
        return
    back, _ = jckpt.restore_checkpoint(str(tmp_path / "port"), jtree)
    _assert_bits(jax.tree.map(np.asarray, back), jtree)


def _strip_format(directory, step):
    path = os.path.join(directory, f"step_{step}", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    del manifest["format"]
    with open(path, "w") as f:
        json.dump(manifest, f)


def test_format1_checkpoint_is_padded(tmp_path):
    """A pre-scratch-row checkpoint ((B, N, W) memory, (B, N) usage, no
    format marker): the port pads the scratch row as JAX does."""
    jstate = _jax_state()
    legacy = jstate._replace(memory=jstate.memory[:, :-1],
                             last_access=jstate.last_access[:, :-1])
    jckpt.save_checkpoint(str(tmp_path), 3, legacy)
    _strip_format(str(tmp_path), 3)
    want, _ = jckpt.restore_checkpoint(str(tmp_path), jstate)
    got, _ = ckpt.restore_checkpoint(
        str(tmp_path), convert.state_from_jax(jstate, device="cpu"))
    _assert_bits(got, jax.tree.map(np.asarray, want))
    assert got.memory[:, N].eq(0).all()
    assert got.last_access[:, N].eq(LA_SCRATCH).all()
    # Format 2 and later never pad: the same shapes raise.
    jckpt.save_checkpoint(str(tmp_path / "f4"), 3, legacy)
    with pytest.raises(ValueError, match="migration"):
        ckpt.restore_checkpoint(str(tmp_path / "f4"), got)


def test_float_to_int8_migration(tmp_path):
    """An f32 checkpoint into an int8 template: the port's codes and
    scales equal `core.quant.quantize_rows` bit for bit; against JAX's
    migration (a true division by 127) the scales lie within one ulp and
    the codes are equal wherever the scales are."""
    jf32, ji8 = _jax_state(), _jax_state("int8")
    jckpt.save_checkpoint(str(tmp_path), 1, jf32)
    template = convert.state_from_jax(ji8, device="cpu")
    got, _ = ckpt.restore_checkpoint(str(tmp_path), template)
    q, scale = quantize_rows(torch.from_numpy(jf32.memory.copy()))
    assert torch.equal(got.memory, q) and torch.equal(got.mem_scale, scale)
    want, _ = jckpt.restore_checkpoint(str(tmp_path), ji8)
    w_scale = np.asarray(want.mem_scale)
    np.testing.assert_allclose(got.mem_scale.numpy(), w_scale, rtol=1.2e-7,
                               atol=0)
    same = got.mem_scale.numpy() == w_scale
    np.testing.assert_array_equal(got.memory.numpy()[same],
                                  np.asarray(want.memory)[same])
    assert same.mean() > 0.5


def test_int8_to_float_and_bf16_migrations(tmp_path):
    """An int8 checkpoint into an f32 template dequantizes as JAX does, bit
    for bit; f32 into a bf16 memory rounds to nearest even, and bf16 into
    f32 is exact (the port's restore; JAX cannot load bf16)."""
    ji8, jf32 = _jax_state("int8"), _jax_state()
    jckpt.save_checkpoint(str(tmp_path / "i8"), 1, ji8)
    tf32 = convert.state_from_jax(jf32, device="cpu")
    got, _ = ckpt.restore_checkpoint(str(tmp_path / "i8"), tf32)
    want, _ = jckpt.restore_checkpoint(str(tmp_path / "i8"), jf32)
    _assert_bits(got, jax.tree.map(np.asarray, want))

    jckpt.save_checkpoint(str(tmp_path / "f32"), 1, jf32)
    tbf16 = convert.state_from_jax(_jax_state("bfloat16"), device="cpu")
    got, _ = ckpt.restore_checkpoint(str(tmp_path / "f32"), tbf16)
    assert torch.equal(got.memory,
                       torch.from_numpy(jf32.memory).to(torch.bfloat16))
    ckpt.save_checkpoint(str(tmp_path / "bf16"), 1, got)
    back, _ = ckpt.restore_checkpoint(str(tmp_path / "bf16"), tf32)
    assert torch.equal(back.memory, got.memory.float())


@pytest.mark.parametrize("mem_dtype", ["float32", "int8"])
def test_sharded_manifest_restores_canonical(tmp_path, mem_dtype):
    """A state saved in the 2-shard layout (N + 2 rows, mem_layout
    recorded) restores into the canonical template, bit for bit as JAX
    restores it: the logical rows as they were, fresh scratch rows."""
    jstate = _jax_state(mem_dtype)
    sharded = jax.tree.map(np.asarray,
                           elastic.relayout_memory_state(jstate, N, 2))
    assert sharded.memory.shape[1] == N + 2
    jckpt.save_checkpoint(str(tmp_path), 4, sharded, mem_layout=(N, 2))
    want, _ = jckpt.restore_checkpoint(str(tmp_path), jstate)
    got, _ = ckpt.restore_checkpoint(
        str(tmp_path), convert.state_from_jax(jstate, device="cpu"))
    _assert_bits(got, jax.tree.map(np.asarray, want))
    _assert_bits(got, jstate)
    with pytest.raises(ValueError, match="num_slots=32, caller expects 64"):
        ckpt.restore_checkpoint(str(tmp_path), got, expect_num_slots=64)


def test_partitioned_lsh_index_is_refused(tmp_path):
    jstate = _jax_state(ann="lsh")
    sharded = jax.tree.map(np.asarray,
                           elastic.relayout_memory_state(jstate, N, 2))
    assert sharded.ann.buckets.shape[3] == 2            # P = 2
    jckpt.save_checkpoint(str(tmp_path), 0, sharded, mem_layout=(N, 2))
    with pytest.raises(ValueError, match="ROADMAP A11"):
        ckpt.restore_checkpoint(str(tmp_path),
                                convert.state_from_jax(jstate, device="cpu"))


def test_commit_latest_step_and_structure_checks(tmp_path):
    tree = {"a": torch.arange(3, dtype=torch.int32), "b": torch.ones(2),
            "n": (torch.zeros(1), None)}
    assert ckpt.restore_checkpoint(str(tmp_path), tree) == (None, None)
    for step in (3, 7):
        ckpt.save_checkpoint(str(tmp_path), step, tree)
    os.makedirs(tmp_path / "tmp_9")              # a save cut mid-write
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_7", "tmp_9"]
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(
        str(tmp_path)) == 7
    got, step = ckpt.restore_checkpoint(str(tmp_path), tree)
    assert step == 7 and torch.equal(got["a"], tree["a"])
    assert got["n"][1] is None
    bigger = {**tree, "c": torch.full((2,), 5.0)}
    filled, _ = ckpt.restore_checkpoint(str(tmp_path), bigger,
                                        fill_missing=True)
    assert torch.equal(filled["c"], bigger["c"])
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), bigger)
    with pytest.raises(ValueError, match="no counterpart"):
        ckpt.restore_checkpoint(str(tmp_path), {"a": tree["a"]},
                                fill_missing=True)


def test_session_store_spills_and_restores_bit_for_bit(tmp_path):
    """LRU order with one hot session: a put spills the oldest, peek brings
    a spilled session back (spilling the other), take restores; every
    tree comes back bit for bit, a slot-sharded one in the canonical
    layout."""
    states = {u: _jax_state(seed=s) for s, u in enumerate("abc")}
    port = {u: convert.state_from_jax(s, device="cpu")
            for u, s in states.items()}
    store = SessionStore(num_slots=N, capacity=1,
                         spill_dir=str(tmp_path / "spill"))
    store.put("a", port["a"])
    store.put("b", port["b"])
    assert (store.spills, store.restores, store.users) == (1, 0, ["b", "a"])
    _assert_bits(store.peek("a"), states["a"])
    assert (store.spills, store.restores) == (2, 1)
    _assert_bits(store.take("b"), states["b"])
    assert store.restores == 2 and store.users == ["a"]
    sharded = elastic.relayout_memory_state(states["c"], N, 4)
    store.put("c", convert.state_from_jax(jax.tree.map(np.asarray, sharded),
                                         device="cpu"))
    _assert_bits(store.take("c"), states["c"])
    assert store.take("zzz") is None and store.users == ["a"]
    assert store.spills == 3 and os.listdir(tmp_path / "spill") == [
        "session_a"]
    assert os.listdir(tmp_path / "spill" / "session_a") == ["step_0"]
