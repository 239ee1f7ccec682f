"""The port's SAM cell (`repro_torch.core.sam`) against the JAX cell, step
for step, on the CPU.

B = 2, N = 128, W = 8, H = 2, K = 4, hidden 16, the copy task with
max_len 2 (T = 6). The JAX side runs under the ``ref`` and the
``pallas-interpret`` backends; the port gets its weights and state from
`repro_torch.convert`, and both get the same copy-task inputs. Floats
within 1e-5 at f32; indices and usage tables exact."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sam as jsam
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.data.tasks import copy_task as jax_copy_task
from repro_torch import convert
from repro_torch.core import sam
from repro_torch.core.types import ControllerConfig, MemoryConfig
from repro_torch.data.tasks import copy_task

TOL = 1e-5
B, N, W, H, K, HIDDEN, BITS, MAX_LEN = 2, 128, 8, 2, 4, 16, 4, 2


def _configs(backend):
    jcfg = jsam.SAMConfig(
        JaxMemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K,
                        backend=backend),
        JaxControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                            output_size=BITS))
    cfg = sam.SAMConfig(
        MemoryConfig(num_slots=N, word_size=W, num_heads=H, k=K),
        ControllerConfig(input_size=BITS + 2, hidden_size=HIDDEN,
                         output_size=BITS))
    return jcfg, cfg


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
def test_sam_unroll_matches_jax_every_step(backend):
    jcfg, cfg = _configs(backend)
    jparams = jsam.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jsam.init_state(B, jcfg)
    params = convert.params_from_jax(_numpy(jparams), device="cpu")
    state0 = convert.state_from_jax(_numpy(jstate), device="cpu")
    seq = np.random.default_rng(0).integers(0, 2, (B, MAX_LEN, BITS))
    inputs, _, _ = copy_task(B, MAX_LEN, MAX_LEN, BITS, seq=seq, device="cpu")
    xs = inputs.transpose(0, 1).contiguous()                   # (T, B, D)

    # The whole unroll.
    j_final, j_ys = jax.jit(lambda p, s, x: jsam.sam_unroll(p, jcfg, s, x))(
        jparams, jstate, jnp.asarray(xs.numpy()))
    model = sam.SAM(cfg, params, device="cpu")
    final, ys = model(convert.state_from_jax(_numpy(jstate), device="cpu"),
                      xs)
    _close(ys, j_ys)
    _close(final.memory, j_final.memory)
    np.testing.assert_array_equal(final.last_access.numpy(),
                                  np.asarray(j_final.last_access))

    # Step by step: memory, usage, read indices and y at every step.
    step = jax.jit(lambda p, s, x: jsam.sam_step(p, jcfg, s, x))
    state = state0
    for t, x in enumerate(xs):
        jstate, jy = step(jparams, jstate, jnp.asarray(x.numpy()))
        state, y = sam.sam_step(params, cfg, state, x)
        _close(y, jy)
        _close(state.memory, jstate.memory)
        _close(state.read.words, jstate.read.words)
        _close(state.read.weights, jstate.read.weights)
        np.testing.assert_array_equal(state.read.indices.numpy(),
                                      np.asarray(jstate.read.indices))
        np.testing.assert_array_equal(state.last_access.numpy(),
                                      np.asarray(jstate.last_access))
        assert int(state.step) == int(jstate.step) == t + 1


@pytest.mark.parametrize("length", [1, 3, 5])
def test_copy_task_layout_matches_jax(length):
    max_len, bits = 5, 8
    j_in, j_tgt, j_mask = jax_copy_task(jax.random.PRNGKey(length), 3, length,
                                        max_len, bits)
    # The JAX bits sit in the inputs; hand the same bits to the port.
    seq = np.asarray(j_in)[:, 1:1 + max_len, :bits]
    inputs, targets, mask = copy_task(3, length, max_len, bits, seq=seq,
                                      device="cpu")
    np.testing.assert_array_equal(inputs.numpy(), np.asarray(j_in))
    np.testing.assert_array_equal(targets.numpy(), np.asarray(j_tgt))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))


def test_copy_task_bits_from_a_generator_are_seeded():
    a = copy_task(2, 4, 6, generator=torch.Generator().manual_seed(5),
                  device="cpu")
    b = copy_task(2, 4, 6, generator=torch.Generator().manual_seed(5),
                  device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert set(a[0][:, 1:5, :8].unique().tolist()) == {0.0, 1.0}


def test_init_matches_jax_shapes_and_scale():
    jcfg, cfg = _configs("ref")
    jparams = _numpy(jsam.init_params(jax.random.PRNGKey(0), jcfg))
    params = sam.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    for group in jparams:
        for name, leaf in jparams[group].items():
            assert tuple(params[group][name].shape) == leaf.shape
    wx = params["lstm"]["wx"]
    fan = wx.shape[0] + wx.shape[1]
    assert abs(wx.std().item() - (2.0 / fan) ** 0.5) < 0.1 * (2.0 / fan) ** 0.5
    jstate = _numpy(jsam.init_state(B, jcfg))
    state = sam.init_state(B, cfg, device="cpu")
    np.testing.assert_array_equal(state.last_access.numpy(),
                                  jstate.last_access)
    np.testing.assert_array_equal(state.memory.numpy(), jstate.memory)
    assert state.step.dtype == torch.int32 and state.step.dim() == 0


def test_convert_keeps_orientation_and_rejects_other_models():
    jcfg, _ = _configs("ref")
    jparams = _numpy(jsam.init_params(jax.random.PRNGKey(1), jcfg))
    params = convert.params_from_jax(jparams, device="cpu")
    np.testing.assert_array_equal(params["iface"]["w"].numpy(),
                                  jparams["iface"]["w"])      # (in, out)
    with pytest.raises(ValueError, match="expected groups"):
        convert.params_from_jax({**jparams, "dnc": {"w": np.zeros(3)}},
                                device="cpu")
    with pytest.raises(ValueError, match="lsh_planes must be"):
        convert.params_from_jax({**jparams, "lsh_planes": np.zeros(3)},
                                device="cpu")
    jstate = _numpy(jsam.init_state(B, jcfg))
    with pytest.raises(ValueError, match="only they, carry scales"):
        convert.state_from_jax(jstate._replace(mem_scale=np.zeros(3)),
                               device="cpu")


def test_module_forward_is_the_functional_unroll():
    _, cfg = _configs("ref")
    model = sam.SAM(cfg, seed=4, device="cpu")
    xs = torch.tensor(np.random.default_rng(4).integers(0, 2, (5, B, BITS + 2)),
                      dtype=torch.float32)
    s1, ys1 = model(model.init_state(B), xs)
    params = sam.init_params(torch.Generator().manual_seed(4), cfg,
                             device="cpu")
    s2, ys2 = sam.sam_unroll(params, cfg, sam.init_state(B, cfg, device="cpu"),
                             xs)
    assert torch.equal(ys1, ys2)
    assert torch.equal(s1.memory, s2.memory)
    assert torch.equal(s1.last_access, s2.last_access)
