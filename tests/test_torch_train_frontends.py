"""Training of the dense GQA families with a frontend or a window in the
port (`launch/train.py`, `launch/specs.py`, `launch/steps.py`,
`models/lm.py::loss_fn`) against the JAX package, on the CPU, at the
reduced configs of PaliGemma-3B (a vision prefix of 16 patch embeddings,
prefix-LM attention), MusicGen-medium (audio frames in place of tokens)
and H2O-Danube3-4B (a window of 32), each + SAM (2 layers, d 128, a
memory of 64 slots of 16 with K = 4 and a group per layer) at f32
compute.

Both sides get JAX's weights (`convert.lm_params_from_jax`) and one numpy
batch: JAX's `concrete_batch` made numpy for a frontend config. The
loss, every gradient leaf (the port's blocks plain and under
`torch.utils.checkpoint`) and two `make_train_step` steps are held to
JAX's within the bars of `tests/torch_train_parity.py`; the batch seeds
are the first whose reads hold no near-tie at K, through both steps
(asserted). `train()` draws a frontend config's batches from
`launch.specs.concrete_batch`, whose keys, shapes and dtypes are JAX's."""
from __future__ import annotations

import inspect

import jax
import numpy as np
import pytest
import torch

import torch_train_parity as P
from repro.launch import specs as jspecs
from repro_torch.configs import get_config, reduced
from repro_torch.launch import specs
from repro_torch.launch import train as ttrain

# (arch, batch seed): the first seed of 0-39 whose reads hold no near-tie
# at K in the loss and through both train steps.
FAMILIES = (("paligemma_3b_sam", 1), ("musicgen_medium_sam", 2),
            ("h2o_danube_3_4b_sam", 1))
IDS = [a.split("_")[0] for a, _ in FAMILIES]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch,seed", FAMILIES, ids=IDS)
def test_loss_and_every_gradient_match_jax(arch, seed, remat, monkeypatch):
    """`loss_fn` at f32 compute and every gradient leaf against
    `jax.value_and_grad(lm.loss_fn)` (the vision prefix predicts nothing;
    an audio batch feeds frames alone)."""
    reads = P.record_reads(monkeypatch)
    jcfg, cfg = P.configs(arch)
    P.check_loss_and_grads(jcfg, cfg, P.batch(jcfg, seed), remat=remat)
    P.assert_read_margins(reads)


@pytest.mark.parametrize("arch,seed", FAMILIES, ids=IDS)
def test_train_step_matches_jax(arch, seed, monkeypatch):
    """Two `make_train_step` steps against JAX's jitted `train_step`."""
    reads = P.record_reads(monkeypatch)
    jcfg, cfg = P.configs(arch)
    P.check_train_step(jcfg, cfg, P.batch(jcfg, seed))
    P.assert_read_margins(reads)


@pytest.mark.parametrize("arch", ["paligemma_3b_sam", "musicgen_medium_sam",
                                  "starcoder2_7b_sam"])
def test_concrete_batch_has_jax_keys_shapes_and_dtypes(arch):
    """`specs.concrete_batch` against JAX's `concrete_batch`: the same
    keys, shapes and dtypes; N(0, 1) embeddings and tokens in [0, vocab);
    one generator seed gives one batch; a vision config raises when the
    sequence leaves no text."""
    jcfg = P.configs(arch)[0]
    cfg = reduced(get_config(arch))
    want = jspecs.concrete_batch(jax.random.PRNGKey(0), jcfg, 3, 40)
    got = specs.concrete_batch(cfg, 3, 40,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    for k, v in got.items():
        if v.is_floating_point():
            assert abs(float(v.mean())) < 0.1 and abs(float(v.std()) - 1) < 0.1
        else:
            assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab_size
    again = specs.concrete_batch(cfg, 3, 40,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    if cfg.frontend == "vision":
        with pytest.raises(ValueError, match="no text"):
            specs.concrete_batch(cfg, 1, cfg.frontend_len,
                                 generator=torch.Generator(), device="cpu")


@pytest.mark.parametrize("arch", ["paligemma_3b_sam", "musicgen_medium_sam"])
def test_train_draws_frontend_batches(arch, monkeypatch):
    """`train()` on a frontend config: its batches are `concrete_batch`'s
    from a generator seeded by ``seed``, one a step, and the losses are
    finite."""
    seen = []

    def spy(*a, **kw):
        seen.append(specs.concrete_batch(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(ttrain, "concrete_batch", spy)
    (_, opt_state), log = ttrain.train(arch, steps=3, batch=2, seq=64,
                                      log_every=1, seed=4, device="cpu")
    assert len(seen) == 3 and int(opt_state.count) == 3
    assert all(np.isfinite(m["loss"]) for _, m in log)
    cfg = reduced(get_config(arch))
    gen = torch.Generator().manual_seed(4)
    for got in seen:
        want = specs.concrete_batch(cfg, 2, 64, generator=gen, device="cpu")
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_entry_points_default_to_the_card():
    """`train` and `concrete_batch` run on the card unless the caller asks
    for the CPU, as every entry point of the port."""
    for fn in (ttrain.train, specs.concrete_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
