"""Training of the recurrent families in the port (`models/rwkv.py`'s
WKV loop and `models/ssm.py`'s associative scan under autograd, the RWKV
and hybrid blocks under `torch.utils.checkpoint`, `launch/train.py`)
against the JAX package, on the CPU, at the reduced configs of RWKV-6 7B
(head size 32; JAX's zero-initialised leaves drawn from numpy) and
Hymba-1.5B (a window of 32, SSM state 8; every SSM leaf drawn from
numpy), each + SAM at f32 compute.

Both sides get the same weights and one numpy batch. The loss, every
gradient leaf (the port's blocks plain and under checkpoint, which
recomputes an RWKV block's zero states and a hybrid block's averaged
attention and SSM in the backward) and two `make_train_step` steps are
held to JAX's within the bars of `tests/torch_train_parity.py`; the batch
seeds are the first whose reads hold no near-tie at K through both
steps (asserted). `train("hymba_1_5b")` checkpoints and resumes, as
`tests/test_system.py::test_lm_train_driver_with_checkpoint` drives
JAX's."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import torch_train_parity as P
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm

# (arch, batch seed): the first seed of 0-39 whose reads hold no near-tie
# at K in the loss and through both train steps.
FAMILIES = (("rwkv6_7b_sam", 1), ("hymba_1_5b_sam", 0))
IDS = ["rwkv6", "hymba"]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch,seed", FAMILIES, ids=IDS)
def test_loss_and_every_gradient_match_jax(arch, seed, remat, monkeypatch):
    """`loss_fn` at f32 compute and every gradient leaf against
    `jax.value_and_grad(lm.loss_fn)`, which differentiates JAX's
    `lax.scan` over the WKV recurrence and its `associative_scan`."""
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


@pytest.mark.parametrize("arch", ["rwkv6_7b_sam", "hymba_1_5b_sam"])
def test_remat_recomputes_the_same_gradients(arch):
    """The bf16 default (remat off in the reduced config) with the blocks
    under checkpoint gives the plain run's loss and gradients bit for
    bit: the recompute redraws nothing (an RWKV block's zero states and a
    hybrid block's SSM start from zeros made inside it)."""
    cfg = reduced(get_config(arch))
    params = lm.init_params(cfg, seed=3, device="cpu")
    b = P.tb(P.batch(P.configs(arch)[0], 2))
    runs = [steps.value_and_grad(params, dataclasses.replace(
        cfg, remat=remat), b) for remat in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for (_, g0), (_, g1) in zip(P.leaves(runs[0][2]), P.leaves(runs[1][2]),
                                strict=True):
        assert torch.equal(g0, g1)


def test_train_hymba_checkpoints_and_resumes(tmp_path):
    """`train("hymba_1_5b", ckpt_dir=...)` for 6 steps, a checkpoint every
    2, then a resume to 8 (JAX's system test): the resumed run starts at
    step 6 from the saved state and ends at 8."""
    kw = dict(batch=2, seq=64, device="cpu")
    (params, opt_state), log = ttrain.train(
        "hymba_1_5b", steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
        log_every=2, **kw)
    assert latest_step(str(tmp_path)) == 5 and int(opt_state.count) == 6
    assert all(np.isfinite(m["loss"]) for _, m in log)
    (params2, opt_state2), log2 = ttrain.train(
        "hymba_1_5b", steps=8, ckpt_dir=str(tmp_path), ckpt_every=4,
        log_every=1, **kw)
    assert [i for i, _ in log2] == [6, 7]
    assert latest_step(str(tmp_path)) == 7 and int(opt_state2.count) == 8
    assert all(np.isfinite(m["loss"]) for _, m in log2)
