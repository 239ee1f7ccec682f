"""Training of the MLA and MoE families in the port (`models/moe.py`
under autograd with the router's aux loss, `models/attention.py::
mla_forward`'s gradient at DV != D, `launch/steps.py`) against the JAX
package, on the CPU, at the reduced configs of DeepSeek-V2 (MLA, one
leading dense layer, 4 experts of 64, top-2, 2 shared; with the reduced
config's memory group per layer JAX's grouping runs no MoE block (per =
0), so the config trained here has 3 layers and a group every 2, which
runs the dense block and two MoE blocks) and Llama-4 Maverick (4 experts,
top-1, one shared, no dense layer), each + SAM at f32 compute.

Both sides get JAX's weights and one numpy batch. The loss, the aux
loss, every gradient leaf (the port's blocks plain and under
`torch.utils.checkpoint`) and two `make_train_step` steps are held to
JAX's within the bars of `tests/torch_train_parity.py`. The batch seeds
are the first whose reads hold no near-tie at K and whose routers none
at k, through both steps (asserted). The port sends a dropped (token,
expert) pair to a slot past the buffer where JAX adds its zero row onto
(expert 0, slot 0) (ROADMAP §C): `moe_apply`'s gradients agree with and
without drops, kept slots included."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as P
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.launch import steps
from repro_torch.models import moe

# (arch, extra config fields, batch seed): the first seed of 0-39 whose
# reads hold no near-tie at K and whose routers none at k, in the loss and
# through both train steps.
FAMILIES = (("deepseek_v2_236b_sam", dict(num_layers=3, every=2), 0),
            ("llama4_maverick_400b_a17b_sam", {}, 14))
IDS = ["deepseek", "llama4"]


def _run(case, monkeypatch, check, **kw):
    arch, extra, seed = case
    reads = P.record_reads(monkeypatch)
    routes = P.record_routes(monkeypatch)
    jcfg, cfg = P.configs(arch, **extra)
    check(jcfg, cfg, P.batch(jcfg, seed), **kw)
    P.assert_read_margins(reads)
    P.assert_router_margins(routes)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("case", FAMILIES, ids=IDS)
def test_loss_and_every_gradient_match_jax(case, remat, monkeypatch):
    """`loss_fn` at f32 compute (its aux term the routers' summed) and
    every gradient leaf against `jax.value_and_grad(lm.loss_fn)`."""
    _run(case, monkeypatch, P.check_loss_and_grads, remat=remat)


@pytest.mark.parametrize("case", FAMILIES, ids=IDS)
def test_train_step_matches_jax(case, monkeypatch):
    """Two `make_train_step` steps against JAX's jitted `train_step`."""
    _run(case, monkeypatch, P.check_train_step)


def test_accumulated_step_reports_a_zero_aux_as_jax(monkeypatch):
    """With ``accum`` = 2 the step's loss is the mean of the microbatches'
    (aux terms included) and its ``aux`` metric is 0, as JAX's
    (`src/repro/launch/steps.py:50`); the parameters and moments against
    JAX's accumulated step from the same state."""
    arch, extra, seed = FAMILIES[1]
    routes = P.record_routes(monkeypatch)
    jcfg, cfg = P.configs(arch, **extra)
    b = P.batch(jcfg, seed, n=4)
    jp = P.jax_weights(jcfg)
    js = jopt.adamw_init(jp)
    jp1, js1, jm = jax.jit(jsteps.make_train_step(jcfg, accum=2))(jp, js, b)
    tp = P.port_weights(jp)
    ts = convert.adamw_state_from_jax(jax.tree.map(np.asarray, js),
                                      device="cpu")
    halves = [steps.value_and_grad(P.port_weights(jp), cfg,
                                   P.tb({k: v[i * 2:(i + 1) * 2]
                                         for k, v in b.items()}))[0]
              for i in range(2)]
    tp, ts, tm = steps.make_train_step(cfg, accum=2)(tp, ts, P.tb(b))
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    P.close(tm["loss"], (halves[0] + halves[1]) / 2)
    for k in ("loss", "ce", "lr"):
        P.close(tm[k], jm[k])
    P.tree_close(tp, jp1)
    P.tree_close({"mu": ts.mu, "nu": ts.nu},
                 {"mu": dict(js1.mu), "nu": dict(js1.nu)}, P.GRAD_TOL)
    P.assert_router_margins(routes)


@pytest.mark.parametrize("capacity_factor,drops", [(2.0, False),
                                                   (0.25, True)])
def test_moe_apply_gradients_match_jax(capacity_factor, drops, monkeypatch):
    """`moe_apply`'s output, aux loss and the gradients of Σ out·g + aux
    in x and every expert, router and shared leaf against `jax.grad` of
    JAX's, with ample capacity and with a quarter of it: the dropped pairs
    (among them pairs whose expert's slot 0 holds a kept pair) get no
    gradient on either side, the kept slots the same."""
    routes = P.record_routes(monkeypatch)
    arch, extra, _ = FAMILIES[0]
    jcfg, cfg = P.configs(arch, **extra)
    jp = jax.tree.map(lambda t: t[0], P.jax_weights(jcfg)["blocks"]["moe"])
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, 128)).astype(np.float32)
    g = rng.standard_normal((2, 32, 128)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, jcfg, x, "silu")
        return jnp.sum(out * g) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, x)
    tp = jax.tree.map(lambda t: torch.tensor(np.asarray(t)), jp)
    leaves, spec = torch.utils._pytree.tree_flatten(tp)
    diff = [t.requires_grad_() for t in leaves]
    tx = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_apply(torch.utils._pytree.tree_unflatten(diff, spec),
                             cfg, tx, "silu")
    grads = torch.autograd.grad((out * torch.tensor(g)).sum() + aux,
                                diff + [tx])
    P.close(out, jout)
    P.close(aux, jaux)
    got = torch.utils._pytree.tree_unflatten(list(grads[:-1]), spec)
    P.tree_close({"p": got, "x": grads[-1]}, {"p": jgp, "x": jgx},
                 P.GRAD_TOL)
    P.assert_router_margins(routes)
    C = moe.capacity(cfg, 64)
    _, top_e = moe.top_k(routes[0][0], routes[0][1])
    per_expert = np.bincount(top_e.numpy().reshape(-1), minlength=4)
    assert (per_expert.max() > C) == drops, (per_expert, C)
