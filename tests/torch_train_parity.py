"""Shared helpers of the LM families' training parity tests
(`tests/test_torch_train_frontends.py`, `test_torch_train_moe.py`,
`test_torch_train_recurrent.py`): each family's reduced config at f32
compute on both sides, JAX's weights carried across by
`convert.lm_params_from_jax` (with the leaves JAX initialises to
constants drawn from numpy where the family has them), one numpy batch,
and the comparisons of the loss, every gradient leaf and one
`make_train_step` step against JAX.

Bars (ROADMAP's north star, against max(1, |x|)). The loss, the metrics
and the stepped parameters within `TOL` = 1e-5 of max(1, |JAX value|); a
gradient leaf and the moments within `GRAD_TOL` = 1e-5 of max(1, max |g|)
over the leaf. Where a leaf is beyond it, the two f32 orders differ by
more than the bar can hold: the LM's stacked init (fan-in the layer
count) makes hidden states of hundreds, whose one-ulp differences the
memory reads' softmax and the attention carry into the gradients. There
JAX's own move under one-ulp perturbations of its weights arbitrates
(`arbitrated_close`: the leaf's largest miss within `SPREAD_FACTOR` = 3
times JAX's largest move over `SPREAD_DRAWS` = 3 draws; the worst, the
3-layer DeepSeek-V2's memory gates, sits at 2.15 times). An f64 run
cannot arbitrate: the memory layer's rows, reads and writes are f32 on
both sides whatever the compute dtype. Every test that runs a memory
asserts that no read has a near-tie at K (`assert_read_margins`) and
every test that routes that no router probability has one at k
(`assert_router_margins`), so both sides read and route the same rows
and experts."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import moe

TOL = 1e-5
GRAD_TOL = 1e-5
SPREAD_FACTOR = 3
SPREAD_DRAWS = 3
READ_MARGIN = 1e-6
ROUTER_MARGIN = 1e-6
B, S = 2, 64

# JAX's constant-initialised RWKV leaves (`tests/test_torch_rwkv.py`).
RWKV_ZERO_LEAVES = {"tm": ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_x",
                           "mix_b", "decay_base", "decay_b", "bonus",
                           "ln_x"),
                    "cm": ("mu_k2", "mu_r2")}
# The SSM's projections, drawn N(0, 1/fan_in) of their own input width
# (`tests/test_torch_hymba.py`: JAX's stacked fan-in makes the SSM's
# output ~1e9 and ties every read).
SSM_PROJECTIONS = ("in_proj", "x_proj", "dt_proj", "out_proj")


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)).astype(np.float64)


def close(a, b, tol=TOL):
    """|a - b| <= tol · max(1, max |b|), elementwise."""
    a, b = np_(a), np_(b)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)


def configs(arch, **extra):
    """(JAX config, port config): ``arch`` reduced at f32 compute, with
    ``extra`` fields replaced (``every`` sets the memory's group
    spacing)."""
    every = extra.pop("every", None)
    kw = dict(compute_dtype="float32", **extra)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), **kw)
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    if every is not None:
        jcfg = dataclasses.replace(jcfg, memory=dataclasses.replace(
            jcfg.memory, every_n_layers=every))
        cfg = dataclasses.replace(cfg, memory=dataclasses.replace(
            cfg.memory, every_n_layers=every))
    return jcfg, cfg


def _draw_leaves(jp, cfg, seed=5):
    """JAX's tree with the RWKV block's zero leaves drawn (the lerp's μ in
    [0, 1), the others N(0, 0.5²)) or every SSM leaf drawn (projections
    N(0, 1/fan_in), conv_w and the constant leaves N(0, 0.5²)); other
    trees as they are."""
    if cfg.block not in ("rwkv", "hybrid"):
        return jp
    rng = np.random.default_rng(seed)
    blocks = jax.tree.map(np.asarray, jp["blocks"])
    if cfg.block == "rwkv":
        for group, names in RWKV_ZERO_LEAVES.items():
            for name in names:
                shape = blocks[group][name].shape
                draw = rng.random(shape) if name.startswith("mu_") \
                    else 0.5 * rng.standard_normal(shape)
                blocks[group][name] = draw.astype(np.float32)
    else:
        for name, leaf in sorted(blocks["ssm"].items()):
            std = leaf.shape[-2] ** -0.5 if name in SSM_PROJECTIONS else 0.5
            blocks["ssm"][name] = (std * rng.standard_normal(
                leaf.shape)).astype(np.float32)
    return dict(jp, blocks=jax.tree.map(jnp.asarray, blocks))


@functools.lru_cache(maxsize=None)
def jax_weights(jcfg):
    """JAX's weights of ``jcfg`` from PRNGKey(0), constant leaves drawn
    (`_draw_leaves`); one draw a config."""
    return _draw_leaves(jlm.init_params(jax.random.PRNGKey(0), jcfg), jcfg)


def port_weights(jp):
    """A fresh port copy of JAX's tree (a train step updates it in
    place)."""
    return convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def batch(jcfg, seed, n=B, seq=S):
    """A numpy batch: JAX's `concrete_batch` from PRNGKey(seed) for a
    config with a frontend, else tokens and targets from numpy."""
    if jcfg.frontend is not None:
        return {k: np.asarray(v) for k, v in jspecs.concrete_batch(
            jax.random.PRNGKey(seed), jcfg, n, seq).items()}
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, jcfg.vocab_size, (n, seq)).astype(np.int32)
            for k in ("tokens", "targets")}


def tb(b):
    return {k: torch.tensor(v) for k, v in b.items()}


def record_reads(monkeypatch):
    """Every read the port runs, as (q, memory, k, valid_n)."""
    seen = []
    fused_read = ops.fused_read

    def record(q, mem, beta, k, *, valid_n=None, cand_idx=None,
               mem_scale=None):
        seen.append((q.detach().clone(), mem.detach().clone(), k, valid_n))
        return fused_read(q, mem, beta, k, valid_n=valid_n)

    monkeypatch.setattr(ops, "fused_read", record)
    return seen


def record_routes(monkeypatch):
    """Every router softmax the port ranks, as (probs, k)."""
    seen = []
    top_k = moe.top_k

    def record(probs, k):
        seen.append((probs.detach().clone(), k))
        return top_k(probs, k)

    monkeypatch.setattr(moe, "top_k", record)
    return seen


def read_near_tie(reads) -> bool:
    """Whether a read has a row within READ_MARGIN of its K-th similarity
    (f64) that could trade places across K."""
    for q, mem, k, valid_n in reads:
        sims = torch.einsum("bhw,bnw->bhn", ref._normalize(q.double()),
                            ref._normalize(mem[:, :valid_n].double()))
        v = sims.sort(dim=-1, descending=True).values[..., k - 1:k]
        band = (sims - v).abs() <= READ_MARGIN
        straddles = (sims > v + READ_MARGIN).sum(-1) + band.sum(-1) > k
        if (straddles & (band & (sims != v)).any(-1)).any():
            return True
    return False


def assert_read_margins(reads):
    assert reads
    assert not read_near_tie(reads), "a read near-tie at K"


def assert_router_margins(routes):
    """Every token's k-th router probability lies more than ROUTER_MARGIN
    above its (k+1)-th."""
    assert routes
    for probs, k in routes:
        top = probs.sort(dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).min().item()
        assert gap > ROUTER_MARGIN, f"a router near-tie at k: {gap:.3g}"


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(jcfg):
    """`jax.value_and_grad(lm.loss_fn)` of ``jcfg``, jitted once."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def perturbed(tree, draw):
    """JAX's ``tree`` with every float leaf times 1 + 2^-24·N(0, 1): a
    one-ulp perturbation, draw ``draw``."""
    rng = np.random.default_rng(100 + draw)
    return jax.tree.map(lambda t: t * (1 + rng.standard_normal(
        t.shape).astype(np.float32) * 2 ** -24), tree)


def arbitrated_close(got, want, spread, *, tol=GRAD_TOL):
    """Two trees leaf by leaf, each within ``tol`` of max(1, max |want|)
    over the leaf. Where a leaf is not, ``spread()`` gives JAX's own
    results on one-ulp perturbations of its weights (`perturbed`), and
    the leaf's largest miss must lie within SPREAD_FACTOR times JAX's
    largest move over the leaf (the arbiter of `tests/test_torch_swa.py`,
    which takes twice)."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    others = None
    for name, w in want.items():
        g, w = np_(got[name]), np_(w)
        err = np.abs(g - w)
        if err.max() <= tol * max(1.0, float(np.abs(w).max())):
            continue
        if others is None:
            others = [dict(leaves(o)) for o in spread()]
        own = max(float(np.abs(np_(o[name]) - w).max()) for o in others)
        assert err.max() <= SPREAD_FACTOR * own, (
            f"{name}: {err.max():.3g} apart, JAX's own move "
            f"{own:.3g}")


def tree_close(got, want, tol=TOL):
    """Two trees leaf by leaf within `close`."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    for name, w in want.items():
        close(got[name], w, tol)


def check_loss_and_grads(jcfg, cfg, b, *, remat=False):
    """The port's `loss_fn`, its metrics and every gradient leaf against
    `jax.value_and_grad(lm.loss_fn)` on batch ``b``; the port's blocks
    under `torch.utils.checkpoint` with ``remat``."""
    jp = jax_weights(jcfg)
    vg = jax_value_and_grad(jcfg)
    (jloss, jmetrics), jgrads = vg(jp, b)
    cfg = dataclasses.replace(cfg, remat=remat)
    loss, metrics, grads = steps.value_and_grad(port_weights(jp), cfg, tb(b))
    close(loss, jloss)
    for k in ("ce", "aux"):
        close(metrics[k], jmetrics[k])
    arbitrated_close(grads, jgrads, lambda: [
        vg(perturbed(jp, i), b)[1] for i in range(SPREAD_DRAWS)])


def check_train_step(jcfg, cfg, b):
    """Two `make_train_step` steps at JAX's default schedule (rate 3e-4,
    100 warmup steps), the second from JAX's weights and optimizer state
    after the first, against JAX's jitted `train_step`: the loss, ce,
    aux, rate and the parameters within 1e-5, the gradient norm and the
    moments within the gradient bar (JAX's own spread arbitrating, its
    step run on one-ulp perturbations of its weights)."""
    jstep = jax.jit(jsteps.make_train_step(jcfg))
    tstep = steps.make_train_step(cfg)
    jparams = jax_weights(jcfg)
    js = jopt.adamw_init(jparams)
    for _ in range(2):
        tp = port_weights(jparams)
        ts = convert.adamw_state_from_jax(jax.tree.map(np.asarray, js),
                                          device="cpu")
        tp, ts, tm = tstep(tp, ts, tb(b))
        jp1, js1, jm = jstep(jparams, js, b)

        def spread(jparams=jparams, js=js):
            out = [jstep(perturbed(jparams, i), js, b)
                   for i in range(SPREAD_DRAWS)]
            return [{"mu": dict(o[1].mu), "nu": dict(o[1].nu),
                     "grad_norm": o[2]["grad_norm"]} for o in out]

        for k in ("loss", "lr", "ce", "aux"):
            close(tm[k], jm[k])
        tree_close(tp, jp1)
        arbitrated_close(
            {"mu": ts.mu, "nu": ts.nu, "grad_norm": tm["grad_norm"]},
            {"mu": dict(js1.mu), "nu": dict(js1.nu),
             "grad_norm": jm["grad_norm"]}, spread)
        assert int(ts.count) == int(js1.count)
        jparams, js = jp1, js1
