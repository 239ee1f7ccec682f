"""The paper's two remaining tasks in the port (`repro_torch.data.babi`,
`repro_torch.data.omniglot`) against the JAX package's, on the CPU, and
one training step of the paper's memory models on each, as the benches
take it (`benchmarks/bench_babi.py`, `benchmarks/bench_omniglot.py`):

* bAbI-lite batches bit for bit for several generator seeds, lengths
  and batch sizes, and the reference's cut of stories longer than the
  length (174 of 2000 stories from `default_rng(0)` at the bench's 32
  words lose "is <entity>": ROADMAP §C), pinned on both sides;
* one-shot Omniglot episodes equal to JAX's given JAX's own draws (the
  key split as `repro/data/omniglot.py:20` splits it), and the layout of
  the port's own draws: each class `presentations` times a row, the
  previous label one-hot in the last channels;
* one step of the benches' losses (bAbI: softmax cross-entropy of the
  last step's logits of the one-hot story; Omniglot: masked
  cross-entropy over every step, inputs padded to 8 label channels),
  `clip_by_global_norm` at 10 and RMSProp at 1e-3, of ``sam``, ``sdnc``
  and ``lstm`` on a bAbI batch and of ``sam`` on an Omniglot episode, at
  the benches' widths: the loss, every gradient and every new parameter
  against `jax.value_and_grad` of the same loss from JAX's weights
  (carried across by `convert.params_from_jax`), within atol/rtol 1e-5.
  The bAbI batch is cut to 8 stories from the bench's 16, the widths
  kept.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core.training import ModelSpec as JaxModelSpec
from repro.core.training import build_model as jax_build_model
from repro.core.types import ControllerConfig as JaxControllerConfig
from repro.core.types import MemoryConfig as JaxMemoryConfig
from repro.data import babi as jbabi
from repro.data import omniglot as jomniglot
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core import training
from repro_torch.core.types import ControllerConfig, MemoryConfig
from repro_torch.data import babi, omniglot
from repro_torch.optim import optimizers as opt

TOL = 1e-5
V = len(babi.BABI_VOCAB)
BABI_LEN, BABI_B = 32, 8
BABI_MEM = dict(num_slots=64, word_size=24, num_heads=2, k=4)
OMNI_DIM, OMNI_LABELS, OMNI_B, OMNI_P = 16, 8, 8, 5
OMNI_MEM = dict(num_slots=256, word_size=24, num_heads=4, k=4)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


# --------------------------------------------------------------------------
# bAbI-lite
# --------------------------------------------------------------------------

def test_babi_vocabulary_is_the_references():
    assert babi.BABI_VOCAB == jbabi.BABI_VOCAB and V == 27
    assert babi._V == jbabi._V


@pytest.mark.parametrize("seed,batch,length", [
    (0, 16, 32), (1, 16, 32), (2, 5, 48), (3, 64, 20), (4, 1, 8),
    (5, 33, 34)])
def test_babi_batches_match_jax(seed, batch, length):
    """Three batches in a row from one generator on each side, bit for
    bit (tokens, answers and template ids, dtypes and shapes)."""
    g, jg = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        got = babi.babi_lite_batch(g, batch, length)
        want = jbabi.babi_lite_batch(jg, batch, length)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            _equal(a, b)
    assert g.integers(1 << 30) == jg.integers(1 << 30)


def test_babi_cuts_long_stories_as_the_reference():
    """At the bench's length of 32, 174 of 2000 stories from
    `default_rng(0)` run longer (one-fact stories of 5 facts: 34 words);
    both sides keep their first 32 words, so the question ends at
    "<q> where" without its entity. Copied on purpose (ROADMAP §C)."""
    rng = np.random.default_rng(0)
    stories = []
    for _ in range(2000):
        t = rng.integers(3)
        stories.append((int(t), *jbabi._TEMPLATES[t](rng)))
    long = [i for i, (_, words, _) in enumerate(stories) if len(words) > 32]
    assert len(long) == 174
    assert {stories[i][0] for i in long} == {0}
    assert {len(stories[i][1]) for i in long} == {34}
    toks, ans, task = babi.babi_lite_batch(np.random.default_rng(0), 2000, 32)
    _equal(toks, jbabi.babi_lite_batch(np.random.default_rng(0), 2000,
                                       32)[0])
    q, where, pad = babi._V["<q>"], babi._V["where"], babi._V["<pad>"]
    for i, (t, words, answer) in enumerate(stories):
        assert task[i] == t and ans[i] == babi._V[answer]
        _equal(toks[i], babi._encode(words, 32))
        if i in long:
            assert list(toks[i, -2:]) == [q, where]
            assert pad not in toks[i]
    cut = np.array([babi._V[w] for w in stories[long[0]][1]])
    assert list(cut[32:]) == [babi._V["is"], cut[33]]


# --------------------------------------------------------------------------
# One-shot Omniglot
# --------------------------------------------------------------------------

def _jax_draws(key, batch, classes, presentations, dim):
    """JAX's own draws of `omniglot_episode(key, ...)`, split as it splits
    the key (its ``ko`` unused)."""
    T = classes * presentations
    kp, kn, _, kl = jax.random.split(key, 4)
    protos = jax.random.normal(kp, (batch, classes, dim))
    ids = jnp.tile(jnp.arange(classes), presentations)
    ids = jax.vmap(lambda k: jax.random.permutation(k, ids))(
        jax.random.split(kl, batch))
    return protos, ids, jax.random.normal(kn, (batch, T, dim))


@pytest.mark.parametrize("seed,batch,classes,presentations,dim", [
    (0, 8, 5, 5, 16), (1, 8, 8, 5, 16), (2, 3, 2, 10, 32), (3, 1, 4, 1, 8)])
def test_omniglot_episode_matches_jax_given_its_draws(seed, batch, classes,
                                                      presentations, dim):
    key = jax.random.PRNGKey(seed)
    want = jomniglot.omniglot_episode(key, batch, classes,
                                      presentations=presentations, dim=dim)
    protos, ids, noise = _jax_draws(key, batch, classes, presentations, dim)
    got = omniglot.omniglot_episode(
        batch, classes, presentations, dim, protos=protos, ids=ids,
        noise_draws=noise, device="cpu")
    T = classes * presentations
    assert got[0].shape == (batch, T, dim + classes)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    for a, b in zip(got, want, strict=True):
        _equal(a.numpy(), b)


def test_omniglot_torch_draws_layout():
    """The port's own draws: each class exactly `presentations` times in
    every row, the example channels the prototype of the step's class
    plus 0.3 times the noise, the last channels the previous step's
    one-hot (zeros at step 0), the mask all ones; the same generator seed
    gives the same episode, another seed another."""
    B, C, P, D = 4, 6, 7, 16
    inputs, ids, mask = omniglot.omniglot_episode(
        B, C, P, D, generator=torch.Generator().manual_seed(5), device="cpu")
    T = C * P
    assert inputs.shape == (B, T, D + C) and ids.shape == (B, T)
    for row in ids:
        _equal(torch.bincount(row, minlength=C).numpy(), np.full(C, P))
    assert not all(torch.equal(ids[0], r) for r in ids[1:])
    onehot = torch.nn.functional.one_hot(ids, C).float()
    _equal(inputs[:, 0, D:].numpy(), np.zeros((B, C)))
    _equal(inputs[:, 1:, D:].numpy(), onehot[:, :-1].numpy())
    _equal(mask.numpy(), np.ones((B, T)))
    g = torch.Generator().manual_seed(5)
    protos = torch.randn((B, C, D), generator=g)
    for _ in range(B):
        torch.randperm(T, generator=g)
    noise = torch.randn((B, T, D), generator=g)
    want = protos[torch.arange(B)[:, None], ids] + 0.3 * noise
    assert torch.equal(inputs[..., :D], want)
    again = omniglot.omniglot_episode(
        B, C, P, D, generator=torch.Generator().manual_seed(5), device="cpu")
    for a, b in zip(again, (inputs, ids, mask)):
        assert torch.equal(a, b)
    other = omniglot.omniglot_episode(
        B, C, P, D, generator=torch.Generator().manual_seed(6), device="cpu")
    assert not torch.equal(other[0], inputs)


# --------------------------------------------------------------------------
# One training step on each task, against JAX
# --------------------------------------------------------------------------

def _jax_losses():
    def babi_loss(ys, batch):
        toks, ans = batch
        return -jnp.take_along_axis(jax.nn.log_softmax(ys[-1]),
                                    ans[:, None], 1).mean()

    def omni_loss(ys, batch):
        _, labels, mask = batch
        lp = jax.nn.log_softmax(jnp.moveaxis(ys, 0, 1))
        b = jnp.arange(labels.shape[0])[:, None]
        t = jnp.arange(labels.shape[1])[None, :]
        return -(lp[b, t, labels] * mask).sum() / mask.sum()
    return {"babi": babi_loss, "omniglot": omni_loss}


def _torch_losses():
    def babi_loss(ys, batch):
        toks, ans = batch
        lp = torch.log_softmax(ys[-1], -1)
        return -lp.gather(1, ans[:, None].long()).mean()

    def omni_loss(ys, batch):
        _, labels, mask = batch
        lp = torch.log_softmax(ys.transpose(0, 1), -1)
        picked = lp.gather(-1, labels[..., None].long())[..., 0]
        return -(picked * mask).sum() / mask.sum()
    return {"babi": babi_loss, "omniglot": omni_loss}


def _batch(task):
    """The task's batch as (time-major model inputs, the loss's batch),
    numpy: a bAbI batch from `default_rng(0)`; an Omniglot episode of 5
    classes from PRNGKey(0), padded to 8 label channels as the bench
    pads it."""
    if task == "babi":
        toks, ans, _ = jbabi.babi_lite_batch(np.random.default_rng(0),
                                             BABI_B, BABI_LEN)
        xs = np.moveaxis(np.eye(V, dtype=np.float32)[toks], 1, 0)
        return xs, (toks, ans)
    inputs, labels, mask = (np.asarray(t) for t in jomniglot.omniglot_episode(
        jax.random.PRNGKey(0), OMNI_B, 5, presentations=OMNI_P,
        dim=OMNI_DIM))
    inputs = np.pad(inputs, ((0, 0), (0, 0), (0, OMNI_LABELS - 5)))
    return np.moveaxis(inputs, 1, 0), (inputs, labels, mask)


def _specs(kind, task):
    if task == "babi":
        mem, ctl = BABI_MEM, dict(input_size=V, hidden_size=128,
                                  output_size=V)
    else:
        mem, ctl = OMNI_MEM, dict(input_size=OMNI_DIM + OMNI_LABELS,
                                  hidden_size=100, output_size=OMNI_LABELS)
    return (JaxModelSpec(kind, JaxMemoryConfig(backend="ref", **mem),
                         JaxControllerConfig(**ctl)),
            training.ModelSpec(kind, MemoryConfig(**mem),
                               ControllerConfig(**ctl)))


@pytest.mark.parametrize("kind,task", [("sam", "babi"), ("sdnc", "babi"),
                                       ("lstm", "babi"),
                                       ("sam", "omniglot")])
def test_one_train_step_matches_jax(kind, task):
    """One step from JAX's weights (PRNGKey(0), as the benches draw them)
    and a zero RMSProp state: the loss, every gradient before the clip,
    the clipped norm's scale, the new weights and accumulators."""
    jspec, spec = _specs(kind, task)
    j_init, j_init_s, j_unroll = jax_build_model(jspec)
    _, init_s, unroll = training.build_model(spec, device="cpu")
    xs, batch = _batch(task)
    B = xs.shape[1]
    jloss = _jax_losses()[task]

    def loss_fn(p):
        _, ys = j_unroll(p, j_init_s(B), jnp.asarray(xs))
        return jloss(ys, tuple(jnp.asarray(t) for t in batch))

    jparams = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    j_l, j_g = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    j_gc, j_norm = jopt.clip_by_global_norm(j_g, 10.0)
    j_new, j_state = jopt.rmsprop_update(jparams, j_gc,
                                         jopt.rmsprop_init(jparams), lr=1e-3)

    params = convert.params_from_jax(jparams, device="cpu")
    leaves, treedef = pytree.tree_flatten(params)
    p = pytree.tree_unflatten([x.clone().requires_grad_() for x in leaves],
                              treedef)
    _, ys = unroll(p, init_s(B), torch.tensor(xs))
    loss = _torch_losses()[task](ys, tuple(torch.tensor(t) for t in batch))
    grads = torch.autograd.grad(loss, pytree.tree_leaves(p))
    grads = pytree.tree_unflatten(list(grads), treedef)
    gc, norm = opt.clip_by_global_norm(grads, 10.0)
    new, state = opt.rmsprop_update(params, gc, opt.rmsprop_init(params),
                                    lr=1e-3)

    np.testing.assert_allclose(loss.item(), float(j_l), rtol=TOL)
    np.testing.assert_allclose(norm.item(), float(j_norm), rtol=TOL)
    for got, want in ((grads, j_g), (new, j_new), (state.acc, j_state.acc)):
        want = jax.tree_util.tree_flatten_with_path(want)[0]
        got = ckpt.flatten_with_paths(got)
        assert [path for path, _ in got] == [
            "/".join(k.key for k in path) for path, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert tuple(a.shape) == b.shape
            _close(a.detach().numpy(), b)
    assert float(j_norm) > 0.0 and np.isfinite(float(j_l))
