"""Training harness for the paper's synthetic tasks (§4.2/§4.3: copy,
associative recall, priority sort), the port of `repro/core/training.py`
(`ModelSpec`, `build_model`, `bits_loss`, `bits_error`,
`make_task_train_step`, `train_task`) for the kinds ``sam`` (exact read),
``sam_ann`` (the LSH read) and ``sdnc`` (the sparse DNC), which train
through the sparse-rollback engine by default (`core/unroll.py`), and the
dense baselines ``dam``, ``ntm``, ``lstm`` (`core/dense.py`) and ``dnc``
(`core/dnc.py`), which train by a plain loop under autograd: RMSProp
(paper Suppl. C) on sigmoid cross-entropy over the output bits.

The streaming trainer (`TrainLoopState`, `make_streaming_train_step`,
`train_task_streaming`) trains long episodes as a stream: one update per
C-step chunk, the recurrent state carried from chunk to chunk (truncated
BPTT), and checkpoints of {params, opt, carry, loop} in the JAX package's
format and paths mid-episode, so a killed job resumes at its chunk. After
a sparse or chunked backward the carry is brought back with
`unroll.roll_forward` (the backward rolls the buffers back in place).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.core import dense as dense_lib
from repro_torch.core import dnc as dnc_lib
from repro_torch.core import unroll as unroll_lib
from repro_torch.core.cell import SAMCell, SDNCCell
from repro_torch.core.sam import SAMConfig
from repro_torch.core.types import ControllerConfig, MemoryConfig
from repro_torch.data.curriculum import Curriculum
from repro_torch.data.tasks import (associative_recall_task, copy_task,
                                    priority_sort_task)
from repro_torch.optim import optimizers as opt

TASKS = {"copy": copy_task, "associative_recall": associative_recall_task,
         "priority_sort": priority_sort_task}
KINDS = ("sam", "sam_ann", "sdnc", "dam", "ntm", "dnc", "lstm")
# The kinds whose rows take ``MemoryConfig.mem_dtype``.
DTYPE_KINDS = ("sam", "sam_ann", "sdnc")
# Stricter than the reference on purpose (ROADMAP §C): JAX's dense models
# build f32 rows whatever mem_dtype says; the port refuses rather than
# train other rows than the configuration names.
DENSE_DTYPE = ("the dense DAM, NTM, DNC and the LSTM keep f32 rows: the JAX "
               "models ignore mem_dtype, so the port refuses it rather than "
               "silently train f32 rows")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    kind: str                     # sam | sam_ann | sdnc | dam | ntm | dnc | lstm
    memory: MemoryConfig
    controller: ControllerConfig
    # Sparse cells (sam, sam_ann, sdnc): train through the sparse-rollback
    # engine (False -> the naive loop). The dense kinds always run the
    # plain loop.
    sparse_bptt: bool = True
    # Segment length C for the chunked engine: None -> whole-sequence
    # sparse, an int or "auto" -> chunked with O(T/C·state + C·K·W)
    # residuals (core/unroll.py).
    bptt_chunk: Optional[Union[int, str]] = None


def build_model(spec: ModelSpec, *, device="cuda"):
    """Returns (init_params(generator), init_state(batch),
    unroll(params, state, xs)). Kinds ``sam`` and ``sam_ann`` (the SAM cell
    with ``ann="lsh"``) and ``sdnc`` (the sparse DNC, exact or LSH as
    ``memory.ann`` says) train through the sparse-rollback engine behind
    `SAMCell` and `SDNCCell`; ``dam`` and ``ntm`` unroll
    `dense.dense_unroll`, ``dnc`` `dnc.dnc_unroll` and ``lstm`` the bare
    controller, whose state is the batch size, all in a plain loop. Any
    other kind raises. ``memory.mem_dtype`` holds the rows of ``sam``,
    ``sam_ann`` (f32, bf16, int8) and ``sdnc`` (f32, bf16; int8 raises,
    as in JAX) as JAX's `build_model` holds them; the dense kinds raise on
    anything but f32 (`DENSE_DTYPE`)."""
    if spec.kind not in KINDS:
        raise ValueError(f"unknown model kind {spec.kind!r}")
    if spec.memory.mem_dtype != "float32" and spec.kind not in DTYPE_KINDS:
        raise ValueError(f"build_model({spec.kind!r}) with mem_dtype="
                         f"{spec.memory.mem_dtype!r}: {DENSE_DTYPE}")
    if spec.kind in ("dam", "ntm"):
        cfg = dense_lib.DenseConfig(spec.memory, spec.controller,
                                    model=spec.kind)
        return (functools.partial(dense_lib.init_params, cfg=cfg,
                                  device=device),
                functools.partial(dense_lib.init_state, cfg=cfg,
                                  device=device),
                lambda p, s, xs: dense_lib.dense_unroll(p, cfg, s, xs))
    if spec.kind == "dnc":
        cfg = dnc_lib.DNCConfig(spec.memory, spec.controller, sparse=False)
        return (functools.partial(dnc_lib.init_params, cfg=cfg,
                                  device=device),
                functools.partial(dnc_lib.init_state, cfg=cfg, device=device),
                lambda p, s, xs: dnc_lib.dnc_unroll(p, cfg, s, xs))
    if spec.kind == "lstm":
        return (functools.partial(dense_lib.lstm_baseline_init,
                                  cfg=spec.controller, device=device),
                lambda batch: batch,
                lambda p, batch, xs: dense_lib.lstm_baseline_unroll(
                    p, spec.controller, batch, xs))
    if spec.kind == "sdnc":
        cell = SDNCCell(dnc_lib.DNCConfig(spec.memory, spec.controller,
                                          sparse=True))
    else:
        mem = dataclasses.replace(
            spec.memory, ann="lsh" if spec.kind == "sam_ann" else "exact")
        cell = SAMCell(SAMConfig(mem, spec.controller))
    if not spec.sparse_bptt:
        mode, chunk = "naive", None
    elif spec.bptt_chunk is None:
        mode, chunk = "sparse", None
    else:
        mode, chunk = "chunked", spec.bptt_chunk
    return (functools.partial(cell.init_params, device=device),
            functools.partial(cell.init_state, device=device),
            functools.partial(unroll_lib.unroll, cell, mode=mode, chunk=chunk))


def bits_loss(logits, targets, mask):
    """Sigmoid CE per output bit, masked to the answer span.

    logits/targets: (T, B, bits); mask: (T, B)."""
    ce = (logits.clamp_min(0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    return (ce.sum(-1) * mask).sum() / mask.sum().clamp_min(1.0)


def bits_error(logits, targets, mask):
    pred = (logits > 0).float()
    err = ((pred - targets).abs().sum(-1) * mask).sum()
    return err / mask.sum().clamp_min(1.0)


def make_task_train_step(spec: ModelSpec, lr: float = 1e-4, *, device="cuda"):
    """Returns (init_params, init_state, step). ``step(params, opt_state,
    inputs, targets, mask)`` takes batch-major (B, T, ...) tensors and
    returns (params, opt_state, loss, err), new trees beside the old. A
    leaf the loss does not reach (an LSH cell's fixed planes) gets a zero
    gradient, as under `jax.grad`: RMSProp leaves it as it was and decays
    its accumulator."""
    init_p, init_s, unroll = build_model(spec, device=device)

    def step(params, opt_state, inputs, targets, mask):
        xs = inputs.transpose(0, 1)                     # time-major
        ts = targets.transpose(0, 1)
        ms = mask.transpose(0, 1)
        leaves, spec_p = pytree.tree_flatten(params)
        with torch.enable_grad():
            p = pytree.tree_unflatten(
                [x.detach().requires_grad_() for x in leaves], spec_p)
            _, ys = unroll(p, init_s(inputs.shape[0]), xs)
            loss = bits_loss(ys, ts, ms)
            p_leaves = pytree.tree_leaves(p)
            grads = torch.autograd.grad(loss, p_leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(p_leaves, grads)]
        with torch.no_grad():
            err = bits_error(ys, ts, ms)
            grads, _ = opt.clip_by_global_norm(
                pytree.tree_unflatten(list(grads), spec_p), 10.0)
            params, opt_state = opt.rmsprop_update(params, grads, opt_state,
                                                   lr=lr)
        return params, opt_state, loss.detach(), err

    return init_p, init_s, step


def train_task(spec: ModelSpec, task: str, *, steps: int = 200,
               batch: int = 8, level: int = 4, max_level: int = 8,
               bits: int = 8, lr: float = 1e-4, seed: int = 0,
               curriculum: Curriculum = None, log_every: int = 25,
               verbose: bool = False, device="cuda"):
    """Train one model on one task; returns (params, the loss/error
    history). The weights and every batch are drawn from
    ``torch.Generator``s seeded with ``seed``, the curriculum's levels
    from ``numpy.random.default_rng(seed)``."""
    task_fn = TASKS[task]
    init_p, init_s, step = make_task_train_step(spec, lr, device=device)
    params = init_p(torch.Generator().manual_seed(seed))
    opt_state = opt.rmsprop_init(params)
    data = torch.Generator().manual_seed(seed + 1)
    rng = np.random.default_rng(seed)

    history = []
    t0 = time.time()
    for i in range(steps):
        lvl = curriculum.sample_level(rng) if curriculum else level
        inputs, targets, mask = task_fn(batch, lvl, max_level, bits,
                                        generator=data, device=device)
        params, opt_state, loss, err = step(params, opt_state, inputs,
                                            targets, mask)
        lf, ef = float(loss), float(err)
        history.append({"step": i, "loss": lf, "err": ef,
                        "level": int(curriculum.level) if curriculum else lvl})
        if curriculum:
            curriculum.update(ef)
        if verbose and i % log_every == 0:
            print(f"  [{spec.kind}/{task}] step {i} loss={lf:.4f} "
                  f"err={ef:.3f} ({time.time()-t0:.0f}s)")
    return params, history


# --------------------------------------------------------------------------
# The streaming trainer: truncated BPTT over long episodes, with
# mid-episode checkpoints (the JAX package's `train_task_streaming`)
# --------------------------------------------------------------------------

# The item that ports streaming on a slot-sharded memory (a train step on
# one, `make_task_train_step` inside `mem_shard.memory_mesh`, runs).
MESH_ITEM = "ROADMAP.md A11, item 4"


class TrainLoopState(NamedTuple):
    """Where training stands, checkpointed beside params and optimizer:
    episodes done, the chunk cursor in the current one, the curriculum's
    level and streak, and the episode's running error (sum and count of
    its finite chunk errors), so the curriculum's update at the episode's
    end sees every chunk across a resume. JAX's field names, so the
    checkpoint paths are JAX's. 0-d tensors on the host."""

    episode: torch.Tensor   # () int32
    cursor: torch.Tensor    # () int32
    level: torch.Tensor     # () int32
    streak: torch.Tensor    # () int32
    err_sum: torch.Tensor   # () float32
    err_cnt: torch.Tensor   # () int32


def _i32(v) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32)


def init_loop_state(level: int) -> TrainLoopState:
    return TrainLoopState(episode=_i32(0), cursor=_i32(0), level=_i32(level),
                          streak=_i32(0),
                          err_sum=torch.zeros((), dtype=torch.float32),
                          err_cnt=_i32(0))


def _detached(tree):
    return pytree.tree_map(
        lambda t: t.detach() if isinstance(t, torch.Tensor) else t, tree)


def make_streaming_train_step(spec: ModelSpec, lr: float = 1e-4, *,
                              device="cuda"):
    """One RMSProp update per chunk of a long episode. Returns (init_params,
    init_state, chunk_step); ``chunk_step(params, opt_state, carry, xs, ts,
    ms)`` takes time-major (C, B, ...) tensors and returns (params,
    opt_state, carry, loss, err): the carry is the chunk's final state,
    detached, and live after a sparse or chunked backward
    (`unroll.roll_forward`), so the next chunk steps on from it. The
    sparse cells' carry holds the same buffers as the one given, updated in
    place."""
    init_p, init_s, unroll = build_model(spec, device=device)

    def chunk_step(params, opt_state, carry, xs, ts, ms):
        leaves, spec_p = pytree.tree_flatten(params)
        with torch.enable_grad():
            p = pytree.tree_unflatten(
                [x.detach().requires_grad_() for x in leaves], spec_p)
            state, ys = unroll(p, carry, xs)
            loss = bits_loss(ys, ts, ms)
            p_leaves = pytree.tree_leaves(p)
            grads = torch.autograd.grad(loss, p_leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(p_leaves, grads)]
        carry = _detached(unroll_lib.roll_forward(state))
        with torch.no_grad():
            err = bits_error(ys, ts, ms)
            grads, _ = opt.clip_by_global_norm(
                pytree.tree_unflatten(list(grads), spec_p), 10.0)
            params, opt_state = opt.rmsprop_update(params, grads, opt_state,
                                                   lr=lr)
        return params, opt_state, carry, loss.detach(), err

    return init_p, init_s, chunk_step


def _episode_level(seed: int, episode: int, level_cap: int) -> int:
    """The episode's level, drawn from U(1, cap) by (seed, episode) alone
    (JAX's draw, in numpy), so a resumed run draws it again."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, episode]))
    return int(rng.integers(1, level_cap + 1))


def _episode_generator(seed: int, episode: int) -> torch.Generator:
    """The episode's data generator, seeded by (seed, episode) alone."""
    word = np.random.SeedSequence([seed, episode, 1]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(word))


def train_task_streaming(spec: ModelSpec, task: str, *, episodes: int = 4,
                         chunk: int = 32, batch: int = 4, level: int = 4,
                         max_level: int = 8, bits: int = 8, lr: float = 1e-4,
                         seed: int = 0, curriculum: Curriculum = None,
                         ckpt_dir: str = None, ckpt_every: int = 0,
                         stop_after_chunks: int = None, verbose: bool = False,
                         mesh=None, device="cuda"):
    """Stream episodes through `make_streaming_train_step`, one update per
    ``chunk`` time steps, the carry kept across the chunks of an episode
    and made anew at its start. Returns (params, history), history holding
    {episode, chunk, level, loss, err} a chunk.

    Weights come from ``seed``; an episode's level (`_episode_level`) and
    data (`_episode_generator`) from (seed, episode), so a restored
    mid-episode checkpoint replays nothing: training goes on at
    ``loop.cursor`` with the restored carry. With ``ckpt_dir`` and
    ``ckpt_every`` it saves {params, opt, carry, loop} every
    ``ckpt_every`` chunks and at each episode's end (step = chunks trained,
    counted on from a restored step), synchronously as JAX's does, with
    ``mem_layout=(num_slots, 1)``; it restores the newest one first (a
    params/opt-only checkpoint loads, the missing leaves from the
    template). ``stop_after_chunks`` stops the loop once that many chunks
    have been trained (a kill, for tests). A ``mesh`` raises (A11)."""
    if mesh is not None:
        raise NotImplementedError(f"streaming on a slot-sharded memory is "
                                  f"not ported yet: {MESH_ITEM}")
    task_fn = TASKS[task]
    init_p, init_s, chunk_step = make_streaming_train_step(spec, lr,
                                                           device=device)
    params = init_p(torch.Generator().manual_seed(seed))
    opt_state = opt.rmsprop_init(params)
    carry = init_s(batch)
    mem_layout = (spec.memory.num_slots, 1)
    loop = init_loop_state(curriculum.level if curriculum else level)

    restored = None
    if ckpt_dir:
        template = {"params": params, "opt": opt_state, "carry": carry,
                    "loop": loop}
        restored, at = ckpt_lib.restore_checkpoint(
            ckpt_dir, template, fill_missing=True,
            expect_num_slots=spec.memory.num_slots)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            carry, loop = restored["carry"], restored["loop"]
            if verbose:
                print(f"  [resume] step {at} episode={int(loop.episode)} "
                      f"cursor={int(loop.cursor)}")
    if curriculum:
        curriculum.level = int(loop.level)
        curriculum._streak = int(loop.streak)

    def save(step):
        ckpt_lib.save_checkpoint(
            ckpt_dir, step, {"params": params, "opt": opt_state,
                             "carry": carry, "loop": loop},
            mem_layout=mem_layout)

    history = []
    # The step numbering goes on from the restored step: a newer state
    # under a smaller step would lose to the stale one on the next resume.
    total = at if restored is not None else 0
    while int(loop.episode) < episodes:
        ep = int(loop.episode)
        cap = curriculum.level if curriculum else level
        lvl = _episode_level(seed, ep, cap)
        inputs, targets, mask = task_fn(
            batch, lvl, max_level, bits,
            generator=_episode_generator(seed, ep), device=device)
        xs, ts, ms = (t.transpose(0, 1) for t in (inputs, targets, mask))
        T = xs.shape[0]
        n_chunks = -(-T // chunk)
        while int(loop.cursor) < n_chunks:
            c = int(loop.cursor)
            sl = slice(c * chunk, min((c + 1) * chunk, T))
            params, opt_state, carry, loss, err = chunk_step(
                params, opt_state, carry, xs[sl], ts[sl], ms[sl])
            ef = float(err)
            history.append({"episode": ep, "chunk": c, "level": lvl,
                            "loss": float(loss), "err": ef})
            finite = ef == ef
            loop = loop._replace(
                cursor=loop.cursor + 1,
                err_sum=loop.err_sum + (ef if finite else 0.0),
                err_cnt=loop.err_cnt + (1 if finite else 0))
            total += 1
            if ckpt_dir and ckpt_every and total % ckpt_every == 0:
                save(total)
            if stop_after_chunks is not None and total >= stop_after_chunks:
                return params, history
        # The episode's end: the curriculum moves on the running error of
        # all its chunks (skipped where none was finite, as on a resume
        # that landed after the update), then carry and cursor start anew.
        ep_err = (float(loop.err_sum) / int(loop.err_cnt)
                  if int(loop.err_cnt) else None)
        if curriculum and ep_err is not None:
            curriculum.update(ep_err)
        loop = init_loop_state(curriculum.level if curriculum else level)
        loop = loop._replace(
            episode=_i32(ep + 1),
            streak=_i32(curriculum._streak if curriculum else 0))
        carry = init_s(batch)
        if ckpt_dir and ckpt_every:
            save(total)
        if verbose:
            print(f"  [{spec.kind}/{task}] episode {ep} done (err="
                  f"{ep_err if ep_err is not None else float('nan'):.3f})")
    return params, history

