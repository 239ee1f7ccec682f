"""Carry a JAX model's weights and state across to the port.

Both sides share names and layout: weights are the tree
``{"lstm": {wx, wh, b}, "iface": {w, b}, "out": {w, b}}`` (SAM, DAM and
the NTM) or ``{"lstm": ..., "out": ...}`` (the LSTM baseline), with
matrices kept (in, out), so ``x @ w`` holds on both sides, plus
``lsh_planes`` (T, bits, W) for an LSH cell. SAM's state is the
scratch-row `SAMState`, with the single-device LSH index (`ANNState`,
P = 1) where there is one; the dense models' is `DenseState`, with a plain
(B, N, W) memory; the DNC's and the SDNC's is `dnc.DNCState`
(`dnc_state_from_jax`), whose weights share SAM's three groups. `sharded_state_from_jax` cuts a SAM state into one
rank's block of a slot-sharded memory. The LM's weights are the nested
tree of `models/lm.py::param_defs` (stacked ``blocks``, ``memory``, ``embed``,
``final_norm``, ``lm_head``) on both sides; its cache is {"k", "v", "pos"}
(with "ksum" for the sparse decode, "conv" and "ssm" in a hybrid block),
MLA's {"ckv", "pos"} or RWKV's {"tm_shift", "wkv", "cm_shift", "pos"},
its memory states a tuple of `sam_layer.MemoryState` and its optimizer
state an `AdamWState` (`adamw_state_from_jax`); a serving
session (`session_from_jax`) holds both for one lane. The functions
take numpy leaves (or anything `numpy.asarray` reads) and import nothing
of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import (SCRATCH_ROWS, SLOT_LEAVES, ANNState,
                                    DenseState, LSTMState, SAMState,
                                    SparseRead)
from repro_torch.optim.optimizers import AdamWState, RMSPropState

_PARAM_GROUPS = {"lstm": ("wx", "wh", "b"), "iface": ("w", "b"),
                 "out": ("w", "b")}
# The LSTM baseline's tree: the controller and its output layer only.
_LSTM_GROUPS = ("lstm", "out")


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype)).to(device)


def params_from_jax(tree, *, device="cuda"):
    """A JAX weight tree -> the port's parameter dict, leaf for leaf in the
    same (in, out) orientation: `sam.init_params`' and
    `dense.init_params`' three groups (an LSH cell's ``lsh_planes`` (T,
    bits, W) come across as they are), or `dense.lstm_baseline_init`'s
    ``lstm`` and ``out``. Raises on any other tree."""
    if set(tree) == set(_LSTM_GROUPS):
        groups = _LSTM_GROUPS
    elif set(tree) - {"lsh_planes"} == set(_PARAM_GROUPS):
        groups = tuple(_PARAM_GROUPS)
    else:
        raise ValueError(f"expected groups {sorted(_PARAM_GROUPS)} (and "
                         f"lsh_planes), or {sorted(_LSTM_GROUPS)}, got "
                         f"{sorted(tree)}")
    out = {}
    for group in groups:
        names = _PARAM_GROUPS[group]
        if set(tree[group]) != set(names):
            raise ValueError(f"{group}: expected {names}, got "
                             f"{sorted(tree[group])}")
        out[group] = {n: _tensor(tree[group][n], np.float32, device)
                      for n in names}
    if "lsh_planes" in tree:
        planes = _tensor(tree["lsh_planes"], np.float32, device)
        if planes.dim() != 3:
            raise ValueError(f"lsh_planes must be (T, bits, W), got "
                             f"{tuple(planes.shape)}")
        out["lsh_planes"] = planes
    return out


def ann_from_jax(ann, *, device="cuda") -> ANNState:
    """JAX `ANNState` -> the port's, field for field. Raises on an index
    with more than one ownership partition (the sharded index is not
    ported)."""
    buckets = _tensor(ann.buckets, np.int32, device)
    if buckets.dim() != 5 or buckets.shape[3] != 1:
        raise ValueError(f"only the single-device LSH index (P = 1) "
                         f"converts, got buckets {tuple(buckets.shape)}")
    return ANNState(buckets=buckets,
                    cursor=_tensor(ann.cursor, np.int32, device))


def memory_from_jax(memory, *, device="cuda") -> torch.Tensor:
    """A JAX memory buffer -> a tensor of the same storage dtype and bits:
    f32 and int8 as they are; bf16 (an ``ml_dtypes`` array, which
    `torch.as_tensor` cannot take) through f32, exactly. Raises on any
    other dtype."""
    x = np.asarray(memory)
    name = str(x.dtype)
    if name == "bfloat16":
        return _tensor(x, np.float32, device).to(torch.bfloat16)
    if name not in ("float32", "int8"):
        raise ValueError(f"memory of dtype {name}: expected float32, "
                         f"bfloat16 or int8")
    return _tensor(x, x.dtype, device)


def state_from_jax(state, *, device="cuda") -> SAMState:
    """JAX `SAMState` (exact or LSH read, scratch-row layout) -> the port's
    `SAMState`, field for field. The memory keeps its storage dtype and
    bits (f32, bf16 or int8, `memory_from_jax`); an int8 state's per-row
    scales ``mem_scale`` (B, N+1) come across as f32."""
    scale = getattr(state, "mem_scale", None)
    memory = memory_from_jax(state.memory, device=device)
    if (scale is not None) != (memory.dtype == torch.int8):
        raise ValueError(f"a {memory.dtype} memory "
                         f"{'with' if scale is not None else 'without'} "
                         f"mem_scale: int8 rows, and only they, carry scales")
    read = _read_from_jax(state.read, device)
    ctrl = LSTMState(h=_tensor(state.ctrl.h, np.float32, device),
                     c=_tensor(state.ctrl.c, np.float32, device))
    return SAMState(memory=memory,
                    last_access=_tensor(state.last_access, np.int32, device),
                    read=read, ctrl=ctrl,
                    step=_tensor(state.step, np.int32, device),
                    ann=(None if state.ann is None
                         else ann_from_jax(state.ann, device=device)),
                    mem_scale=(None if scale is None
                               else _tensor(scale, np.float32, device)))


def sharded_state_from_jax(state, ctx, *, device="cuda") -> SAMState:
    """A JAX `SAMState` in the canonical (B, N+1, ...) layout -> this
    rank's state of the slot-sharded memory of context ``ctx``
    (`mem_shard.MemShardCtx`): each `SLOT_LEAVES` leaf becomes block
    ``ctx.rank`` (`mem_shard.shard_block`), every other leaf is
    replicated. Raises on a state whose memory is not canonical for
    ``ctx.num_slots``."""
    from repro_torch.distributed import mem_shard
    full = state_from_jax(state, device=device)
    if full.memory.shape[1] != ctx.num_slots + SCRATCH_ROWS:
        raise ValueError(f"expected a canonical (B, {ctx.num_slots} + 1, W) "
                         f"memory, got {tuple(full.memory.shape)}")
    return full._replace(**{
        name: mem_shard.shard_block(getattr(full, name), ctx.num_slots,
                                    ctx.shards, ctx.rank)
        for name in SLOT_LEAVES if getattr(full, name, None) is not None})


def dense_state_from_jax(state, *, device="cuda") -> DenseState:
    """JAX `DenseState` (DAM or the NTM) -> the port's, leaf for leaf: the
    (B, N, W) f32 memory (no scratch row), the (B, N) usage, the (B, H, N)
    read and write weights, the read words, the controller and the step.
    Raises on a memory that is not (B, N, W) beside a (B, N) usage."""
    f32 = {name: _tensor(getattr(state, name), np.float32, device)
           for name in ("memory", "usage", "read_w", "read_words", "write_w")}
    B, N = f32["usage"].shape
    if f32["memory"].dim() != 3 or f32["memory"].shape[:2] != (B, N):
        raise ValueError(f"a dense memory is (B, N, W) beside its (B, N) "
                         f"usage, got {tuple(f32['memory'].shape)} and "
                         f"{(B, N)}")
    ctrl = LSTMState(h=_tensor(state.ctrl.h, np.float32, device),
                     c=_tensor(state.ctrl.c, np.float32, device))
    return DenseState(ctrl=ctrl, step=_tensor(state.step, np.int32, device),
                      **f32)


def _read_from_jax(read, device) -> SparseRead:
    return SparseRead(indices=_tensor(read.indices, np.int32, device),
                      weights=_tensor(read.weights, np.float32, device),
                      words=_tensor(read.words, np.float32, device))


def dnc_state_from_jax(state, *, device="cuda"):
    """JAX `dnc.DNCState` -> the port's, field for field: the dense DNC's
    (B, N, W) memory, f32 usage and (B, N, N) link, or the SDNC's
    scratch-row memory, int32 usage table, sparse read, precedence and
    N_t/P_t, with its LSH index where there is one (`ann_from_jax`). The
    SDNC's memory may hold f32 or bf16 rows (bf16 bits carried as they
    are); any other memory raises, as does a dense DNC's that is not f32
    (JAX builds neither)."""
    from repro_torch.core.dnc import DNCState, SparseMat, SparseVec
    memory = memory_from_jax(state.memory, device=device)
    sparse = state.n_mat is not None
    takes = (torch.float32, torch.bfloat16) if sparse else (torch.float32,)
    if memory.dtype not in takes:
        raise ValueError(f"a {memory.dtype} {'SDNC' if sparse else 'DNC'} "
                         f"memory: the port's SDNC takes f32 or bf16 rows, "
                         f"its DNC f32")

    def f32(x):
        return _tensor(x, np.float32, device)

    def i32(x):
        return _tensor(x, np.int32, device)

    def mat(m):
        return SparseMat(cols=i32(m.cols), vals=f32(m.vals))

    return DNCState(
        memory=memory, usage=(i32 if sparse else f32)(state.usage),
        read_w=f32(state.read_w),
        read=None if state.read is None else _read_from_jax(state.read,
                                                            device),
        read_words=f32(state.read_words), write_w=f32(state.write_w),
        write_idx=i32(state.write_idx), prec=f32(state.prec),
        prec_sp=(None if state.prec_sp is None else
                 SparseVec(idx=i32(state.prec_sp.idx),
                           val=f32(state.prec_sp.val))),
        link=f32(state.link),
        n_mat=mat(state.n_mat) if sparse else None,
        p_mat=mat(state.p_mat) if sparse else None,
        ctrl=LSTMState(h=f32(state.ctrl.h), c=f32(state.ctrl.c)),
        step=i32(state.step),
        ann=(None if state.ann is None
             else ann_from_jax(state.ann, device=device)))


def opt_state_from_jax(state, *, device="cuda") -> RMSPropState:
    """JAX `optimizers.RMSPropState` (its ``acc`` tree in the parameters'
    layout, the planes' accumulator included) -> the port's
    `RMSPropState`, leaf for leaf."""
    return RMSPropState(acc=params_from_jax(state.acc, device=device))


# --------------------------------------------------------------------------
# The LM
# --------------------------------------------------------------------------

_LM_GROUPS = ("embed", "blocks", "dense_blocks", "final_norm", "lm_head",
              "memory")


def _float_leaf(x, device) -> torch.Tensor:
    """An f32 or bf16 leaf -> a tensor of the same dtype and bits."""
    name = str(np.asarray(x).dtype)
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"a leaf of dtype {name}: expected float32 or "
                         f"bfloat16")
    return memory_from_jax(x, device=device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _float_leaf(tree, device)


def lm_params_from_jax(tree, *, device="cuda"):
    """A JAX LM weight tree (`repro.models.lm.init_params`) -> the port's,
    leaf for leaf in the same layout and dtype (stacked ``blocks`` (L, ...)
    and ``memory`` (groups, ...), ``embed``, ``final_norm``, ``lm_head``;
    no ``lm_head`` where the head is tied to the embedding, PaliGemma's,
    whose pad heads are leaves of ``wq`` and ``wo`` like the others; a MoE
    config's leading dense layers stacked as ``dense_blocks``, its blocks'
    ``moe`` and MLA's ``attn`` leaves, an RWKV block's ``tm`` and
    ``cm`` and a hybrid block's ``ssm``, as any others; an audio
    config's unused ``embed`` too). Raises
    on any other group."""
    unknown = set(tree) - set(_LM_GROUPS)
    if unknown or not {"embed", "blocks", "final_norm"} <= set(tree):
        raise ValueError(f"expected the groups {_LM_GROUPS} (lm_head, "
                         f"dense_blocks and memory optional), got "
                         f"{sorted(tree)}")
    return _tree(dict(tree), device)


def adamw_state_from_jax(state, *, device="cuda") -> AdamWState:
    """JAX `optimizers.AdamWState` of an LM (``mu`` and ``nu`` f32 trees in
    the parameters' layout, ``count`` () int32) -> the port's, leaf for
    leaf, so that both sides take their next step from the same numbers."""
    return AdamWState(mu=_tree(dict(state.mu), device),
                      nu=_tree(dict(state.nu), device),
                      count=_tensor(state.count, np.int32, device))


_CACHE_KEYS = ({"k", "v", "pos"}, {"ckv", "pos"},
               {"tm_shift", "wkv", "cm_shift", "pos"},
               {"k", "v", "conv", "ssm", "pos"}, {"k", "v", "ksum", "pos"})


def lm_cache_from_jax(cache, *, device="cuda"):
    """A JAX LM cache {"k", "v" (L, B, Smax, Hkv, D), "pos" () or (B,)}
    (with the sparse decode's "ksum" (L, B, nb, Hkv, D), or a hybrid
    block's "conv" (L, B, K-1, d_inner) and "ssm" (L, B, d_inner, N)
    f32), MLA's {"ckv" (L, B, Smax, kv_lora + rope), "pos"} or RWKV's
    {"tm_shift", "cm_shift" (L, B, d), "wkv" (L, B, H, D, D) f32, "pos"}
    -> the port's, the float leaves in their dtype (f32 or bf16), pos
    int32. With a window Smax = min(max_len, window) slots of a ring, as
    on both sides."""
    if set(cache) not in _CACHE_KEYS:
        raise ValueError(f"expected the cache keys k, v and pos (GQA; with "
                         f"ksum for the sparse decode, with conv and ssm in "
                         f"a hybrid block), ckv and pos (MLA) or tm_shift, "
                         f"wkv, cm_shift and pos (RWKV), got "
                         f"{sorted(cache)}")
    out = {k: _float_leaf(v, device) for k, v in cache.items() if k != "pos"}
    out["pos"] = _tensor(cache["pos"], np.int32, device)
    return out


def lm_memory_states_from_jax(states, *, device="cuda"):
    """A tuple of JAX `sam_layer.MemoryState` (f32 rows, scratch-row
    layout) -> the port's, field for field; the step () or (B, 1) int32.
    Raises on bf16 or int8 rows (A9c)."""
    from repro_torch.models.sam_layer import MemoryState
    out = []
    for st in states:
        memory = memory_from_jax(st.memory, device=device)
        if memory.dtype != torch.float32:
            raise ValueError(f"the LM memory layer runs f32 rows, got "
                             f"{memory.dtype} (ROADMAP A9c)")
        out.append(MemoryState(
            memory=memory,
            last_access=_tensor(st.last_access, np.int32, device),
            read_idx=_tensor(st.read_idx, np.int32, device),
            read_w=_tensor(st.read_w, np.float32, device),
            step=_tensor(st.step, np.int32, device)))
    return tuple(out)


def session_from_jax(sess, *, device="cuda"):
    """A JAX serving session (`repro.launch.engine`: {"cache": {"k", "v"}
    (L, 1, Smax, Hkv, D), with a hybrid block's {"conv", "ssm"} (L, 1,
    ...), MLA's {"ckv"} (L, 1, Smax, kv_lora + rope) or RWKV's
    {"tm_shift", "wkv", "cm_shift"} (L, 1, ...), "pos" (1,),
    "counter", "mem": a tuple of `MemoryState` with batch 1})
    -> the port's (`repro_torch.launch.engine.SessionStore`'s), leaf for
    leaf; "mem" absent for a memoryless model."""
    cache = lm_cache_from_jax({**sess["cache"], "pos": sess["pos"]},
                              device=device)
    out = {"cache": {k: v for k, v in cache.items() if k != "pos"},
           "pos": cache["pos"],
           "counter": int(np.asarray(sess["counter"]))}
    if sess.get("mem") is not None:
        out["mem"] = lm_memory_states_from_jax(sess["mem"], device=device)
    return out
