"""Checkpoints in the JAX package's on-disk format (`repro/checkpoint/
ckpt.py`), so that state moves between the two packages: a checkpoint
written by either restores in the other bit for bit.

* ``save_checkpoint`` writes ``<dir>/tmp_<step>`` and renames it to
  ``<dir>/step_<step>`` (atomic commit): one ``leaf_<i>.npy`` a leaf and a
  ``manifest.json`` of format 4 naming each leaf's path, file, dtype and
  shape, plus ``mem_layout`` {num_slots, shards} when given.
* Paths are those of ``jax.tree_util.tree_flatten_with_path``: dict keys
  in sorted order, tuple and list indices as digits, NamedTuple fields as
  ``.name``, None an empty subtree, joined by "/" (`flatten_with_paths`).
* bf16 leaves are written as JAX writes them through ``ml_dtypes``: an
  ``.npy`` of descr ``'<V2'`` holding the 16-bit patterns, with manifest
  dtype ``"bfloat16"``; they are read back by that dtype (``numpy`` has no
  bf16) as ``uint16`` and viewed as ``torch.bfloat16``.
* ``restore_checkpoint`` restores into the structure of a template and
  returns torch tensors, each on its template leaf's device (the CPU for a
  leaf that is not a tensor). Its shims are the JAX package's, as the
  port's own numpy copies: the format-1 pad of memory and usage by one
  scratch row (`_migrate_scratch_row`), the float↔int8 migration of a
  ``memory`` leaf with its ``mem_scale`` sibling (`_np_quantize_rows`,
  `_np_dequantize_rows`; the scale is ``max|row| · fl(1/127)``, as
  `core/quant.py` and the compiled JAX quantizer form it), the f32↔bf16
  change of a ``memory`` leaf, the pre-format-3 LSH index
  (`_migrate_ann_axis`), ``fill_missing`` and ``expect_num_slots``. A
  memory or usage leaf saved slot-sharded (``mem_layout`` with shards > 1)
  restores into the canonical (B, N+1, ...) layout through
  `mem_shard.from_shard_layout`. A re-partition of the LSH index (P > 1)
  or a sharded target raise, naming ROADMAP A11.

* ``AsyncCheckpointer`` saves on a writer thread, as the JAX package's
  does (driven by `distributed/fault_tolerance.py::ResilientLoop`): `save`
  copies the tree to the host on the calling thread and queues it (at most
  two saves wait), the writer commits it and keeps the newest ``keep``.
  Stricter than JAX's on purpose (ROADMAP §C): `wait` returns only once
  every queued save is committed, and raises the first error the writer
  met.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.types import ANN_LEAVES, LA_SCRATCH, SLOT_LEAVES
from repro_torch.distributed.mem_shard import from_shard_layout

# 1 (no field): before the scratch row; 2: the scratch row; 3: the
# ownership-partitioned LSH index; 4: int8 memory with a `mem_scale` leaf.
MANIFEST_FORMAT = 4
BF16 = "bfloat16"
_FLOATS = frozenset({"float16", BF16, "float32", "float64"})
A11 = "ROADMAP A11"


# --------------------------------------------------------------------------
# Trees: JAX's flatten order and path strings
# --------------------------------------------------------------------------

def _children(node):
    """(key, path component, child) of a container in JAX's order; None
    for a leaf."""
    if node is None:
        return ()
    if isinstance(node, dict):
        return tuple((k, str(k), node[k]) for k in sorted(node))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return tuple((f, "." + f, getattr(node, f)) for f in node._fields)
    if isinstance(node, (tuple, list)):
        return tuple((i, str(i), c) for i, c in enumerate(node))
    return None


def flatten_with_paths(tree, prefix: str = ""):
    """[(path, leaf)] in JAX's flatten order, with its path strings."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for _, name, child in kids:
        out += flatten_with_paths(child, f"{prefix}/{name}" if prefix
                                  else name)
    return out


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in flatten order."""
    kids = _children(template)
    if kids is None:
        return next(leaves)
    if template is None:
        return None
    built = {key: _unflatten(child, leaves) for key, _, child in kids}
    if isinstance(template, dict):
        return {k: built[k] for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*built.values())
    return type(template)(built.values())


def map_with_path(fn, tree):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    return _unflatten(tree, iter([fn(p, leaf) for p, leaf in
                                  flatten_with_paths(tree)]))


# --------------------------------------------------------------------------
# Leaves: host arrays, with bf16 held as its uint16 bit pattern
# --------------------------------------------------------------------------

def _host_array(leaf):
    """(numpy array, dtype name) of a leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    if a.dtype.name == BF16:          # ml_dtypes' bfloat16 (a JAX host tree)
        return a.view(np.uint16), BF16
    return a, str(a.dtype)


def _dtype_name(leaf) -> str:
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return np.asarray(leaf).dtype.name
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _write(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype == BF16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(arr.tobytes(order="C"))
    else:
        np.save(path, arr)


def _read(path: str, entry: dict) -> np.ndarray:
    arr = np.load(os.path.join(path, entry["file"]))
    return arr.view(np.uint16) if entry["dtype"] == BF16 else arr


def _as_f32(arr: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == BF16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float32)


def _to_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    """A float array (f32 where the target is bf16) in float ``dtype``;
    bf16 rounds to nearest even, as ``ml_dtypes`` does."""
    if dtype == BF16:
        t = torch.from_numpy(np.array(x, np.float32, order="C"))
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(
            np.uint16)
    return x.astype(dtype)


def _tensor(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == BF16:
        t = torch.from_numpy(np.array(arr.view(np.int16), order="C"))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


# --------------------------------------------------------------------------
# Save
# --------------------------------------------------------------------------

def save_checkpoint(directory: str, step: int, tree,
                    mem_layout: tuple = None) -> str:
    """Blocking atomic save of ``tree`` (torch tensors, numpy arrays or
    Python scalars); returns the committed path. ``mem_layout=(num_slots,
    shards[, data])`` records the layout of the memory and usage leaves."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "format": MANIFEST_FORMAT, "leaves": []}
    if mem_layout is not None:
        manifest["mem_layout"] = {"num_slots": int(mem_layout[0]),
                                  "shards": int(mem_layout[1])}
        if len(mem_layout) > 2:
            manifest["mem_layout"]["data"] = int(mem_layout[2])
    for i, (p, leaf) in enumerate(flatten_with_paths(tree)):
        arr, dtype = _host_array(leaf)
        _write(os.path.join(tmp, f"leaf_{i}.npy"), arr, dtype)
        manifest["leaves"].append({"path": p, "file": f"leaf_{i}.npy",
                                   "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                 # atomic commit
    return final


def latest_step(directory: str):
    """The newest committed step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and os.path.exists(
                 os.path.join(directory, name, "manifest.json"))]
    return max(steps) if steps else None


# --------------------------------------------------------------------------
# The shims (numpy copies of the JAX package's)
# --------------------------------------------------------------------------

def _migrate_scratch_row(arr: np.ndarray, want_shape) -> np.ndarray:
    """Format-1 shim: pad a (B, N, ...) leaf to the (B, N+1, ...) scratch-row
    layout with the scratch row's init (0, or `LA_SCRATCH` for an integer
    usage table); raises on any other mismatch."""
    want = tuple(want_shape)
    if arr.shape == want:
        return arr
    legacy = (arr.ndim >= 2 and len(want) == arr.ndim
              and want[0] == arr.shape[0] and want[1] == arr.shape[1] + 1
              and want[2:] == arr.shape[2:])
    if not legacy:
        raise ValueError(
            f"checkpoint leaf shape {arr.shape} does not match template "
            f"{want} and is not a legacy (one fewer row on axis 1) layout")
    pad = [(0, 0)] * arr.ndim
    pad[1] = (0, 1)
    fill = LA_SCRATCH if np.issubdtype(arr.dtype, np.integer) else 0
    return np.pad(arr, pad, constant_values=fill)


def _np_quantize_rows(arr: np.ndarray):
    """`core.quant.quantize_rows` in numpy: per-row symmetric int8 along
    the last axis, scale = max|row| · fl(1/127), no epsilon (a zero row
    has scale 0.0); ``np.rint`` rounds half to even."""
    xf = np.asarray(arr, np.float32)
    scale = (np.max(np.abs(xf), axis=-1)
             * np.float32(1.0 / 127.0)).astype(np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0))
    q = np.clip(np.rint(xf / safe[..., None]), -127, 127).astype(np.int8)
    return q, scale


def _np_dequantize_rows(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale.astype(np.float32)[..., None]


def _leaf_name(path: str) -> str:
    return path.rsplit("/", 1)[-1].lstrip(".")


def _sibling(path: str, name: str) -> str:
    """The path of leaf ``name`` in the container of ``path``, rendered as
    that container renders its keys (".memory" or "memory")."""
    prefix, _, last = path.rpartition("/")
    dot = "." if last.startswith(".") else ""
    return (prefix + "/" if prefix else "") + dot + name


def _migrate_ann_axis(arr: np.ndarray, name: str) -> np.ndarray:
    """Pre-format-3 shim: insert the P = 1 ownership axis of the LSH index
    (buckets (B, T, nb, size) → (B, T, nb, 1, size), cursor (B, T, nb) →
    (B, T, nb, 1))."""
    if name == "buckets" and arr.ndim == 4:
        return arr[:, :, :, None, :]
    if name == "cursor" and arr.ndim == 3:
        return arr[..., None]
    return arr


def _to_canonical(arr: np.ndarray, want_shape, layout: dict,
                  path: str) -> np.ndarray:
    """A memory or usage leaf of the recorded ``layout`` (num_slots,
    shards) in the template's layout, which must be the canonical one
    (rows = num_slots + 1): `mem_shard.from_shard_layout`."""
    want = tuple(want_shape)
    n, s_from = int(layout["num_slots"]), int(layout["shards"])
    s_to = want[1] - n if len(want) >= 2 else 0
    ok = (arr.ndim == len(want) and arr.ndim >= 2
          and want[0] == arr.shape[0] and want[2:] == arr.shape[2:]
          and arr.shape[1] == n + s_from and s_from >= 1 and n % s_from == 0
          and s_to >= 1 and n % s_to == 0)
    if not ok:
        raise ValueError(
            f"checkpoint leaf {path!r} has shape {arr.shape} under recorded "
            f"mem_layout (num_slots={n}, shards={s_from}); template shape "
            f"{want} is not a valid re-layout target (rows must be "
            f"num_slots + shards for some shard count dividing num_slots)")
    if s_to != 1:
        raise ValueError(
            f"checkpoint leaf {path!r}: a template of {s_to} shards; the port "
            f"restores into the canonical layout only (the sharded layouts "
            f"are {A11})")
    bits = arr.view(np.int16) if arr.dtype == np.uint16 else arr
    out = from_shard_layout(torch.from_numpy(np.array(bits, order="C")), n,
                            s_from).numpy()
    return out.view(np.uint16) if arr.dtype == np.uint16 else out


# --------------------------------------------------------------------------
# Restore
# --------------------------------------------------------------------------

def restore_checkpoint(directory: str, template, step: int = None,
                       fill_missing: bool = False,
                       expect_num_slots: int = None):
    """Restore the newest (or ``step``'s) checkpoint under ``directory``
    into the structure of ``template`` (leaves: tensors, arrays, anything
    with a shape and a dtype, or Python scalars). Returns (tree, step), or
    (None, None) when nothing is committed there.

    ``fill_missing=True`` matches leaves by path and keeps the template's
    value where the checkpoint has none; a checkpoint leaf with no
    template counterpart still raises. ``expect_num_slots`` pins the slot
    count: a recorded ``mem_layout`` that disagrees raises instead of being
    read as a layout change. Without ``fill_missing`` the checkpoint's
    paths must equal the template's, in order, but for a ``mem_scale``
    leaf that a float↔int8 migration of its ``memory`` sibling adds or
    consumes."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = flatten_with_paths(template)
    t_paths = [p for p, _ in flat]
    t_leaves = [leaf for _, leaf in flat]
    t_by_path = dict(flat)
    ck_by_path = {e["path"]: e for e in manifest["leaves"]}

    def consumed_scale(p):
        """A checkpoint `mem_scale` that dequantizes its int8 sibling into
        a float template leaf."""
        mp = _sibling(p, "memory")
        me = ck_by_path.get(mp)
        return (_leaf_name(p) == "mem_scale" and me is not None
                and me["dtype"] == "int8" and mp in t_by_path)

    extra_t = [p for p in t_paths if p not in ck_by_path]
    extra_c = [p for p in ck_by_path if p not in t_by_path]
    if fill_missing:
        unknown = sorted(p for p in extra_c if not consumed_scale(p))
        if unknown:
            raise ValueError(
                f"checkpoint leaves {unknown} have no counterpart in the "
                f"template — not a pure leaf-subset checkpoint")
    elif (not all(_leaf_name(p) == "mem_scale" for p in extra_t + extra_c)
          or [e["path"] for e in manifest["leaves"]
              if e["path"] in t_by_path]
          != [p for p in t_paths if p in ck_by_path]):
        raise ValueError(
            f"checkpoint/template structure mismatch: template only "
            f"{extra_t}, checkpoint only {extra_c}")
    entries = [ck_by_path.get(p) for p in t_paths]

    fmt = manifest.get("format", 1)
    layout = manifest.get("mem_layout")
    if (expect_num_slots is not None and layout is not None
            and int(layout["num_slots"]) != int(expect_num_slots)):
        raise ValueError(
            f"checkpoint was saved with num_slots={layout['num_slots']}, "
            f"caller expects {expect_num_slots} — a slot-count config "
            f"change cannot be restored as a mesh re-layout")
    leaves = []
    scales = {}           # template mem_scale path -> quantization scales
    scale_slots = {}      # template mem_scale path -> slot in `leaves`
    for entry, t_path, tmpl in zip(entries, t_paths, t_leaves):
        if entry is None:
            mt = t_by_path.get(_sibling(t_path, "memory"))
            me = ck_by_path.get(_sibling(t_path, "memory"))
            if (_leaf_name(t_path) == "mem_scale" and me is not None
                    and mt is not None and _dtype_name(mt) == "int8"
                    and me["dtype"] in _FLOATS):
                scale_slots[t_path] = len(leaves)
                leaves.append(None)          # the scales of its sibling
                continue
            if not fill_missing:
                raise ValueError(
                    f"template leaf {t_path!r} is absent from the "
                    f"checkpoint and is not a mem-dtype migration target")
            leaves.append(tmpl.clone() if isinstance(tmpl, torch.Tensor)
                          else torch.as_tensor(np.asarray(tmpl)))
            continue
        arr, dtype = _read(path, entry), entry["dtype"]
        name = _leaf_name(entry["path"])
        want = getattr(tmpl, "shape", None)
        if want is not None and arr.shape != tuple(want):
            if name in ANN_LEAVES:
                if fmt < 3:
                    arr = _migrate_ann_axis(arr, name)
                if arr.shape != tuple(want):
                    raise ValueError(
                        f"checkpoint leaf {entry['path']!r} has shape "
                        f"{arr.shape}, template {tuple(want)}: "
                        f"re-partitioning the LSH index (P > 1) is {A11}")
            elif name in SLOT_LEAVES and layout is not None:
                arr = _to_canonical(arr, want, layout, entry["path"])
            elif (name in SLOT_LEAVES and expect_num_slots is not None
                  and arr.ndim >= 2
                  and arr.shape[1] == int(expect_num_slots) + 1):
                arr = _to_canonical(arr, want, {"num_slots": expect_num_slots,
                                                "shards": 1}, entry["path"])
            elif fmt < 2 and name in SLOT_LEAVES:
                arr = _migrate_scratch_row(arr, want)
            else:
                raise ValueError(
                    f"checkpoint leaf {entry['path']!r} has shape "
                    f"{arr.shape}, template expects {tuple(want)} — "
                    f"scratch-row migration applies only to pre-format-2 "
                    f"checkpoints, re-layout only to checkpoints with a "
                    f"recorded mem_layout (or a declared expect_num_slots),"
                    f" and only to {sorted(SLOT_LEAVES | ANN_LEAVES)} leaves")
        # The memory leaf's storage dtype, after the shape shims.
        tdt = _dtype_name(tmpl)
        if name == "memory" and dtype != tdt:
            if tdt == "int8" and dtype in _FLOATS:
                arr, scale = _np_quantize_rows(_as_f32(arr, dtype))
                scales[_sibling(t_path, "mem_scale")] = scale
            elif dtype == "int8" and tdt in _FLOATS:
                sp = _sibling(entry["path"], "mem_scale")
                se = ck_by_path.get(sp)
                if se is None:
                    raise ValueError(
                        f"checkpoint leaf {entry['path']!r} is int8 but "
                        f"carries no sibling {sp!r} scale leaf — cannot "
                        f"dequantize into a float template")
                scale = _read(path, se)
                if scale.shape != arr.shape[:-1]:
                    if layout is None:
                        raise ValueError(
                            f"checkpoint scale leaf {sp!r} shape "
                            f"{scale.shape} does not match its memory leaf "
                            f"{arr.shape} and no mem_layout is recorded")
                    scale = _to_canonical(scale, arr.shape[:-1], layout, sp)
                arr = _to_dtype(_np_dequantize_rows(arr, scale), tdt)
            elif dtype in _FLOATS and tdt in _FLOATS:
                # f32 <-> bf16 (any float change through bf16 via f32).
                arr = _to_dtype(_as_f32(arr, dtype) if BF16 in (dtype, tdt)
                                else arr, tdt)
            else:
                tdt = dtype
            dtype = tdt
        leaves.append(_tensor(arr, dtype, tmpl))
    for sp, slot in scale_slots.items():
        if sp not in scales:
            raise ValueError(
                f"template leaf {sp!r} expected a quantization scale from "
                f"its sibling memory leaf, but none was produced")
        leaves[slot] = _tensor(scales.pop(sp), "float32",
                               t_by_path[sp])
    return _unflatten(template, iter(leaves)), step


# --------------------------------------------------------------------------
# The asynchronous writer
# --------------------------------------------------------------------------

def _host_copy(leaf):
    """A host copy of a leaf that later in-place updates cannot reach: a
    tensor copied to the CPU (complete when this returns), an array
    copied."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Checkpoints written by a background thread, so the step loop blocks
    only for the copy to the host. ``save(step, tree)`` copies every leaf
    to the host on the calling thread (the next step may update the
    parameters in place) and queues the copy; the writer runs
    `save_checkpoint` (``mem_layout`` as given) and then deletes all but
    the newest ``keep`` committed steps. A full queue (two saves) blocks
    `save`. ``wait()`` blocks until every queued save is committed and
    raises the first error the writer met (JAX's returns once the queue
    is empty, while its writer may still be writing, and only collects
    errors in ``errors``). ``close()`` stops the writer once every queued
    save is committed (JAX's gives it 10 s); its errors stay in
    ``errors``."""

    def __init__(self, directory: str, keep: int = 3, mem_layout: tuple = None):
        self.directory = directory
        self.keep = keep
        self.mem_layout = mem_layout
        self.errors: list = []
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def save(self, step: int, tree) -> None:
        host = map_with_path(lambda _, leaf: _host_copy(leaf), tree)
        self._q.put((step, host))

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree = item
                save_checkpoint(self.directory, step, tree,
                                mem_layout=self.mem_layout)
                self._gc()
            except Exception as e:  # noqa: BLE001 -- raised again by wait()
                self.errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.directory)
                       if n.startswith("step_") and n[5:].isdigit())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def wait(self) -> None:
        self._q.join()
        if self.errors:
            raise self.errors[0]

    def close(self) -> None:
        self._q.put(None)
        self._worker.join()
