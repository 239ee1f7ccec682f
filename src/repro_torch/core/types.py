"""Config and state types of the SAM cell, in the JAX package's layout.

Scratch-row layout: memory is a persistent (B, N+1, W) buffer whose row N
is write scratch, and `last_access` is (B, N+1) int32 with the scratch
entry pinned to ``LA_SCRATCH``. Rows [0, N) are the logical memory; no
sweep reads row N and no write touches it. Keeping the layout identical to
the JAX package lets a JAX state convert field for field
(`repro_torch.convert`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

# Number of write-scratch rows appended past the logical memory (row N).
SCRATCH_ROWS = 1
# `last_access` value pinned on the scratch row: int32 max, so LRA
# selection can never pick it.
LA_SCRATCH = 2 ** 31 - 1
# Field names of the state leaves indexed by slot: the leaves that a
# slot-sharded memory splits into blocks (`distributed/mem_shard.py`,
# `convert.sharded_state_from_jax`); every other leaf is replicated.
# ``usage`` is the dense models' and the DNC's table.
SLOT_LEAVES = frozenset({"memory", "last_access", "usage", "mem_scale"})
# Field names of the LSH index's leaves (`ANNState`).
ANN_LEAVES = frozenset({"buckets", "cursor"})


# Storage dtypes of the memory rows (`MemoryConfig.mem_dtype`).
MEM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


def init_scratch_memory(batch: int, num_slots: int, word_size: int, *,
                        dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Zero (B, N+1, W) memory in the scratch-row layout; ``dtype`` is the
    rows' storage dtype (f32, bf16 or int8)."""
    return torch.zeros((batch, num_slots + SCRATCH_ROWS, word_size),
                       dtype=dtype, device=device)


def init_scratch_mem_scale(batch: int, num_slots: int, *,
                           device="cuda") -> torch.Tensor:
    """(B, N+1) f32 per-row scales of int8 rows, all 0.0: a zero row's
    scale, so a cold row dequantizes to exactly 0.0. The scratch entry is
    0.0 too."""
    return torch.zeros((batch, num_slots + SCRATCH_ROWS),
                       dtype=torch.float32, device=device)


def init_scratch_last_access(batch: int, num_slots: int, *, first: int = 0,
                             device="cuda") -> torch.Tensor:
    """(B, N+1) int32 usage table: the logical rows staggered with
    ``-arange(N)`` so the first LRA picks are N-1, N-2, ..., and the
    scratch entry pinned to `LA_SCRATCH`. With ``first`` the N rows are the
    global rows first .. first+N-1 of a larger memory (a rank's block of a
    slot-sharded one) and hold -first .. -(first+N-1)."""
    la = torch.empty((batch, num_slots + SCRATCH_ROWS), dtype=torch.int32,
                     device=device)
    la[:, :num_slots] = -torch.arange(first, first + num_slots,
                                      dtype=torch.int32, device=device)
    la[:, num_slots:] = LA_SCRATCH
    return la


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Configuration of the external memory (paper §3) on one device, read
    exactly (``ann="exact"``) or through the LSH index (``ann="lsh"``,
    `core/ann.py`). ``mem_dtype`` is the rows' storage dtype: 'float32',
    'bfloat16' (reads upcast, writes round once per column) or 'int8'
    (per-row symmetric quantization with an f32 scale per row,
    `SAMState.mem_scale`; reads dequantize, writes re-quantize each
    touched row once). All three train: a bf16 memory's gradient is bf16,
    an int8 memory's codes get none and its scales do."""

    num_slots: int = 1024          # N
    word_size: int = 32            # W
    num_heads: int = 4             # access heads (paper Suppl. C: 4)
    k: int = 4                     # K non-zero reads per head
    delta: float = 0.005           # usage threshold δ (paper §3.2)
    ann: str = "exact"             # 'exact' (linear sweep) or 'lsh'
    lsh_tables: int = 4
    lsh_bits: int = 8              # buckets per table = 2**bits
    lsh_bucket_size: int = 32
    mem_dtype: str = "float32"
    usage_discount: float = 0.99   # dense models (DAM): usage discount λ

    def __post_init__(self):
        if self.mem_dtype not in MEM_DTYPES:
            raise ValueError(f"mem_dtype={self.mem_dtype!r}: expected one of "
                             f"{sorted(MEM_DTYPES)}")

    @property
    def candidates(self) -> int:
        """Bucket candidates per head: tables × bucket size."""
        return self.lsh_tables * self.lsh_bucket_size


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    input_size: int = 8
    hidden_size: int = 100         # paper Suppl. C: 100 hidden units
    output_size: int = 8


class LSTMState(NamedTuple):
    h: torch.Tensor  # (B, hidden)
    c: torch.Tensor  # (B, hidden)


class SparseRead(NamedTuple):
    """Result of a sparse content-based read."""

    indices: torch.Tensor   # (B, H, K) int32
    weights: torch.Tensor   # (B, H, K) f32
    words: torch.Tensor     # (B, H, W) f32 — the read vectors r_t


class ANNState(NamedTuple):
    """The LSH index in the JAX layout, partitioned by slot ownership into
    P sub-rings of depth d = bucket_size / P. The port keeps P = 1 (one
    full-depth ring per bucket); the sharded index is not ported.

    buckets: (B, T, 2**bits, P, d) int32 slot indices, -1 = empty;
    cursor:  (B, T, 2**bits, P) int32 ring-insert position per sub-ring.
    """

    buckets: torch.Tensor
    cursor: torch.Tensor


class SAMState(NamedTuple):
    """SAM recurrent state in the scratch-row layout (module docstring).
    ``ann`` is the LSH index (`ANNState`) of an ``ann="lsh"`` cell and None
    for the exact read; ``mem_scale`` is the (B, N+1) f32 per-row scale of
    int8 rows (``mem_dtype="int8"``) and None for f32 and bf16 rows. Both
    keep the JAX field set."""

    memory: torch.Tensor        # (B, N+1, W) f32/bf16/int8 — row N = scratch
    last_access: torch.Tensor   # (B, N+1) int32; [N] = LA_SCRATCH
    read: SparseRead            # previous step's read
    ctrl: LSTMState
    step: torch.Tensor          # () int32
    ann: Optional[ANNState] = None
    mem_scale: Optional[torch.Tensor] = None


class DenseState(NamedTuple):
    """State of the dense models (DAM, NTM, `core/dense.py`). A dense
    softmax weighting addresses every row, so there is no never-read row
    to park a write on: the memory is the plain (B, N, W), with no
    scratch row, as in the JAX package."""

    memory: torch.Tensor        # (B, N, W) f32
    usage: torch.Tensor         # (B, N) f32 discounted usage (DAM; the NTM
    #                             carries it unchanged)
    read_w: torch.Tensor        # (B, H, N) previous read weights
    read_words: torch.Tensor    # (B, H, W)
    write_w: torch.Tensor       # (B, H, N) previous write weights
    ctrl: LSTMState
    step: torch.Tensor          # () int32


class StepDeltas(NamedTuple):
    """What one SAM step records for the backward pass (paper §3.4): the
    touched rows and their pre-write contents, so the rollback restores
    the memory bit for bit, and the read's selection, so the replay needs
    neither the usage table nor a sweep. O(K·W) per step, independent of
    N."""

    write_idx: torch.Tensor   # (B, J) int32 rows touched by the write
    old_rows: torch.Tensor    # (B, J, W) their raw contents (the storage
    #                           dtype's bits) before the write
    read_idx: torch.Tensor    # (B, H, K) int32 rows selected by the read,
    #                           signed: -1 = no valid selection
    old_scale: Optional[torch.Tensor] = None   # (B, J) their f32 scales
    #                           before the write, int8 rows only (None else)


def mark_rolled_back(memory: torch.Tensor) -> None:
    """Flag a memory buffer that a sparse or chunked backward has rolled
    back to the unroll's initial memory. The usage table beside it still
    holds the final step's stamps, so no state that holds the buffer is
    consistent any more: `require_live` refuses to step from it until
    `unroll.roll_forward` brings the final state back."""
    memory.rolled_back = True


def mark_rolled_forward(memory: torch.Tensor) -> None:
    """Clear `mark_rolled_back`'s flag: the buffers hold the final state
    of the unrolls again (`unroll.roll_forward`)."""
    memory.rolled_back = False


def require_live(state) -> None:
    """Raise if ``state.memory`` was rolled back by a backward
    (`mark_rolled_back`)."""
    if getattr(state.memory, "rolled_back", False):
        raise RuntimeError(
            "this state's memory was rolled back to the unroll's initial "
            "memory by a sparse or chunked backward, while its usage table "
            "was not: call repro_torch.core.unroll.roll_forward(state) to "
            "bring the final state back and keep stepping, start again from "
            "a fresh state (init_state), or unroll in naive mode")


def tree_bytes(tree) -> int:
    """Bytes of the tensors among the leaves of a nested tuple/dict."""
    leaves, _ = pytree.tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def glorot(generator: torch.Generator, shape, *, device="cuda") -> torch.Tensor:
    """Normal draw scaled by sqrt(2 / (fan_in + fan_out)). Drawn on the
    generator's device (the CPU for a default generator) and then moved,
    so a seed gives the same weights on every device."""
    fan_in, fan_out = shape[-2], shape[-1]
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w * math.sqrt(2.0 / (fan_in + fan_out))).to(device)
