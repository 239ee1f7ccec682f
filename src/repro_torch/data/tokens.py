"""LM token pipeline: deterministic synthetic corpus stream with shift-by-one
targets and a restartable iterator state (so checkpoint/restart resumes
mid-epoch at the exact batch index). The port's own copy of the JAX
package's `data/tokens.py` (numpy only), so both draw the same batches."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    seed: int = 0


def lm_token_batches(vocab_size: int, batch: int, seq_len: int,
                     state: PipelineState = None):
    """Infinite deterministic batch generator. Yields (batch_dict, state).

    Synthetic corpus = Zipf-distributed tokens with short-range structure
    (markov-ish repeats) so the loss actually decreases during examples."""
    state = state or PipelineState()
    while True:
        rng = np.random.default_rng(state.seed * 1_000_003 + state.step)
        zipf = rng.zipf(1.3, size=(batch, seq_len + 1))
        toks = (zipf % (vocab_size - 1)).astype(np.int32) + 1
        # inject local repetition structure (learnable signal)
        rep = rng.integers(0, seq_len // 2, size=(batch,))
        for b in range(batch):
            r = rep[b]
            if r > 4:
                toks[b, r:2 * r] = toks[b, :r]
        yield ({"tokens": toks[:, :-1], "targets": toks[:, 1:]},
               PipelineState(step=state.step + 1, seed=state.seed))
        state = PipelineState(step=state.step + 1, seed=state.seed)
