"""Exponential curriculum (paper §4.3): the max difficulty level h doubles
when the average training loss drops below a threshold; each minibatch
samples its level from U(1, h). The port's own copy of
`repro/data/curriculum.py`: the port imports nothing of the JAX package."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Curriculum:
    start_level: int = 2
    max_level: int = 1 << 20
    threshold: float = 0.05         # avg bits-error / loss threshold
    patience: int = 20              # episodes under threshold before doubling
    level: int = 2
    _streak: int = 0
    history: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.level = self.start_level

    def sample_level(self, rng: np.random.Generator) -> int:
        return int(rng.integers(1, self.level + 1))

    def update(self, loss: float) -> bool:
        """Report an episode loss; returns True if the level just doubled."""
        self.history.append((self.level, float(loss)))
        if loss < self.threshold:
            self._streak += 1
        else:
            self._streak = 0
        if self._streak >= self.patience and self.level < self.max_level:
            self.level *= 2
            self._streak = 0
            return True
        return False
