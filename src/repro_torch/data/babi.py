"""bAbI-lite: generated reasoning stories in the spirit of Weston et al.'s
tasks (the paper's Table 1), the port's own copy of the JAX package's
`data/babi.py` (numpy only): the same vocabulary, templates and draws from
a `numpy.random.Generator`, so the same generator gives the same batches
bit for bit.

Covers three task templates:
  1-supporting-fact  ("Mary went to the kitchen. Where is Mary?")
  2-supporting-facts ("Mary got the ball. Mary went to the garden. Where is
                       the ball?")
  yes/no             ("Is Mary in the kitchen?")

A story longer than ``length`` words is cut to its first ``length``, as
in the reference: a one-fact story of 5 facts is 34 words, so at the
bench's length of 32 its question loses "is <entity>" (ROADMAP §C)."""
from __future__ import annotations

import numpy as np

ENTITIES = ["mary", "john", "sandra", "daniel"]
LOCATIONS = ["kitchen", "garden", "office", "bathroom", "hallway"]
OBJECTS = ["ball", "apple", "book"]
VERBS = ["went", "moved", "travelled"]

BABI_VOCAB = (["<pad>", "<q>", "yes", "no", "."]
              + ENTITIES + LOCATIONS + OBJECTS + VERBS
              + ["got", "dropped", "where", "is", "the", "in", "to"])
_V = {w: i for i, w in enumerate(BABI_VOCAB)}


def _encode(words, length):
    ids = [_V[w] for w in words][:length]
    return ids + [0] * (length - len(ids))


def _story_one_fact(rng):
    n = rng.integers(2, 6)
    loc = {}
    words = []
    for _ in range(n):
        e = ENTITIES[rng.integers(len(ENTITIES))]
        l = LOCATIONS[rng.integers(len(LOCATIONS))]
        loc[e] = l
        words += [e, VERBS[rng.integers(len(VERBS))], "to", "the", l, "."]
    e = list(loc)[rng.integers(len(loc))]
    words += ["<q>", "where", "is", e]
    return words, loc[e]


def _story_two_facts(rng):
    e = ENTITIES[rng.integers(len(ENTITIES))]
    o = OBJECTS[rng.integers(len(OBJECTS))]
    words = [e, "got", "the", o, "."]
    l = LOCATIONS[rng.integers(len(LOCATIONS))]
    for _ in range(rng.integers(1, 4)):
        l = LOCATIONS[rng.integers(len(LOCATIONS))]
        words += [e, VERBS[rng.integers(len(VERBS))], "to", "the", l, "."]
    words += ["<q>", "where", "is", "the", o]
    return words, l


def _story_yesno(rng):
    e = ENTITIES[rng.integers(len(ENTITIES))]
    l = LOCATIONS[rng.integers(len(LOCATIONS))]
    words = [e, "went", "to", "the", l, "."]
    if rng.random() < 0.5:
        q_l, ans = l, "yes"
    else:
        q_l = LOCATIONS[rng.integers(len(LOCATIONS))]
        ans = "yes" if q_l == l else "no"
    words += ["<q>", "is", e, "in", "the", q_l]
    return words, ans


_TEMPLATES = [_story_one_fact, _story_two_facts, _story_yesno]


def babi_lite_batch(rng: np.random.Generator, batch: int, length: int = 48):
    """Returns (tokens (B,L) int32, answer (B,) int32, task_id (B,))."""
    toks = np.zeros((batch, length), np.int32)
    ans = np.zeros((batch,), np.int32)
    task = np.zeros((batch,), np.int32)
    for i in range(batch):
        t = rng.integers(len(_TEMPLATES))
        words, a = _TEMPLATES[t](rng)
        toks[i] = _encode(words, length)
        ans[i] = _V[a]
        task[i] = t
    return toks, ans, task
