"""The one traffic generator: the calls of a traffic mix, from the seed.

One caller calls and waits for each answer, as a library's user does. A mix
is a JSON file under ``portbench/traffic/``:

- ``call``: ``"fit"`` (each call fits a model on an input of the pool, with
  a key of its own for its randomized steps) or ``"predict"`` (set-up fits
  one model; each call predicts at a batch of the pool);
- ``pool``: how many inputs (fit) or query batches (predict) set-up makes;
  the calls take them in a cycle whose order the seed shuffles;
- ``queries_per_call``: the rows of a predict batch;
- ``warmup_calls``: calls made in set-up, each answer dropped before the
  next.
"""
from __future__ import annotations

import random

__all__ = ["Schedule", "check_traffic"]

_CALLS = ("fit", "predict")


def check_traffic(traffic: dict) -> None:
    """Raise on a mix this generator cannot drive."""
    if traffic.get("call") not in _CALLS:
        raise ValueError(f"traffic call must be one of {_CALLS}")
    if int(traffic.get("pool", 0)) < 1:
        raise ValueError("traffic pool must be at least 1")
    if traffic["call"] == "predict" and int(
            traffic.get("queries_per_call", 0)) < 1:
        raise ValueError("a predict mix needs queries_per_call")
    if int(traffic.get("warmup_calls", 0)) < 1:
        raise ValueError("traffic warmup_calls must be at least 1")


class Schedule:
    """The calls of one run: which pool entry each takes, and its key.

    Every seed cycles through the same pool in an order of its own; the
    keys come from the seed as well, so a seed gives the same calls."""

    def __init__(self, traffic: dict, seed: int):
        check_traffic(traffic)
        rng = random.Random(seed)
        self.order = list(range(int(traffic["pool"])))
        rng.shuffle(self.order)
        self.setup_key = rng.getrandbits(62)
        self._keys = random.Random(rng.getrandbits(64))
        self._i = 0

    def next(self) -> tuple:
        """(pool index, key) of the next call."""
        idx = self.order[self._i % len(self.order)]
        self._i += 1
        return idx, self._keys.getrandbits(62)
