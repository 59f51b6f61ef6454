"""Training statistics: per-metric [count, sum, sum of squares] accumulated
by ``report`` and snapshot by a ``Collector`` into mean / std, written per
tick by ``JsonlWriter``.

Counterpart of ``diff_sampler_tpu/utils/stats.py`` for one process.
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np

__all__ = ["report", "Collector", "default_collector", "JsonlWriter"]

_counters: Dict[str, np.ndarray] = {}


def report(name: str, value) -> None:
    """Accumulate a scalar or array into the named counter."""
    v = np.asarray(value, np.float64).ravel()
    if v.size == 0:
        return
    moments = np.array([v.size, v.sum(), np.square(v).sum()], np.float64)
    _counters[name] = _counters.get(name, np.zeros(3)) + moments


class Collector:
    """Takes the accumulated counters (``update``) and gives their num /
    mean / std until ``reset``."""

    def __init__(self):
        self._stats: Dict[str, np.ndarray] = {}

    def update(self) -> None:
        global _counters
        pending, _counters = _counters, {}
        for name, m in pending.items():
            self._stats[name] = self._stats.get(name, np.zeros(3)) + m

    def names(self):
        return sorted(self._stats)

    def num(self, name) -> int:
        return int(self._stats.get(name, np.zeros(3))[0])

    def mean(self, name) -> float:
        m = self._stats.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name) -> float:
        m = self._stats.get(name)
        if m is None or m[0] < 2:
            return 0.0
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean ** 2, 0.0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {n: {"num": self.num(n), "mean": self.mean(n), "std": self.std(n)}
                for n in self.names()}

    def reset(self) -> None:
        self._stats = {}


default_collector = Collector()


class JsonlWriter:
    """One JSON line per tick: the collector's stats, the given extra fields
    and a timestamp; flushed at each write."""

    def __init__(self, path: str):
        self.file = open(path, "at")

    def write(self, collector: Collector, **extra) -> None:
        record = dict(collector.as_dict())
        record.update(extra)
        record["timestamp"] = time.time()
        self.file.write(json.dumps(record) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()
