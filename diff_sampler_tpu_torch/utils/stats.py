"""Training statistics: per-metric [count, sum, sum of squares] accumulated
by ``report`` and snapshot by a ``Collector`` into mean / std, written per
tick by ``JsonlWriter``.

Counterpart of ``diff_sampler_tpu/utils/stats.py``.  In a multi-process
run ``Collector.update`` merges every process's counters (every process
calls it at the same point), ``report0`` counts on process 0 only and only
process 0 writes ``stats.jsonl``.
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np

from ..parallel.mesh import process_count, process_index

__all__ = ["report", "report0", "Collector", "default_collector", "JsonlWriter"]

_counters: Dict[str, np.ndarray] = {}


def report(name: str, value) -> None:
    """Accumulate a scalar or array into the named counter."""
    v = np.asarray(value, np.float64).ravel()
    if v.size == 0:
        return
    moments = np.array([v.size, v.sum(), np.square(v).sum()], np.float64)
    _counters[name] = _counters.get(name, np.zeros(3)) + moments


def report0(name: str, value) -> None:
    """``report`` on process 0 only."""
    if process_index() == 0:
        report(name, value)


class Collector:
    """Takes the accumulated counters (``update``) and gives their num /
    mean / std until ``reset``."""

    def __init__(self):
        self._stats: Dict[str, np.ndarray] = {}

    def update(self) -> None:
        global _counters
        pending, _counters = _counters, {}
        if process_count() > 1:
            pending = _allgather_counters(pending)
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


def _allgather_counters(pending: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every process's counters, merged: the name sets may differ between
    processes (``report0``), so each process's dict travels whole (pickled by
    ``all_gather_object``) and the union is summed, in rank order."""
    import torch.distributed as dist

    gathered = [None] * process_count()
    dist.all_gather_object(gathered, {n: m.tolist() for n, m in pending.items()})
    merged: Dict[str, np.ndarray] = {}
    for d in gathered:
        for name, m in d.items():
            merged[name] = merged.get(name, np.zeros(3)) + np.asarray(m)
    return merged


default_collector = Collector()


class JsonlWriter:
    """One JSON line per tick: the collector's stats, the given extra fields
    and a timestamp; flushed at each write.  Process 0 writes; the others'
    writer does nothing (its collector holds every process's counters)."""

    def __init__(self, path: str):
        self.file = open(path, "at") if process_index() == 0 else None

    def write(self, collector: Collector, **extra) -> None:
        if self.file is None:
            return
        record = dict(collector.as_dict())
        record.update(extra)
        record["timestamp"] = time.time()
        self.file.write(json.dumps(record) + "\n")
        self.file.flush()

    def close(self):
        if self.file is not None:
            self.file.close()
