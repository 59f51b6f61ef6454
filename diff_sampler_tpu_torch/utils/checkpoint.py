"""Checkpoints and experiment directories.

Counterpart of ``diff_sampler_tpu/utils/checkpoint.py``, without jax (that
module imports it for multi-host runs).  Parameters are flat ``.npz`` files
of nested dicts of numpy arrays, keyed ``<tree>/<layer>/<leaf>`` (the main
tree under ``params``), and every run config is a JSON sidecar: the same
files as the JAX package's, so a predictor saved by either package loads in
the other.  Run directories are ``<base>/<5-digit id>-<desc>``, numbered
upward and found again by number.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["save_params", "load_params", "save_config", "load_config",
           "create_run_dir", "find_run_dir", "flatten_params", "unflatten_params"]

_SEP = "/"


def flatten_params(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params(path: str, params: Dict, **aux_trees) -> None:
    """Save one or more nested dicts of arrays into one .npz (the main tree
    under 'params', extra trees under their keyword's name)."""
    flat = {f"params{_SEP}{k}": v for k, v in flatten_params(params).items()}
    for name, tree in aux_trees.items():
        flat.update({f"{name}{_SEP}{k}": v for k, v in flatten_params(tree).items()})
    np.savez(path, **flat)


def load_params(path: str) -> Dict[str, Dict]:
    """Returns {tree_name: nested dict of numpy arrays}."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    roots: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in flat.items():
        root, rest = k.split(_SEP, 1)
        roots.setdefault(root, {})[rest] = v
    return {root: unflatten_params(sub) for root, sub in roots.items()}


def save_config(path: str, config: Any) -> None:
    if dataclasses.is_dataclass(config):
        config = dataclasses.asdict(config)
    with open(path, "w") as f:
        json.dump(config, f, indent=2, default=str)


def load_config(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def create_run_dir(base: str, desc: str) -> str:
    """``<base>/<id>-<desc>/``, the id one above the largest in ``base``."""
    os.makedirs(base, exist_ok=True)
    prev = [re.match(r"^(\d{5})-", d) for d in os.listdir(base)]
    run_id = max((int(m.group(1)) for m in prev if m), default=-1) + 1
    run_dir = os.path.join(base, f"{run_id:05d}-{desc}")
    os.makedirs(run_dir)
    return run_dir


def find_run_dir(base: str, number: int) -> Optional[str]:
    """The run directory of experiment ``number`` in ``base``, or None."""
    if not os.path.isdir(base):
        return None
    for d in sorted(os.listdir(base)):
        m = re.match(r"^(\d{5})-", d)
        if m and int(m.group(1)) == number:
            return os.path.join(base, d)
    return None
