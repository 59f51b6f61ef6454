"""Checkpoints and experiment directories.

Counterpart of ``diff_sampler_tpu/utils/checkpoint.py``, without jax (that
module imports it for multi-host runs).  Parameters are flat ``.npz`` files
of nested dicts of numpy arrays, keyed ``<tree>/<layer>/<leaf>`` (the main
tree under ``params``), and every run config is a JSON sidecar: the same
files as the JAX package's, so a predictor saved by either package loads in
the other.  Run directories are ``<base>/<5-digit id>-<desc>``, numbered
upward and found again by number.

A training snapshot (``snapshot-XXXXXX.npz``) is the JAX package's: the
params under ``params``, the state of ``optax.adam`` (learning-rate
schedule included) under ``opt_state`` as its ``jax.tree.leaves`` keyed
``000000``, ``000001``, ... (``adam_state_leaves``), and ``meta/cur_nimg``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["save_params", "load_params", "save_config", "load_config",
           "create_run_dir", "find_run_dir", "flatten_params", "unflatten_params",
           "tree_leaf_paths", "adam_state_leaves", "adam_state_from_leaves"]

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
    """``<base>/<id>-<desc>/``, the id one above the largest in ``base``.  In
    a multi-process run process 0 picks the id, broadcasts it and alone
    makes the directory, so that every process names the same one."""
    from ..parallel.mesh import broadcast_object, process_index

    run_dir = None
    if process_index() == 0:
        os.makedirs(base, exist_ok=True)
        prev = [re.match(r"^(\d{5})-", d) for d in os.listdir(base)]
        run_id = max((int(m.group(1)) for m in prev if m), default=-1) + 1
        run_dir = os.path.join(base, f"{run_id:05d}-{desc}")
        os.makedirs(run_dir)
    return broadcast_object(run_dir)


def find_run_dir(base: str, number: int) -> Optional[str]:
    """The run directory of experiment ``number`` in ``base``, or None."""
    if not os.path.isdir(base):
        return None
    for d in sorted(os.listdir(base)):
        m = re.match(r"^(\d{5})-", d)
        if m and int(m.group(1)) == number:
            return os.path.join(base, d)
    return None


def tree_leaf_paths(tree: Dict, prefix: tuple = ()) -> list:
    """The paths of a nested dict's leaves in ``jax.tree.leaves`` order
    (keys sorted at every level)."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += tree_leaf_paths(tree[k], prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


def _at(tree: Dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def adam_state_leaves(count: int, mu: Dict, nu: Dict) -> Dict[str, np.ndarray]:
    """The leaves of ``optax.adam(schedule)``'s state, (ScaleByAdamState(count,
    mu, nu), ScaleByScheduleState(count)), keyed by their zero-padded index
    as the JAX CLI saves them: count, mu's leaves, nu's leaves, count (int32
    scalars; mu and nu in the params' layout)."""
    paths = tree_leaf_paths(mu)
    leaves = [np.asarray(count, np.int32)]
    leaves += [np.asarray(_at(mu, p), np.float32) for p in paths]
    leaves += [np.asarray(_at(nu, p), np.float32) for p in paths]
    leaves.append(np.asarray(count, np.int32))
    return {f"{i:06d}": leaf for i, leaf in enumerate(leaves)}


def adam_state_from_leaves(leaves: Dict[str, np.ndarray], like: Dict) -> tuple:
    """(count, mu, nu) from ``adam_state_leaves``'s dict, mu and nu shaped
    as the params tree ``like``; the two counts must agree."""
    paths = tree_leaf_paths(like)
    flat = [leaves[k] for k in sorted(leaves)]
    if len(flat) != 2 * len(paths) + 2:
        raise ValueError(f"{len(flat)} optimizer leaves for {len(paths)} params: not the "
                         f"state of optax.adam with a schedule")
    count = int(flat[0])
    if int(flat[-1]) != count:
        raise ValueError(f"Adam's count {count} and the schedule's {int(flat[-1])} differ")

    def tree(arrays):
        out: Dict = {}
        for p, a in zip(paths, arrays):
            if a.shape != np.shape(_at(like, p)):
                raise ValueError(f"{'/'.join(p)}: moment {a.shape}, param "
                                 f"{np.shape(_at(like, p))}")
            node = out
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = a
        return out

    return count, tree(flat[1:1 + len(paths)]), tree(flat[1 + len(paths):-1])
