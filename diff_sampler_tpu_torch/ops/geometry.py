"""Trajectory geometry (GITS and the trajectory analyzer).

Counterpart of ``diff_sampler_tpu/ops/geometry.py``: the deviation of a
sampling trajectory from the straight line between its ends, its segment
lengths and its discrete curvature.  Each takes a trajectory [T, B, ...].
"""

from __future__ import annotations

import torch

__all__ = ["trajectory_deviation", "trajectory_lengths", "trajectory_curvature"]


def _flat(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], v.shape[1], -1)


def trajectory_deviation(traj: torch.Tensor) -> torch.Tensor:
    """[B, T-2]: the distance of each intermediate point from the line
    start -> end."""
    t = traj.transpose(0, 1)  # [B, T, ...]
    a = _flat(t[:, 1:-1])  # [B, T-2, D]
    start, end = _flat(t[:, :1]), _flat(t[:, -1:])  # [B, 1, D]
    ac = end - a
    bc = end - start
    bc_unit = bc / torch.linalg.vector_norm(bc, dim=-1, keepdim=True)
    proj = (ac * bc_unit).sum(dim=-1, keepdim=True) * bc_unit
    return torch.linalg.vector_norm(ac - proj, dim=-1)


def trajectory_lengths(traj: torch.Tensor) -> torch.Tensor:
    """[B, T-1]: the Euclidean length of each segment."""
    t = traj.transpose(0, 1)
    return torch.linalg.vector_norm(_flat(t[:, 1:]) - _flat(t[:, :-1]), dim=-1)


def trajectory_curvature(traj: torch.Tensor) -> torch.Tensor:
    """[B, T-2]: the angle between consecutive segments over their mean
    length."""
    x = _flat(traj.transpose(0, 1))
    d1 = x[:, 1:] - x[:, :-1]
    a, b = d1[:, :-1], d1[:, 1:]
    na = torch.linalg.vector_norm(a, dim=-1)
    nb = torch.linalg.vector_norm(b, dim=-1)
    cos = ((a * b).sum(dim=-1) / (na * nb + 1e-12)).clamp(-1.0, 1.0)
    return torch.arccos(cos) / (0.5 * (na + nb) + 1e-12)
