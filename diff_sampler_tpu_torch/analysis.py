"""Trajectory-geometry analysis (the diff-analyzer subproject).

Counterpart of ``diff_sampler_tpu/analysis.py``, which rebuilds
``diff-analyzer-main/`` (the notebooks ``main_mp.ipynb`` /
``main_extend.ipynb``) as a library; ``cli/analyze_trajectories.py`` and
``cli/analyze_extend.py`` are its command-line front ends:

  * the implicit denoising trajectory, denoised_i = x_i - t_i * d_i
    (``diff-analyzer-main/solvers.py:33-773``);
  * the optimal sampler: any sampler over ``models.analytic.DatasetPosteriorDenoiser``
    (``solvers.py:20-31, 774-867``);
  * geometry statistics of trajectories [T, B, ...]: magnitude, deviation
    from the start -> end line, segment lengths, direction cosines,
    deviation to a reference trajectory (torch, on the trajectory's device),
    and the curvature / torsion of projected trajectories (numpy in float64
    on the host, as in the JAX package: ``gits_utils.py:237-255`` and the
    notebook cells).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .models.analytic import DatasetPosteriorDenoiser
from .ops.geometry import trajectory_curvature, trajectory_deviation, trajectory_lengths

__all__ = [
    "denoised_trajectory",
    "trajectory_magnitude",
    "direction_cosines",
    "deviation_to_reference",
    "pca_project",
    "discrete_curvature_torsion",
    "trajectory_report",
    "regularity_projection",
    "keep_central",
    "procrustes_align",
    "arc_length",
    "windowed_curvature_torsion",
    "optimal_denoiser_from_images",
]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _flat_bt(traj: torch.Tensor) -> torch.Tensor:
    """[T, B, ...] -> [B, T, D]."""
    t = traj.transpose(0, 1)
    return t.reshape(t.shape[0], t.shape[1], -1)


def denoised_trajectory(xs: torch.Tensor, eps: torch.Tensor, t_steps) -> torch.Tensor:
    """Implicit denoising trajectory: denoised_i = x_i - t_i * d_i.

    xs: [T, B, ...] states (xs[0] initial); eps: [T-1, B, ...] gradients.
    Returns [T-1, B, ...]."""
    t = torch.as_tensor(np.asarray(t_steps), dtype=xs.dtype, device=xs.device)
    t = t[: eps.shape[0]].reshape(-1, *([1] * (xs.ndim - 1)))
    return xs[:-1] - t * eps


def trajectory_magnitude(traj: torch.Tensor) -> torch.Tensor:
    """[B, T] L2 norm of each state (the notebook's 'magnitude')."""
    return torch.linalg.vector_norm(_flat_bt(traj), dim=-1)


def direction_cosines(traj: torch.Tensor) -> torch.Tensor:
    """[B, T-2] cosine similarity of consecutive step directions."""
    x = _flat_bt(traj)
    d = x[:, 1:] - x[:, :-1]
    a, b = d[:, :-1], d[:, 1:]
    num = (a * b).sum(dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1) + 1e-12
    return num / den


def deviation_to_reference(traj: torch.Tensor, ref_traj: torch.Tensor) -> torch.Tensor:
    """[B, T] distance between corresponding states of two trajectories
    (e.g. a solver's and the optimal denoiser's)."""
    return torch.linalg.vector_norm(_flat_bt(traj) - _flat_bt(ref_traj), dim=-1)


def pca_project(traj, k: int = 3) -> np.ndarray:
    """Each sample's trajectory in its own top-k PCA subspace: [T, B, ...]
    -> [B, T, k] float64 (the analyzer projects before curvature / torsion)."""
    t = np.swapaxes(_host(traj), 0, 1)
    x = t.reshape(t.shape[0], t.shape[1], -1).astype(np.float64)
    out = np.empty((x.shape[0], x.shape[1], k))
    for i in range(x.shape[0]):
        c = x[i] - x[i].mean(0)
        _u, _s, vt = np.linalg.svd(c, full_matrices=False)
        out[i] = c @ vt[:k].T
    return out


def discrete_curvature_torsion(traj3d: np.ndarray) -> Dict[str, np.ndarray]:
    """Discrete Frenet curvature and torsion of [B, T, 3] curves."""
    d1 = np.diff(traj3d, axis=1)          # [B, T-1, 3]
    d2 = np.diff(d1, axis=1)              # [B, T-2, 3]
    d3 = np.diff(d2, axis=1)              # [B, T-3, 3]
    cross = np.cross(d1[:, :-1], d2)      # [B, T-2, 3]
    num_k = np.linalg.norm(cross, axis=-1)
    den_k = np.linalg.norm(d1[:, :-1], axis=-1) ** 3 + 1e-12
    curvature = num_k / den_k
    triple = np.einsum("btk,btk->bt", cross[:, :-1], d3)
    torsion = triple / (np.linalg.norm(cross[:, :-1], axis=-1) ** 2 + 1e-12)
    return {"curvature": curvature, "torsion": torsion}


def trajectory_report(xs: torch.Tensor, eps=None, t_steps=None,
                      ref_xs=None) -> Dict[str, np.ndarray]:
    """Batch-mean geometry statistics of a sampling trajectory (the
    main_mp.ipynb experiment set); the torch statistics are averaged on the
    trajectory's device, then brought to the host."""
    out = {
        "magnitude": _host(trajectory_magnitude(xs).mean(0)),
        "deviation": _host(trajectory_deviation(xs).mean(0)),
        "segment_lengths": _host(trajectory_lengths(xs).mean(0)),
        "direction_cosine": _host(direction_cosines(xs).mean(0)),
        "curvature": _host(trajectory_curvature(xs).mean(0)),
    }
    if eps is not None and t_steps is not None:
        den = denoised_trajectory(xs, eps, t_steps)
        out["denoised_magnitude"] = _host(trajectory_magnitude(den).mean(0))
    if ref_xs is not None:
        out["deviation_to_reference"] = _host(deviation_to_reference(xs, ref_xs).mean(0))
    ct = discrete_curvature_torsion(pca_project(xs, 3))
    out["pca_curvature"] = ct["curvature"].mean(0)
    out["pca_torsion"] = ct["torsion"].mean(0)
    return out


def regularity_projection(traj):
    """Per-trajectory 3D regularity coordinates (main_extend.ipynb,
    'Regularity of Sampling Trajectories').

    For each sample the first axis u1 is the normalised endpoint difference
    (x_final - x_initial); the trajectory is projected onto the orthogonal
    complement of u1 and its top-2 principal components give u2, u3 (the
    reference reaches the same subspace by QR-orthogonalising D-1 random
    vectors against u1).  Coordinates are relative to the final state, with
    the reference's sign convention (the midpoint test vector).

    traj: [T, B, ...] -> (xs, ys, zs), each [T, B] float64.
    """
    t = np.asarray(_host(traj), np.float64)
    T, B = t.shape[0], t.shape[1]
    data = t.reshape(T, B, -1)
    x_end, x_start = data[-1], data[0]           # [B, D]
    v = x_end - x_start
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xs = np.empty((T, B))
    ys = np.empty((T, B))
    zs = np.empty((T, B))
    for b in range(B):
        d = data[:, b]                           # [T, D]
        dp = d - np.outer(d @ v[b], v[b])        # project out u1
        c = dp - dp.mean(0)
        _u, _s, vt = np.linalg.svd(c, full_matrices=False)
        v2, v3 = vt[0], vt[1]
        # Gram-Schmidt against u1 (numerically already ~orthogonal)
        u1 = v[b]
        u2 = v2 - (u1 @ v2) * u1
        u3 = v3 - (u1 @ v3) * u1 - ((u2 @ v3) / (u2 @ u2)) * u2
        u2 /= np.linalg.norm(u2)
        u3 /= np.linalg.norm(u3)
        test = d[T // 2] - x_end[b]
        u1 = u1 if test @ u1 < 0 else -u1
        u2 = u2 if test @ u2 > 0 else -u2
        u3 = u3 if test @ u3 > 0 else -u3
        u3 = -u3
        rel = d - x_end[b]
        xs[:, b] = rel @ u1
        ys[:, b] = rel @ u2
        zs[:, b] = rel @ u3
    return xs, ys, zs


def keep_central(xs, ys, zs, ratio: float = 0.8):
    """Drop PC-norm outliers for visualisation (main_extend, cell 13's tail)."""
    pc_norm = (ys**2 + 10.0 * zs**2).sum(axis=0)
    num = int(xs.shape[1] * ratio)
    order = np.argsort(pc_norm)
    start = (xs.shape[1] - num) // 2
    keep = order[start:start + num]
    return xs[:, keep], ys[:, keep], zs[:, keep]


def procrustes_align(xs, ys, zs, base_idx: int = 0, proj_dim: int = 2):
    """Calibrated trajectories (main_extend.ipynb, 'Calibrated
    Trajectories'): each trajectory's (PC1, PC2) coordinates, or all three
    axes with ``proj_dim=3``, rotated by the orthogonal Procrustes solution
    against the base trajectory.  Returns the aligned (xs, ys, zs), each
    [T, B].

    For M = A^T B = U S Vh the minimiser of ||A O - B|| is O = U Vh; the
    notebook computes U Vh^T (its ``V`` is numpy's ``vh``), the transpose:
    this uses the correct closed form, as the JAX package does."""
    B_full = np.stack([xs[:, base_idx], ys[:, base_idx], zs[:, base_idx]], 1)
    out_x, out_y, out_z = xs.copy(), ys.copy(), zs.copy()
    for i in range(xs.shape[1]):
        A_full = np.stack([xs[:, i], ys[:, i], zs[:, i]], 1)
        if proj_dim == 3:
            m = A_full.T @ B_full
            u, _s, vh = np.linalg.svd(m)
            r = A_full @ (u @ vh)
            out_x[:, i], out_y[:, i], out_z[:, i] = r[:, 0], r[:, 1], r[:, 2]
        else:
            m = A_full[:, 1:].T @ B_full[:, 1:]
            u, _s, vh = np.linalg.svd(m)
            r = A_full[:, 1:] @ (u @ vh)
            out_y[:, i], out_z[:, i] = r[:, 0], r[:, 1]
    return out_x, out_y, out_z


def arc_length(xs, ys, zs) -> np.ndarray:
    """Cumulative arc length s [T, B] of projected trajectories."""
    d = np.stack([xs, ys, zs], axis=1)               # [T, 3, B]
    ds = np.linalg.norm(np.diff(d, axis=0), axis=1)  # [T-1, B]
    return np.concatenate([np.zeros((1, ds.shape[1])), ds], 0).cumsum(0)


def windowed_curvature_torsion(xs, ys, zs, s=None, window_size: int = 101):
    """Curvature / torsion by a local cubic least-squares fit in arc length
    (main_extend.ipynb ``cal_curv_tors``): within a sliding window around
    each point, fit r(s0 + d) - r(s0) = r' d + r'' d^2/2 + r''' d^3/6 by the
    normal equations, then kappa = |r' x r''| / |r'|^3 and
    tau = (r' x r'') . r''' / |r' x r''|^2.

    Returns (curvatures, torsions, s), each [T, B] (the reference's
    reflected padding at the ends).
    """
    if s is None:
        s = arc_length(xs, ys, zs)
    half = window_size // 2

    def reflect(a):
        return np.concatenate([a[half + 1:2 * half + 1], a, a[-2 * half:-half]], axis=0)

    sn = reflect(s)
    rn = np.stack([reflect(xs), reflect(ys), reflect(zs)], axis=1)  # [T+2h, 3, B]
    T, B = xs.shape
    A = np.zeros((3, 3, T, B))
    Bm = np.zeros((3, 3, T, B))  # rows: moment order; cols: x, y, z
    center_s = s
    center_r = rn[half:half + T]  # == stack(xs, ys, zs)
    for i in range(window_size):
        end = None if i == window_size - 1 else -2 * half + i
        ds_ = sn[i:end] - center_s                       # [T, B]
        dr = rn[i:end] - center_r                        # [T, 3, B]
        p1, p2, p3 = ds_, ds_**2 / 2.0, ds_**3 / 6.0
        A[0, 0] += p1 * p1
        A[0, 1] += p1 * p2
        A[0, 2] += p1 * p3
        A[1, 1] += p2 * p2
        A[1, 2] += p2 * p3
        A[2, 2] += p3 * p3
        for r_i, p in enumerate((p1, p2, p3)):
            Bm[r_i] += (p[:, None, :] * dr).transpose(1, 0, 2)
    A[1, 0], A[2, 0], A[2, 1] = A[0, 1], A[0, 2], A[1, 2]
    Am = A.transpose(2, 3, 0, 1)                         # [T, B, 3, 3]
    Bt = Bm.transpose(2, 3, 0, 1)                        # [T, B, 3, 3]
    X = np.linalg.solve(Am, Bt)                          # [T, B, 3 (order), 3 (xyz)]
    r_p, r_pp, r_ppp = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    cross = np.cross(r_p, r_pp)
    curv = np.linalg.norm(cross, axis=-1) / (np.linalg.norm(r_p, axis=-1) ** 3 + 1e-12)
    tors = (np.einsum("tbk,tbk->tb", cross, r_ppp)
            / (np.linalg.norm(cross, axis=-1) ** 2 + 1e-12))
    return curv, tors, s


def optimal_denoiser_from_images(images_uint8: np.ndarray, sigma_min=0.002, sigma_max=80.0,
                                 device="cuda") -> DatasetPosteriorDenoiser:
    """The dataset-posterior ('optimal') denoiser of uint8 NHWC images,
    scaled to [-1, 1] as the sampling pipeline's images are."""
    data = np.asarray(images_uint8, np.float32) / 127.5 - 1.0
    return DatasetPosteriorDenoiser(data, sigma_min=sigma_min, sigma_max=sigma_max,
                                    device=device)
