"""Precision / Recall / Density / Coverage over feature manifolds.

Counterpart of ``diff_sampler_tpu/eval/prdc.py`` (itself the reference's
``sfd-main/prdc.py:29-124``): the pairwise distances in chunks of rows on
the device, as ``x^2 - 2 x y^T + y^2`` in f32 with TF32 off, clamped at 0
and square-rooted, into an f32 host matrix; the k-NN radii and the four
metrics on the host with numpy.

One departure: the port centres both sets on their joint mean before the
products.  The JAX package's f32 formula cancels where the features' spread
is small against their norm (a random detector on noise images: 150 of
6.25M precision decisions away from float64's, on an H100), the centred one
agrees with float64 but within 1e-5 of a radius.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .inception import exact_f32

__all__ = ["pairwise_distances", "knn_radii", "compute_prdc"]


def pairwise_distances(x: np.ndarray, y: np.ndarray = None, chunk: int = 4096,
                       device: str = "cuda") -> np.ndarray:
    """Euclidean distance matrix [N, M] (f32 numpy), computed in chunks of
    ``chunk`` rows of ``x`` on ``device``."""
    if y is None:
        y = x
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    out = np.empty((x.shape[0], y.shape[0]), np.float32)
    with exact_f32():
        # distances do not move with the origin: centred features keep x^2
        # and y^2 near d^2, so the f32 difference loses no digits where the
        # features' spread is small against their norm
        centre = (x.sum(0) + y.sum(0)) / (x.shape[0] + y.shape[0])
        x, y = x - centre, y - centre
        y_sq = (y ** 2).sum(1)
        for s in range(0, x.shape[0], chunk):
            xc = x[s:s + chunk]
            d2 = (xc ** 2).sum(1)[:, None] - 2.0 * (xc @ y.T) + y_sq[None, :]
            out[s:s + chunk] = torch.sqrt(torch.clamp(d2, min=0.0)).cpu().numpy()
    return out


def _kth_value(unsorted: np.ndarray, k: int) -> np.ndarray:
    indices = np.argpartition(unsorted, k, axis=-1)[..., :k]
    return np.take_along_axis(unsorted, indices, axis=-1).max(axis=-1)


def knn_radii(features: np.ndarray, nearest_k: int, device: str = "cuda") -> np.ndarray:
    """Distance to the k-th nearest neighbour (self included, then skipped:
    the k + 1 smallest, prdc.py:57-67)."""
    return _kth_value(pairwise_distances(features, device=device), nearest_k + 1)


def compute_prdc(real_features: np.ndarray, fake_features: np.ndarray, nearest_k: int,
                 realism: bool = False, device: str = "cuda") -> Dict[str, float]:
    """prdc.py:71-124; with ``realism`` also the per-fake-sample realism
    score (an array) under ``realism``."""
    real_r = knn_radii(real_features, nearest_k, device)
    fake_r = knn_radii(fake_features, nearest_k, device)
    d_rf = pairwise_distances(real_features, fake_features, device=device)

    precision = float((d_rf < real_r[:, None]).any(axis=0).mean())
    recall = float((d_rf < fake_r[None, :]).any(axis=1).mean())
    density = float((1.0 / nearest_k) * (d_rf < real_r[:, None]).sum(axis=0).mean())
    coverage = float((d_rf.min(axis=1) < real_r).mean())
    out = dict(precision=precision, recall=recall, density=density, coverage=coverage)
    if realism:
        mask = real_r < np.median(real_r)
        out["realism"] = (real_r[mask, None] / d_rf[mask]).max(axis=0)
    return out
