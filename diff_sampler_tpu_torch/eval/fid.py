"""Frechet Inception Distance.

Counterpart of ``diff_sampler_tpu/eval/fid.py`` (itself the reference's
``diff-solvers-main/fid.py``):
  * streaming feature moments: per batch an f32 ``f.sum(0)`` and ``f.T @ f``
    on the device (TF32 off), added into float64 host totals, with the
    reference's (n - 1) normalisation (fid.py:61-78);
  * the Frechet distance with ``scipy.linalg.sqrtm`` on the host
    (fid.py:83-87);
  * reference statistics as ``.npz`` (keys ``mu`` / ``sigma``).
The JAX package's data-sharded ``mesh`` argument has no counterpart yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from .inception import InceptionV3FID, exact_f32

__all__ = ["FIDAccumulator", "compute_fid", "calculate_stats", "load_stats", "save_stats",
           "make_inception_feature_fn"]


@dataclasses.dataclass
class FIDAccumulator:
    """Streaming mu / sigma accumulation (float64 host totals).  Features
    that are torch tensors stay on their device; numpy ones go to
    ``device``."""

    feature_dim: int = 2048
    device: str = "cuda"

    def __post_init__(self):
        self.raw_mu = np.zeros(self.feature_dim, np.float64)
        self.raw_sigma = np.zeros((self.feature_dim, self.feature_dim), np.float64)
        self.n = 0

    def update(self, features) -> None:
        """features: [B, D] (a torch tensor or a numpy array)."""
        if not isinstance(features, torch.Tensor):
            features = torch.from_numpy(np.asarray(features)).to(self.device)
        f = features.float()
        with exact_f32():
            f_sum, outer = f.sum(0), f.T @ f
        self.raw_mu += f_sum.double().cpu().numpy()
        self.raw_sigma += outer.double().cpu().numpy()
        self.n += f.shape[0]

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sigma) with the reference's (n - 1) normalisation (fid.py:76-78)."""
        if self.n < 2:
            raise ValueError("need at least 2 samples for FID statistics")
        mu = self.raw_mu / self.n
        sigma = (self.raw_sigma - np.outer(mu, mu) * self.n) / (self.n - 1)
        return mu, sigma


def compute_fid(mu: np.ndarray, sigma: np.ndarray, mu_ref: np.ndarray,
                sigma_ref: np.ndarray) -> float:
    """Frechet distance (fid.py:83-87)."""
    m = np.square(mu - mu_ref).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma, sigma_ref))
    if isinstance(s, tuple):  # older scipy returns (sqrtm, errest)
        s = s[0]
    return float(np.real(m + np.trace(sigma + sigma_ref - s * 2)))


def calculate_stats(feature_fn: Callable, batches: Iterable, feature_dim: int = 2048,
                    device: str = "cuda", timings: Optional[Dict[str, float]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) over an iterable of uint8 NHWC image batches; grayscale
    batches repeat to RGB (fid.py:65-66).  Where ``timings`` is a dict, the
    host seconds spent drawing batches (``decode``) and in the features and
    moments up to their copy to the host (``features``) add into it."""
    acc = FIDAccumulator(feature_dim, device)
    spent = {"decode": 0.0, "features": 0.0}
    batches = iter(batches)
    while True:
        t0 = time.perf_counter()
        images = next(batches, None)
        t1 = time.perf_counter()
        spent["decode"] += t1 - t0
        if images is None:
            break
        if images.shape[0] == 0:
            continue
        if images.shape[-1] == 1:
            images = np.repeat(images, 3, axis=-1)
        acc.update(feature_fn(images))
        spent["features"] += time.perf_counter() - t1
    if timings is not None:
        for k, v in spent.items():
            timings[k] = timings.get(k, 0.0) + v
    return acc.finalize()


def save_stats(path: str, mu: np.ndarray, sigma: np.ndarray) -> None:
    np.savez(path, mu=mu, sigma=sigma)


def load_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as f:
        return f["mu"], f["sigma"]


def make_inception_feature_fn(state_dict, device: str = "cuda",
                              tf_preprocessing: bool = False) -> Callable:
    """uint8 NHWC images (numpy) -> [B, 2048] f32 features on ``device``,
    through ``InceptionV3FID`` with ``state_dict`` (the port module's names),
    under ``torch.inference_mode``."""
    net = InceptionV3FID(tf_preprocessing=tf_preprocessing)
    net.load_state_dict(state_dict)
    net = net.to(device).eval()

    def feature_fn(images) -> torch.Tensor:
        with torch.inference_mode():
            return net(torch.from_numpy(np.asarray(images)).to(device))

    return feature_fn
