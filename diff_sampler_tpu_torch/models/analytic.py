"""Analytic denoisers: closed-form posterior means for known data
distributions.

Counterpart of ``diff_sampler_tpu/models/analytic.py``.  Two uses:
  1. Test fixtures: a Gaussian data distribution gives an exact denoiser and
     an exact probability-flow ODE solution, so solvers can be checked for
     convergence.
  2. The diff-analyzer's 'optimal sampler': the posterior mean over a finite
     dataset.

Each is a callable ``denoise(x, sigma)`` with ``sigma_min`` / ``sigma_max``,
as a bound network is; sigma is a scalar or one value per sample.  The
parameters live on ``device``, the card unless the caller passes
``device="cpu"``, and x must lie there too.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "GaussianDenoiser",
    "DatasetPosteriorDenoiser",
    "IsotropicGaussianDenoiser",
    "LowRankGaussianDenoiser",
    "MixtureGaussianDenoiser",
]


def _tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _sigma_col(sigma, x: torch.Tensor, dtype) -> torch.Tensor:
    """sigma (scalar or per-sample [B]) -> column [B or 1, 1] that broadcasts
    against flattened [B, D] data (AMED passes per-sample midpoints)."""
    return torch.as_tensor(sigma, dtype=dtype, device=x.device).reshape(-1, 1)


class GaussianDenoiser:
    """Exact denoiser for data ~ N(mu, diag(var)):

        D(x, sigma) = mu + var / (var + sigma^2) * (x - mu)

    The probability-flow ODE dx/dt = (x - D) / t then has the closed-form
    solution x(t) - mu = (x(T) - mu) * sqrt((var + t^2) / (var + T^2))."""

    def __init__(self, mu, var, sigma_min=0.002, sigma_max=80.0, device="cuda"):
        self.mu = _tensor(mu, device)
        self.var = _tensor(var, device)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    def __call__(self, x, sigma):
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        mu, var = self.mu.to(x.dtype), self.var.to(x.dtype)
        return mu + var / (var + sigma ** 2) * (x - mu)

    def exact_solution(self, x_T, t_from, t_to):
        scale = torch.sqrt(torch.as_tensor((self.var + t_to ** 2) / (self.var + t_from ** 2)))
        return self.mu + (x_T - self.mu) * scale


class DatasetPosteriorDenoiser:
    """Posterior mean over a finite dataset {y_i}:

        D(x, t) = sum_i softmax_i(-||x - y_i||^2 / (2 t^2)) * y_i

    over the batch at once (one [B, M] product for the distances)."""

    def __init__(self, dataset, sigma_min=0.002, sigma_max=80.0, device="cuda"):
        d = _tensor(dataset, device)
        self.dataset = d.reshape(d.shape[0], -1)  # [M, D]
        self.data_shape = tuple(d.shape[1:])
        self.sq_norms = (self.dataset ** 2).sum(dim=1)  # [M]
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    def __call__(self, x, sigma):
        s2 = _sigma_col(sigma, x, x.dtype) ** 2  # [B or 1, 1]
        xb = x.reshape(x.shape[0], -1)  # [B, D]
        data = self.dataset.to(x.dtype)
        # ||x - y||^2 = ||x||^2 - 2 x.y + ||y||^2; the x term is the same for
        # every i and drops out of the softmax
        logits = (xb @ data.T - 0.5 * self.sq_norms.to(x.dtype)) / s2  # [B, M]
        w = torch.softmax(logits, dim=1)
        return (w @ data).reshape(x.shape)


class IsotropicGaussianDenoiser:
    """Data ~ N(mu, I): D(x, t) = (t^2 mu + x) / (1 + t^2) (the analyzer's
    'full_rank_gaussian')."""

    def __init__(self, mu, sigma_min=0.002, sigma_max=80.0, device="cuda"):
        self.mu = _tensor(mu, device).reshape(-1)  # [D]
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    def __call__(self, x, sigma):
        t2 = _sigma_col(sigma, x, torch.float32) ** 2  # [B or 1, 1]
        xb = x.reshape(x.shape[0], -1)
        d = (self.mu * t2 + xb) / (1.0 + t2)
        return d.reshape(x.shape).to(x.dtype)


class LowRankGaussianDenoiser:
    """Data ~ N(mu, U diag(lam) U^T) with a rank-q eigenbasis:

        D(x, t) = mu + U diag(lam / (t^2 + lam)) U^T (x - mu)

    (the analyzer's 'low_rank_gaussian'; ``from_data`` takes the exact
    eigendecomposition of the empirical covariance)."""

    def __init__(self, mu, eigvecs, eigvals, sigma_min=0.002, sigma_max=80.0, device="cuda"):
        self.mu = _tensor(mu, device).reshape(-1)  # [D]
        self.U = _tensor(eigvecs, device)  # [D, q]
        self.lam = _tensor(eigvals, device).reshape(-1)  # [q]
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    @classmethod
    def from_data(cls, data, rank, **kw):
        d = np.asarray(data, np.float64).reshape(len(data), -1)
        mu = d.mean(0)
        # top-`rank` eigenpairs of cov = C^T C / (n - 1) from the SVD of C
        _u, s, vt = np.linalg.svd(d - mu, full_matrices=False)
        lam = (s ** 2 / (len(d) - 1))[:rank]
        return cls(mu.astype(np.float32), vt[:rank].T.astype(np.float32),
                   lam.astype(np.float32), **kw)

    def __call__(self, x, sigma):
        t2 = _sigma_col(sigma, x, torch.float32) ** 2  # [B or 1, 1]
        xb = x.reshape(x.shape[0], -1) - self.mu
        proj = (xb @ self.U) * (self.lam / (t2 + self.lam))
        d = self.mu + proj @ self.U.T
        return d.reshape(x.shape).to(x.dtype)


class MixtureGaussianDenoiser:
    """Per-class Gaussians N(mu_k, Sigma_k) weighted by their posterior
    responsibilities:

        w_k(x, t) ~ softmax_k log N(x; mu_k, Sigma_k + t^2 I)
        D(x, t)   = sum_k w_k(x, t) D_k(x, t)

    (the analyzer's 'low/full_rank_mog').  Components are Isotropic- or
    LowRank- GaussianDenoisers."""

    def __init__(self, components, sigma_min=0.002, sigma_max=80.0):
        self.components = list(components)
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)

    @classmethod
    def from_labeled_data(cls, data, labels, rank=None, sigma_min=0.002, sigma_max=80.0,
                          device="cuda"):
        kw = dict(sigma_min=sigma_min, sigma_max=sigma_max)
        data = np.asarray(data, np.float32).reshape(len(data), -1)
        labels = np.asarray(labels)
        if labels.ndim == 2:  # one-hot
            labels = labels.argmax(1)
        comps = []
        for k in sorted(set(labels.tolist())):
            dk = data[labels == k]
            if rank is None:
                comps.append(IsotropicGaussianDenoiser(dk.mean(0), device=device, **kw))
            else:
                comps.append(LowRankGaussianDenoiser.from_data(dk, rank, device=device, **kw))
        return cls(comps, **kw)

    @staticmethod
    def _log_prob(comp, xb, t2):
        """log N(x; mu, Sigma + t^2 I) up to a constant shared by the
        components; t2: per-sample [B or 1] sigma^2."""
        d = xb.shape[1]
        c = xb - comp.mu
        if isinstance(comp, IsotropicGaussianDenoiser):
            # Sigma + t^2 I = (1 + t^2) I
            q = (c ** 2).sum(dim=1) / (1.0 + t2)
            logdet = d * torch.log1p(t2)
        else:
            # Sigma = U diag(lam) U^T (0 off the subspace), plus t^2 I
            proj = c @ comp.U  # [B, q]
            q = ((c ** 2).sum(dim=1) / t2
                 - (proj ** 2 * (1.0 / t2[:, None] - 1.0 / (t2[:, None] + comp.lam))).sum(dim=1))
            logdet = ((d - comp.lam.shape[0]) * torch.log(t2)
                      + torch.log(t2[:, None] + comp.lam).sum(dim=1))
        return -0.5 * (q + logdet)

    def __call__(self, x, sigma):
        t2 = _sigma_col(sigma, x, torch.float32).reshape(-1) ** 2  # [B or 1]
        xb = x.reshape(x.shape[0], -1)
        logps = torch.stack([self._log_prob(c, xb, t2) for c in self.components], dim=1)
        w = torch.softmax(logps, dim=1)  # [B, K]
        ds = torch.stack([c(x, sigma).reshape(x.shape[0], -1) for c in self.components],
                         dim=1)  # [B, K, D]
        d = torch.einsum("bk,bkd->bd", w, ds)
        return d.reshape(x.shape).to(x.dtype)
