"""Time-step (sigma) schedules for few-NFE diffusion sampling.

The port's own copy of ``diff_sampler_tpu/ops/schedules.py`` (the port
imports nothing of the JAX package); ``tests/test_torch_schedules.py`` holds
the two bit for bit.  It reimplements the four schedule families of the
reference toolbox (`diff-solvers-main/solver_utils.py:6-52`) plus the GITS
sub-selection hook (`gits-main/solver_utils.py:52-53`).

Schedules are computed on the host in float64 numpy; every multistep
coefficient downstream is a pure function of these values, so the sampler
loops on the device reduce to a denoiser call plus a small linear
combination with host scalars.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["get_schedule"]


def _polynomial(num_steps: int, sigma_min: float, sigma_max: float, rho: float) -> np.ndarray:
    i = np.arange(num_steps, dtype=np.float64)
    return (
        sigma_max ** (1.0 / rho)
        + i / (num_steps - 1) * (sigma_min ** (1.0 / rho) - sigma_max ** (1.0 / rho))
    ) ** rho


def _logsnr(num_steps: int, sigma_min: float, sigma_max: float) -> np.ndarray:
    # Uniform in log-SNR: lambda = -log(sigma); interpolate lambda linearly.
    lam = np.linspace(-np.log(sigma_max), -np.log(sigma_min), num_steps, dtype=np.float64)
    return np.exp(-lam)


def vp_params(sigma_min: float, sigma_max: float, epsilon_s: float = 1e-3):
    """beta_d / beta_min of the VP-SDE whose sigma(t) hits (sigma_min, sigma_max)
    at t = (epsilon_s, 1).  Mirrors `solver_utils.py:35-39`."""
    beta_d = (
        2
        * (np.log(sigma_min**2 + 1.0) / epsilon_s - np.log(sigma_max**2 + 1.0))
        / (epsilon_s - 1.0)
    )
    beta_min = np.log(sigma_max**2 + 1.0) - 0.5 * beta_d
    return float(beta_d), float(beta_min)


def vp_sigma(beta_d: float, beta_min: float, t: np.ndarray) -> np.ndarray:
    return np.sqrt(np.exp(0.5 * beta_d * t**2 + beta_min * t) - 1.0)


def vp_sigma_inv(beta_d: float, beta_min: float, sigma: np.ndarray) -> np.ndarray:
    return (np.sqrt(beta_min**2 + 2.0 * beta_d * np.log(sigma**2 + 1.0)) - beta_min) / beta_d


def _time_uniform(num_steps: int, sigma_min: float, sigma_max: float, rho: float) -> np.ndarray:
    epsilon_s = 1e-3
    beta_d, beta_min = vp_params(sigma_min, sigma_max, epsilon_s)
    i = np.arange(num_steps, dtype=np.float64)
    t_temp = (1.0 + i / (num_steps - 1) * (epsilon_s ** (1.0 / rho) - 1.0)) ** rho
    return vp_sigma(beta_d, beta_min, t_temp)


def _discrete(
    num_steps: int,
    sigma_min: float,
    sigma_max: float,
    rho: float,
    sigma_fn: Callable[[np.ndarray], np.ndarray],
    sigma_inv_fn: Callable[[np.ndarray], np.ndarray],
) -> np.ndarray:
    # Faithful to `solver_utils.py:42-48`, including the asymmetric
    # `t_min ** (1/rho) - t_max` spacing used for LDM/SD models.
    t_min = np.asarray(sigma_inv_fn(np.asarray(sigma_min, dtype=np.float64)), dtype=np.float64)
    t_max = np.asarray(sigma_inv_fn(np.asarray(sigma_max, dtype=np.float64)), dtype=np.float64)
    i = np.arange(num_steps, dtype=np.float64)
    t_temp = (t_max + i / (num_steps - 1) * (t_min ** (1.0 / rho) - t_max)) ** rho
    return np.asarray(sigma_fn(t_temp), dtype=np.float64)


def get_schedule(
    num_steps: int,
    sigma_min: float,
    sigma_max: float,
    schedule_type: str = "polynomial",
    schedule_rho: float = 7.0,
    *,
    sigma_fn: Optional[Callable] = None,
    sigma_inv_fn: Optional[Callable] = None,
    dp_list: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Return a decreasing sigma schedule of shape [num_steps] (float64 numpy).

    schedule_type:
      'polynomial'   - EDM rho-polynomial spacing.
      'logsnr'       - uniform log-SNR spacing (DPM-Solver, small images).
      'time_uniform' - uniform VP-time spacing (DPM-Solver, large images).
      'discrete'     - LDM/SD discrete-time spacing; requires sigma_fn/sigma_inv_fn
                       from the wrapped model.
    dp_list: optional GITS index list; sub-selects the schedule
      (`gits-main/solver_utils.py:52-53`).
    """
    if num_steps < 2:
        raise ValueError("num_steps must be >= 2")
    if schedule_type == "polynomial":
        t = _polynomial(num_steps, sigma_min, sigma_max, schedule_rho)
    elif schedule_type == "logsnr":
        t = _logsnr(num_steps, sigma_min, sigma_max)
    elif schedule_type == "time_uniform":
        t = _time_uniform(num_steps, sigma_min, sigma_max, schedule_rho)
    elif schedule_type == "discrete":
        if sigma_fn is None or sigma_inv_fn is None:
            raise ValueError("'discrete' schedule requires sigma_fn and sigma_inv_fn")
        t = _discrete(num_steps, sigma_min, sigma_max, schedule_rho, sigma_fn, sigma_inv_fn)
    else:
        raise ValueError(f"Got wrong schedule type {schedule_type}")

    if dp_list is not None:
        t = t[np.asarray(dp_list, dtype=np.int64)]
    return t
