"""Plain reference of the ODE solvers the cells drive, step by step as the
published solvers take them, on a denoiser ``D(x, sigma)``.

- ``ipndm``: improved PNDM (Zhang & Chen 2023, ``diff-solvers-main/
  solvers.py``): fixed-step Adams-Bashforth on d = (x - D) / sigma, order
  rising to ``max_order``.
- ``dpmpp``: DPM-Solver++ multistep in its data prediction (Lu et al. 2022),
  orders 1-3 with ``lower_order_final``, each prediction dynamically
  thresholded at its 0.995 quantile (clamped at 1 at least), in EDM's sigma
  parametrisation (alpha = 1, lambda = -log sigma).

The schedule is float64 numpy, as the reference computes it; each sigma is
used as a Python float.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def polynomial_schedule(num_steps: int, sigma_min: float, sigma_max: float,
                        rho: float) -> np.ndarray:
    i = np.arange(num_steps, dtype=np.float64)
    return (sigma_max ** (1 / rho) + i / (num_steps - 1)
            * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho


def ipndm(denoise, latents, t_steps, max_order: int = 4):
    x = latents * float(t_steps[0])
    history = []
    for i in range(len(t_steps) - 1):
        t_cur, t_next = float(t_steps[i]), float(t_steps[i + 1])
        d = (x - denoise(x, t_cur)) / t_cur
        order = min(max_order, i + 1)
        if order == 1:
            step = d
        elif order == 2:
            step = (3 * d - history[-1]) / 2
        elif order == 3:
            step = (23 * d - 16 * history[-1] + 5 * history[-2]) / 12
        else:
            step = (55 * d - 59 * history[-1] + 37 * history[-2] - 9 * history[-3]) / 24
        x = x + (t_next - t_cur) * step
        history = (history + [d])[-3:]
    return x


def dynamic_threshold(x0, p: float = 0.995):
    s = torch.quantile(x0.abs().reshape(x0.shape[0], -1), p, dim=1).clamp_min(1.0)
    s = s.reshape((-1,) + (1,) * (x0.dim() - 1))
    return torch.clamp(x0, -s, s) / s


def dpmpp(denoise, latents, t_steps, max_order: int = 3, lower_order_final: bool = True,
          states: bool = False):
    """The last state, or with ``states`` every state from the first."""
    n = len(t_steps)
    x = latents * float(t_steps[0])
    xs = [x]
    ms, lams = [], []  # data predictions and their lambdas, oldest first
    for i in range(n - 1):
        s, t = float(t_steps[i]), float(t_steps[i + 1])
        ms.append(dynamic_threshold(denoise(x, s)))
        lams.append(-math.log(s))
        if lower_order_final:
            order = i + 1 if i + 1 < max_order else min(max_order, n - (i + 1))
        else:
            order = min(max_order, i + 1)
        h = -math.log(t) - lams[-1]
        phi_1 = math.expm1(-h)
        x = (t / s) * x - phi_1 * ms[-1]
        if order == 2:
            r0 = (lams[-1] - lams[-2]) / h
            x = x - 0.5 * phi_1 * (ms[-1] - ms[-2]) / r0
        elif order == 3:
            r0 = (lams[-1] - lams[-2]) / h
            r1 = (lams[-2] - lams[-3]) / h
            d1_0 = (ms[-1] - ms[-2]) / r0
            d1_1 = (ms[-2] - ms[-3]) / r1
            d1 = d1_0 + r0 / (r0 + r1) * (d1_0 - d1_1)
            d2 = (d1_0 - d1_1) / (r0 + r1)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            x = x + phi_2 * d1 - phi_3 * d2
        ms, lams = ms[-2:], lams[-2:]
        xs.append(x)
    return xs if states else x


SOLVERS = {"ipndm": ipndm, "dpmpp": dpmpp}
