"""ODE samplers for few-NFE diffusion sampling: euler, heun, dpm (DPM-Solver-2),
ipndm, ipndm_v, deis, dpmpp (DPM-Solver++ multistep) and unipc (UniPC
predictor-corrector).

Counterpart of ``diff_sampler_tpu/solvers/samplers.py``.  The JAX package
runs each sampler as one ``lax.scan``; here the step loop is a Python loop
that enqueues work on the device and never waits for it.  Every per-step
scalar comes from ``ops.multistep`` (the port's copy of the JAX package's
host-side coefficients) in float64 and is cast
to the working dtype before use, as the JAX package does.

Conventions shared with the JAX package (and the reference):
  * ``x0 = latents * t_steps[0]``;
  * AFS: the first step takes the analytic ``d = x / sqrt(1 + t^2)``;
  * ``denoise_to_zero``: one final full denoise at ``t_steps[-1]``;
  * ``return_inters``: the trajectory including x0 (and the
    denoise-to-zero output) in ``xs``, the per-step gradients in ``eps``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import multistep

Denoiser = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

__all__ = [
    "SampleResult",
    "dynamic_thresholding",
    "euler_sampler",
    "heun_sampler",
    "dpm_2_sampler",
    "ipndm_sampler",
    "ipndm_v_sampler",
    "deis_sampler",
    "dpm_pp_sampler",
    "unipc_sampler",
    "SOLVER_REGISTRY",
    "get_sampler",
    "count_nfe",
]


class SampleResult(NamedTuple):
    """x: final sample.  xs: [num_steps(+1), B, ...] trajectory including the
    initial state (and the denoise-to-zero output if requested).  eps:
    [num_steps-1, B, ...] per-step gradients.  None unless requested."""

    x: torch.Tensor
    xs: Optional[torch.Tensor] = None
    eps: Optional[torch.Tensor] = None


def dynamic_thresholding(x0: torch.Tensor, p: float = 0.995) -> torch.Tensor:
    """Imagen-style dynamic thresholding: clip each sample at the p-quantile
    of its |x0| (at least 1) and divide by it."""
    s = torch.quantile(x0.abs().reshape(x0.shape[0], -1), p, dim=1)
    s = s.clamp_min(1.0).reshape((-1,) + (1,) * (x0.dim() - 1))
    return torch.clamp(x0, -s, s) / s


def _as_dtype(values, dtype) -> List[float]:
    """float64 host values rounded to the working dtype, as Python floats."""
    return torch.as_tensor(np.asarray(values, np.float64)).to(dtype).double().tolist()


def _prepare(latents, t_steps, dtype):
    """x0 and the schedule as a device tensor of ``dtype``."""
    t = torch.tensor(_as_dtype(t_steps, dtype), dtype=dtype, device=latents.device)
    return latents.to(dtype) * t[0], t


def _eps_from(denoise: Denoiser, x, t, afs: bool):
    """d = (x - D(x, t)) / t, or the analytic first step under AFS."""
    if afs:
        return x / (1.0 + t ** 2).sqrt()
    return (x - denoise(x, t)) / t


def _finalize(denoise, x, t_last, xs, eps, denoise_to_zero, return_inters):
    if denoise_to_zero:
        x = denoise(x, t_last)
        if return_inters:
            xs.append(x)
    if not return_inters:
        return SampleResult(x=x)
    return SampleResult(x=x, xs=torch.stack(xs), eps=torch.stack(eps) if eps else None)


def _lms_sample(denoise: Denoiser, latents, t_steps, C, *, afs=False,
                denoise_to_zero=False, return_inters=False, dtype=torch.float32):
    """x_{i+1} = x_i + C[i,0] d_i + C[i,1] d_{i-1} + C[i,2] d_{i-2} + C[i,3] d_{i-3}."""
    x, t = _prepare(latents, t_steps, dtype)
    coeffs = [_as_dtype(row, dtype) for row in np.asarray(C)]
    hist: List[torch.Tensor] = []  # d_{i-1}, d_{i-2}, ... newest first
    xs, eps = [x], []
    for i, c in enumerate(coeffs):
        d = _eps_from(denoise, x, t[i], afs and i == 0)
        x_new = x + c[0] * d
        for ck, dk in zip(c[1:], hist):
            if ck != 0.0:
                x_new = x_new + ck * dk
        hist = [d] + hist[: multistep.MAX_LMS_ORDER - 2]
        x = x_new
        if return_inters:
            xs.append(x)
            eps.append(d)
    return _finalize(denoise, x, t[-1], xs, eps, denoise_to_zero, return_inters)


def euler_sampler(denoise, latents, t_steps, *, afs=False, denoise_to_zero=False,
                  return_inters=False, dtype=torch.float32, **_):
    """Euler / DDIM sampler."""
    return _lms_sample(denoise, latents, t_steps, multistep.euler_coeffs(t_steps),
                       afs=afs, denoise_to_zero=denoise_to_zero,
                       return_inters=return_inters, dtype=dtype)


def ipndm_sampler(denoise, latents, t_steps, *, max_order=4, afs=False,
                  denoise_to_zero=False, return_inters=False, dtype=torch.float32, **_):
    """Improved PNDM: fixed-step Adams-Bashforth."""
    return _lms_sample(denoise, latents, t_steps, multistep.ipndm_coeffs(t_steps, max_order),
                       afs=afs, denoise_to_zero=denoise_to_zero,
                       return_inters=return_inters, dtype=dtype)


def ipndm_v_sampler(denoise, latents, t_steps, *, max_order=4, afs=False,
                    denoise_to_zero=False, return_inters=False, dtype=torch.float32, **_):
    """Variable-step Adams-Bashforth."""
    return _lms_sample(denoise, latents, t_steps,
                       multistep.ipndm_v_coeffs(t_steps, max_order),
                       afs=afs, denoise_to_zero=denoise_to_zero,
                       return_inters=return_inters, dtype=dtype)


def deis_sampler(denoise, latents, t_steps, *, max_order=4, deis_mode="tab", coeffs=None,
                 afs=False, denoise_to_zero=False, return_inters=False, dtype=torch.float32,
                 **_):
    """DEIS exponential integrator in the eps-space LMS form; ``coeffs``: a
    precomputed ``multistep.deis_coeffs`` stack for ``t_steps``."""
    if coeffs is None:
        coeffs = multistep.deis_coeffs(t_steps, max_order, deis_mode=deis_mode)
    return _lms_sample(denoise, latents, t_steps, coeffs, afs=afs,
                       denoise_to_zero=denoise_to_zero, return_inters=return_inters,
                       dtype=dtype)


def _two_eval_sample(denoise, latents, t_steps, t_mid, w_cur, w_mid, *, afs,
                     denoise_to_zero, return_inters, dtype):
    """Single-step solvers with two denoiser calls per step:

    x_e   = x + (t_mid - t_cur) * d_cur
    d_mid = (x_e - D(x_e, t_mid)) / t_mid
    x'    = x + (t_next - t_cur) * (w_cur * d_cur + w_mid * d_mid)
    """
    x, t = _prepare(latents, t_steps, dtype)
    t_mid = torch.tensor(_as_dtype(t_mid, dtype), dtype=dtype, device=latents.device)
    xs, eps = [x], []
    for i in range(len(t_mid)):
        d = _eps_from(denoise, x, t[i], afs and i == 0)
        x_e = x + (t_mid[i] - t[i]) * d
        d_mid = (x_e - denoise(x_e, t_mid[i])) / t_mid[i]
        x = x + (t[i + 1] - t[i]) * (w_cur * d + w_mid * d_mid)
        if return_inters:
            xs.append(x)
            eps.append(d)
    return _finalize(denoise, x, t[-1], xs, eps, denoise_to_zero, return_inters)


def heun_sampler(denoise, latents, t_steps, *, afs=False, denoise_to_zero=False,
                 return_inters=False, dtype=torch.float32, **_):
    """EDM's Heun second-order sampler: t_mid = t_next, equal weights."""
    t = np.asarray(t_steps, dtype=np.float64)
    return _two_eval_sample(denoise, latents, t_steps, t[1:], 0.5, 0.5, afs=afs,
                            denoise_to_zero=denoise_to_zero,
                            return_inters=return_inters, dtype=dtype)


def dpm_2_sampler(denoise, latents, t_steps, *, r=0.5, afs=False, denoise_to_zero=False,
                  return_inters=False, dtype=torch.float32, **_):
    """DPM-Solver-2 with the geometric midpoint t_mid = t_next^r * t_cur^(1-r)."""
    t = np.asarray(t_steps, dtype=np.float64)
    t_mid = t[1:] ** r * t[:-1] ** (1.0 - r)
    return _two_eval_sample(denoise, latents, t_steps, t_mid, 1.0 - 1.0 / (2.0 * r),
                            1.0 / (2.0 * r), afs=afs, denoise_to_zero=denoise_to_zero,
                            return_inters=return_inters, dtype=dtype)


def dpm_pp_sampler(denoise, latents, t_steps, *, max_order=3, predict_x0=True,
                   lower_order_final=True, afs=False, denoise_to_zero=False,
                   return_inters=False, dtype=torch.float32, coeffs=None, **_):
    """DPM-Solver++ multistep: x_{i+1} = A[i] x_i + B[i,0] m_i + B[i,1] m_{i-1}
    + B[i,2] m_{i-2}, where m is the thresholded data prediction
    (``predict_x0``) or the gradient d.  ``coeffs``: a precomputed
    ``multistep.dpm_pp_coeffs`` for ``t_steps`` (the GITS AFS search hands
    one in per candidate schedule)."""
    co = (coeffs if coeffs is not None else
          multistep.dpm_pp_coeffs(t_steps, max_order, predict_x0, lower_order_final))
    x, t = _prepare(latents, t_steps, dtype)
    a_row = _as_dtype(co.A, dtype)
    b_rows = [_as_dtype(row, dtype) for row in np.asarray(co.B)]
    hist: List[torch.Tensor] = []  # m_{i-1}, m_{i-2}, newest first
    xs, eps = [x], []
    for i, (a, b) in enumerate(zip(a_row, b_rows)):
        d = _eps_from(denoise, x, t[i], afs and i == 0)
        m0 = dynamic_thresholding(x - t[i] * d) if predict_x0 else d
        x_new = a * x + b[0] * m0
        for bk, mk in zip(b[1:], hist):
            if bk != 0.0:
                x_new = x_new + bk * mk
        hist = [m0] + hist[:1]
        x = x_new
        if return_inters:
            xs.append(x)
            eps.append(d)
    return _finalize(denoise, x, t[-1], xs, eps, denoise_to_zero, return_inters)


def unipc_sampler(denoise, latents, t_steps, *, max_order=3, predict_x0=True,
                  lower_order_final=True, variant="bh2", afs=False, denoise_to_zero=False,
                  return_inters=False, dtype=torch.float32, coeffs=None, **_):
    """UniPC predictor-corrector (``variant`` bh1 / bh2).  The history holds
    model outputs m (the thresholded data prediction, or d), newest first,
    seeded with m at t_0.  Each step predicts x_pred from the history; where
    ``use_corrector`` holds (every step but the last under
    ``lower_order_final``), the model output at (x_pred, t_next) corrects it
    and becomes the next step's newest history entry, so a step costs one
    denoiser call either way.  ``coeffs``: a precomputed
    ``multistep.unipc_coeffs`` for ``t_steps``.  ``return_inters`` records
    the states only (``eps`` is None), as the JAX sampler does."""
    co = (coeffs if coeffs is not None else
          multistep.unipc_coeffs(t_steps, max_order, predict_x0, lower_order_final, variant))
    x, t = _prepare(latents, t_steps, dtype)
    t_next = torch.tensor(_as_dtype(co.t_next, dtype), dtype=dtype, device=latents.device)
    alpha, h_phi_1, b_h, rhos_c_last = (_as_dtype(v, dtype) for v in (
        co.alpha, co.h_phi_1, co.B_h, co.rhos_c_last))
    inv_rks, rhos_p, rhos_c = ([_as_dtype(row, dtype) for row in np.asarray(v)]
                               for v in (co.inv_rks, co.rhos_p, co.rhos_c))

    def model_out(x_val, t_val, afs_step):
        d = _eps_from(denoise, x_val, t_val, afs_step)
        return dynamic_thresholding(x_val - t_val * d) if predict_x0 else d

    def combine(weights, d1s):
        out = None
        for w, d1 in zip(weights, d1s):
            if w != 0.0:
                out = w * d1 if out is None else out + w * d1
        return out

    hist = [model_out(x, t[0], afs)]  # m at t_0, then newest first
    xs = [x]
    for i in range(len(co.t_next)):
        m0 = hist[0]
        # D1s_k = (m_{k+1} - m_0) / r_k over the history the step's order uses
        d1s = [(m - m0) * r for m, r in zip(hist[1:], inv_rks[i]) if r != 0.0]
        scale = 1.0 if predict_x0 else t_next[i]
        x_t_ = alpha[i] * x - scale * h_phi_1[i] * m0
        pred = combine(rhos_p[i], d1s)
        x_pred = x_t_ if pred is None else x_t_ - scale * b_h[i] * pred
        if co.use_corrector[i]:
            if predict_x0:
                model_t = dynamic_thresholding(denoise(x_pred, t_next[i]))
            else:
                model_t = (x_pred - denoise(x_pred, t_next[i])) / t_next[i]
            corr = rhos_c_last[i] * (model_t - m0)
            extra = combine(rhos_c[i], d1s)
            if extra is not None:
                corr = extra + corr
            x = x_t_ - scale * b_h[i] * corr
        else:
            x, model_t = x_pred, m0
        hist = [model_t] + hist[:2]
        if return_inters:
            xs.append(x)
    return _finalize(denoise, x, t[-1], xs, [], denoise_to_zero, return_inters)


SOLVER_REGISTRY = {
    "euler": euler_sampler,
    "heun": heun_sampler,
    "dpm": dpm_2_sampler,
    "ipndm": ipndm_sampler,
    "ipndm_v": ipndm_v_sampler,
    "deis": deis_sampler,
    "dpmpp": dpm_pp_sampler,
    "unipc": unipc_sampler,
}


def get_sampler(name: str):
    try:
        return SOLVER_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown solver {name!r}; "
                         f"available: {sorted(SOLVER_REGISTRY)}") from None


def count_nfe(solver: str, num_steps: int, afs: bool = False,
              denoise_to_zero: bool = False, cfg_doubled: bool = False) -> int:
    """Denoiser evaluations of one sampling run, by the reference's
    convention (``diff-solvers-main/sample.py:210-219``)."""
    if solver in ("dpm", "heun"):
        nfe = 2 * (num_steps - 1) - 1 if afs else 2 * (num_steps - 1)
    else:
        nfe = num_steps - 2 if afs else num_steps - 1
    if denoise_to_zero:
        nfe += 1
    return 2 * nfe if cfg_doubled else nfe
