"""Numpy emulation of the reference's diffusers AMED plugin.

The port's copy of ``diff_sampler_tpu/integrations/diffusers_emulation.py``
(it imports nothing of the JAX package; ``tests/test_torch_integrations.py``
holds the two bit for bit).  The reference ships
``diffusers_amed_plugin_dpmpp.py:27-439``, a ``DPMSolverMultistepScheduler``
subclass whose ``set_timesteps`` consumes the interleaved AMED timestep list
and scale_times (odd entries shifted to scale_time * sigma) and whose order
updates multiply the model-output terms by the per-step scale_dir.
diffusers is not installed, so this class re-implements exactly that
subclass's set_timesteps / step math (algorithm_type='dpmsolver++',
solver_type='midpoint', prediction_type='epsilon', thresholding off) for
the round trip: the port's AMED sampler and this emulator, driven by
``integrations.amed_export.export_amed_schedule``'s output, produce the same
images.

All arithmetic is float64 numpy, as the plugin's fp32-upcast step.
Citations in-line are to diffusers_amed_plugin_dpmpp.py.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["AMEDDPMSolverMultistepEmulator"]


class AMEDDPMSolverMultistepEmulator:
    """dpmsolver++/midpoint/epsilon emulation of the AMED plugin scheduler."""

    def __init__(self, alphas_cumprod: np.ndarray, solver_order: int = 2,
                 lower_order_final: bool = True, euler_at_final: bool = False):
        self.alphas_cumprod = np.asarray(alphas_cumprod, np.float64)
        self.solver_order = solver_order
        self.lower_order_final = lower_order_final
        self.euler_at_final = euler_at_final

    # -- set_timesteps (plugin :29-68) ------------------------------------
    def set_timesteps(self, timesteps: Sequence[int],
                      scale_dirs: Sequence[float],
                      scale_times: Sequence[float]) -> None:
        timesteps = list(int(t) for t in timesteps)
        self.scale_dirs = np.asarray(scale_dirs, np.float64)
        self.scale_times = np.asarray(scale_times, np.float64)
        all_sigmas = np.sqrt((1.0 - self.alphas_cumprod) / self.alphas_cumprod)
        self.sigmas = all_sigmas[timesteps]
        self.timesteps = np.asarray(timesteps[:-1], np.int64)  # drop final

        # odd-indexed eval times shifted to scale_time * sigma (plugin :54-58)
        for i in range(len(self.scale_times)):
            if i % 2 == 1:
                sigma_target = self.sigmas[i] * self.scale_times[i]
                lo, hi = timesteps[i + 1] + 1, timesteps[i - 1]
                sigmas_source = all_sigmas[lo:hi]
                self.timesteps[i] = lo + int(
                    np.argmin(np.abs(sigmas_source - sigma_target)))

        self.num_inference_steps = len(timesteps)
        self.model_outputs: List[Optional[np.ndarray]] = [None] * self.solver_order
        self.lower_order_nums = 0
        self._step_index = 0

    # -- helpers (DefaultDPMSolver) ----------------------------------------
    @staticmethod
    def _sigma_to_alpha_sigma_t(sigma):
        alpha_t = 1.0 / np.sqrt(sigma**2 + 1.0)
        return alpha_t, sigma * alpha_t

    def convert_model_output(self, model_output, sample):
        """epsilon -> x0 for dpmsolver++ (DefaultDPMSolver
        convert_model_output; thresholding off)."""
        sigma = self.sigmas[self._step_index]
        alpha_t, sigma_t = self._sigma_to_alpha_sigma_t(sigma)
        return (sample - sigma_t * model_output) / alpha_t

    # -- order updates (plugin :70-350) ------------------------------------
    def _first_order(self, m0, sample, scale_dir):
        sigma_t, sigma_s = self.sigmas[self._step_index + 1], self.sigmas[self._step_index]
        alpha_t, sigma_t = self._sigma_to_alpha_sigma_t(sigma_t)
        alpha_s, sigma_s = self._sigma_to_alpha_sigma_t(sigma_s)
        h = (np.log(alpha_t) - np.log(sigma_t)) - (np.log(alpha_s) - np.log(sigma_s))
        return (sigma_t / sigma_s) * sample - scale_dir * (
            alpha_t * (np.exp(-h) - 1.0)) * m0

    def _second_order(self, mlist, sample, scale_dir):
        sigma_t = self.sigmas[self._step_index + 1]
        sigma_s0 = self.sigmas[self._step_index]
        sigma_s1 = self.sigmas[self._step_index - 1]
        alpha_t, sigma_t = self._sigma_to_alpha_sigma_t(sigma_t)
        alpha_s0, sigma_s0 = self._sigma_to_alpha_sigma_t(sigma_s0)
        alpha_s1, sigma_s1 = self._sigma_to_alpha_sigma_t(sigma_s1)
        lam_t = np.log(alpha_t) - np.log(sigma_t)
        lam_s0 = np.log(alpha_s0) - np.log(sigma_s0)
        lam_s1 = np.log(alpha_s1) - np.log(sigma_s1)
        m0, m1 = mlist[-1], mlist[-2]
        h, h_0 = lam_t - lam_s0, lam_s0 - lam_s1
        r0 = h_0 / h
        d0, d1 = m0, (1.0 / r0) * (m0 - m1)
        # solver_type='midpoint' (plugin :205-211)
        return ((sigma_t / sigma_s0) * sample
                - scale_dir * (alpha_t * (np.exp(-h) - 1.0)) * d0
                - scale_dir * 0.5 * (alpha_t * (np.exp(-h) - 1.0)) * d1)

    def _third_order(self, mlist, sample, scale_dir):
        s = self.sigmas
        i = self._step_index
        sigma_t, sigma_s0, sigma_s1, sigma_s2 = s[i + 1], s[i], s[i - 1], s[i - 2]
        alpha_t, sigma_t = self._sigma_to_alpha_sigma_t(sigma_t)
        alpha_s0, sigma_s0 = self._sigma_to_alpha_sigma_t(sigma_s0)
        alpha_s1, sigma_s1 = self._sigma_to_alpha_sigma_t(sigma_s1)
        alpha_s2, sigma_s2 = self._sigma_to_alpha_sigma_t(sigma_s2)
        lam_t = np.log(alpha_t) - np.log(sigma_t)
        lam_s0 = np.log(alpha_s0) - np.log(sigma_s0)
        lam_s1 = np.log(alpha_s1) - np.log(sigma_s1)
        lam_s2 = np.log(alpha_s2) - np.log(sigma_s2)
        m0, m1, m2 = mlist[-1], mlist[-2], mlist[-3]
        h, h_0, h_1 = lam_t - lam_s0, lam_s0 - lam_s1, lam_s1 - lam_s2
        r0, r1 = h_0 / h, h_1 / h
        d0 = m0
        d1_0, d1_1 = (1.0 / r0) * (m0 - m1), (1.0 / r1) * (m1 - m2)
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
        return ((sigma_t / sigma_s0) * sample
                - scale_dir * (alpha_t * (np.exp(-h) - 1.0)) * d0
                + scale_dir * (alpha_t * ((np.exp(-h) - 1.0) / h + 1.0)) * d1
                - scale_dir * (alpha_t * ((np.exp(-h) - 1.0 + h) / h**2 - 0.5)) * d2)

    # -- step (plugin :352-439) --------------------------------------------
    def step(self, model_output: np.ndarray, sample: np.ndarray) -> np.ndarray:
        n = len(self.timesteps)
        lower_order_final = (self._step_index == n - 1) and (
            self.euler_at_final or (self.lower_order_final and n < 15))
        lower_order_second = ((self._step_index == n - 2)
                              and self.lower_order_final and n < 15)

        m = self.convert_model_output(np.asarray(model_output, np.float64),
                                      np.asarray(sample, np.float64))
        for i in range(self.solver_order - 1):
            self.model_outputs[i] = self.model_outputs[i + 1]
        self.model_outputs[-1] = m

        sample = np.asarray(sample, np.float64)
        scale_dir = self.scale_dirs[self._step_index]
        if (self.solver_order == 1 or self.lower_order_nums < 1
                or lower_order_final):
            prev = self._first_order(m, sample, scale_dir)
        elif (self.solver_order == 2 or self.lower_order_nums < 2
              or lower_order_second):
            prev = self._second_order(self.model_outputs, sample, scale_dir)
        else:
            prev = self._third_order(self.model_outputs, sample, scale_dir)

        if self.lower_order_nums < self.solver_order:
            self.lower_order_nums += 1
        self._step_index += 1
        return prev

    def sample(self, eps_model: Callable, x_init: np.ndarray) -> np.ndarray:
        """Run the full scheduler loop: eps_model(x_vp, t_index) -> eps."""
        x = np.asarray(x_init, np.float64)
        for t_idx in self.timesteps:
            eps = eps_model(x, int(t_idx))
            x = self.step(eps, x)
        return x
