"""Preconditioners and the bound denoiser the samplers consume.

Counterpart of ``diff_sampler_tpu/models/precond.py``: ``EDMPrecond`` over
SongUNet or DhariwalUNet, ``CFGPrecond`` (the latent tiers' discrete-time
wrapper, with its ``interpolate_fn`` sigma maps), ``BoundDenoiser`` and
``bind``.  The CM and CG preconditioners come with the ADM / CM 256 px tier.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .unets import DhariwalUNet, SongUNet

__all__ = ["EDMPrecond", "CFGPrecond", "BoundDenoiser", "bind", "interpolate_fn"]

MODEL_TYPES = {"SongUNet": SongUNet, "DhariwalUNet": DhariwalUNet}


class EDMPrecond(nn.Module):
    """EDM c_skip / c_out / c_in / c_noise preconditioning on NHWC images.

    ``dtype`` is the inner model's compute dtype (its parameters stay f32
    and are cast per layer); the preconditioning math stays f32."""

    def __init__(self, img_resolution: int, img_channels: int, label_dim: int = 0,
                 sigma_min: float = 0.002, sigma_max: float = 80.0, sigma_data: float = 0.5,
                 model_type: str = "SongUNet", model_kwargs: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if model_type not in MODEL_TYPES:
            raise NotImplementedError(f"model_type {model_type!r} is not ported yet")
        self.img_resolution, self.img_channels = img_resolution, img_channels
        self.label_dim = label_dim
        self.sigma_min, self.sigma_max, self.sigma_data = sigma_min, sigma_max, sigma_data
        self.dtype = dtype
        self.model = MODEL_TYPES[model_type](
            img_resolution=img_resolution, in_channels=img_channels,
            out_channels=img_channels, label_dim=label_dim, device=device,
            **(model_kwargs or {}))

    def forward(self, x, sigma, class_labels=None):
        """x: [N, H, W, C]; sigma: a scalar or [N] (float or tensor);
        class_labels: one-hot [N, label_dim] or [1, label_dim], or None.  As
        in the JAX package, an unconditional net ignores them and a
        conditional one takes None as a zero one-hot row for every sample."""
        return self._precondition(x, sigma, class_labels, None)

    def with_bottleneck(self, x, sigma, module_name: str, class_labels=None):
        """(D(x, sigma), the raw output activation of the inner model's
        encoder layer ``module_name``, a JAX module name such as
        ``enc_8x8_block3``): the AMED predictor's input tap."""
        return self._precondition(x, sigma, class_labels, module_name)

    def _labels(self, class_labels, device):
        if self.label_dim == 0:
            return None
        if class_labels is None:
            return torch.zeros((1, self.label_dim), dtype=torch.float32, device=device)
        return class_labels.float().reshape(-1, self.label_dim)

    def _precondition(self, x, sigma, class_labels, bottleneck):
        x = x.float()
        class_labels = self._labels(class_labels, x.device)
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1, 1, 1, 1)
        sd = self.sigma_data
        c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
        c_out = sigma * sd / (sigma ** 2 + sd ** 2).sqrt()
        c_in = 1 / (sd ** 2 + sigma ** 2).sqrt()
        c_noise = sigma.log() / 4
        f_x = self.model((c_in * x).to(self.dtype), c_noise.reshape(-1), class_labels,
                         bottleneck=bottleneck)
        if bottleneck is None:
            return c_skip * x + c_out * f_x.float()
        f_x, tap = f_x
        return c_skip * x + c_out * f_x.float(), tap


def interpolate_fn(x, xp, yp):
    """Piecewise-linear interpolation with linear extrapolation at the ends
    (the reference's ``CFGPrecond.interpolate_fn``), elementwise in f32.
    x: [N]; xp, yp: [K] keypoints with xp ascending, on x's device."""
    x = x.reshape(-1)
    k = xp.shape[0]
    lo = (torch.searchsorted(xp, x) - 1).clamp(0, k - 2)
    x0, x1, y0, y1 = xp[lo], xp[lo + 1], yp[lo], yp[lo + 1]
    # zero-width segments (duplicate f32 keypoints) give a zero fraction, not 0/0
    denom = x1 - x0
    frac = torch.where(denom == 0, torch.zeros_like(x),
                       (x - x0) / torch.where(denom == 0, torch.ones_like(denom), denom))
    return y0 + frac * (y1 - y0)


@dataclasses.dataclass
class CFGPrecond:
    """The LDM / Stable-Diffusion wrapper with optional classifier-free
    guidance (the reference's ``CFGPrecond``): D(x, sigma) = x - sigma *
    eps(x / sqrt(sigma^2 + 1), t(sigma)), the discrete time t(sigma) and its
    inverse piecewise-linear in the checkpoint's alphas_cumprod table.

    ``model_fn(x_scaled, t_input, cond)`` predicts eps;
    ``model_fn_bottleneck`` returns (eps, the U-Net's middle-block output).
    ``latent_diffusion`` is the module they run (the factory sets it): bind
    and the AMED tap check its eval mode and freeze it.  ``sigma`` and
    ``sigma_inv`` take a tensor (any device, kept differentiable) or numpy
    (computed on the CPU, numpy out), both in f32 as in the JAX package."""

    model_fn: Callable
    alphas_cumprod: np.ndarray
    img_resolution: int = 64
    img_channels: int = 4
    guidance_type: str = "classifier-free"
    guidance_rate: float = 1.0
    epsilon_t: float = 1e-3
    label_dim: int = 1
    model_fn_bottleneck: Optional[Callable] = None
    latent_diffusion: Optional[nn.Module] = None

    def __post_init__(self):
        log_alphas = 0.5 * np.log(np.asarray(self.alphas_cumprod, np.float64))
        self.M = len(log_alphas)
        self._tables = {}  # device -> (t_array, log_alpha_array), f32
        self._host = (torch.tensor(np.linspace(0.0, 1.0, self.M + 1)[1:], dtype=torch.float32),
                      torch.tensor(log_alphas, dtype=torch.float32))
        self.sigma_min = float(self.sigma(np.float64(self.epsilon_t)).reshape(()))
        self.sigma_max = float(self.sigma(np.float64(1.0)).reshape(()))

    def _on(self, device):
        if device not in self._tables:
            self._tables[device] = tuple(t.to(device) for t in self._host)
        return self._tables[device]

    def _map(self, fn, v):
        if isinstance(v, torch.Tensor):
            return fn(v.float(), *self._on(v.device))
        return fn(torch.tensor(np.asarray(v), dtype=torch.float32), *self._host).numpy()

    def sigma(self, t):
        def fn(t, ta, la):
            log_a = interpolate_fn(t, ta, la)
            return torch.sqrt(1.0 - torch.exp(2.0 * log_a)) / torch.exp(log_a)

        return self._map(fn, t)

    def sigma_inv(self, sigma):
        def fn(s, ta, la):
            lamb = -torch.log(s)
            log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb), -2.0 * lamb)
            # log_alpha_array descends in t: flip it for an ascending interpolation
            return interpolate_fn(log_alpha, la.flip(0), ta.flip(0))

        return self._map(fn, sigma)

    @property
    def training(self) -> bool:
        return self.latent_diffusion is not None and self.latent_diffusion.training

    def __call__(self, x, sigma, condition=None, unconditional_condition=None):
        return self._denoise(x, sigma, condition, unconditional_condition, self.model_fn)[0]

    def denoise_with(self, model_fn, x, sigma, condition=None, unconditional_condition=None):
        """The same preconditioning through an explicit ``model_fn`` (a
        trainable latent student)."""
        return self._denoise(x, sigma, condition, unconditional_condition, model_fn)[0]

    def with_bottleneck(self, x, sigma, condition=None, unconditional_condition=None):
        """(D(x, sigma), the raw middle-block activation) for AMED; under
        doubled-batch guidance the activation stays doubled."""
        if self.model_fn_bottleneck is None:
            raise ValueError("build the model with bottleneck capture (models.factory)")
        return self._denoise(x, sigma, condition, unconditional_condition, None,
                             model_fn_b=self.model_fn_bottleneck)

    def _denoise(self, x, sigma, condition, unconditional_condition, model_fn, model_fn_b=None):
        def call(xs, ts, cs):
            if model_fn_b is not None:
                return model_fn_b(xs, ts, cs)
            return model_fn(xs, ts, cs), None

        sigma_flat = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1)
        shape = (-1,) + (1,) * (x.dim() - 1)
        c_in = (1.0 / torch.sqrt(sigma_flat ** 2 + 1.0)).reshape(shape)
        c_out = (-sigma_flat).reshape(shape)
        c_noise = self.M * self.sigma_inv(sigma_flat) - 1.0
        if c_noise.shape[0] == 1:
            c_noise = c_noise.expand(x.shape[0])

        def bcast(c):
            # one bound conditioning row serves the whole batch
            if c is not None and c.shape[0] == 1 and x.shape[0] != 1:
                return c.expand((x.shape[0],) + tuple(c.shape[1:]))
            return c

        condition = bcast(condition)
        unconditional_condition = bcast(unconditional_condition)
        if self.guidance_type == "uncond":
            f_x, act = call(c_in * x, c_noise, None)
        elif self.guidance_type == "classifier-free":
            if self.guidance_rate == 1.0 or unconditional_condition is None:
                f_x, act = call(c_in * x, c_noise, condition)
            else:
                out, act = call(torch.cat([c_in * x] * 2), torch.cat([c_noise] * 2),
                                torch.cat([unconditional_condition, condition]))
                noise_uncond, noise = out.chunk(2)
                f_x = noise_uncond + self.guidance_rate * (noise - noise_uncond)
        else:
            raise ValueError(self.guidance_type)
        return x + c_out * f_x, act


@dataclasses.dataclass
class BoundDenoiser:
    """``denoise(x, t) -> D(x, t)``, the callable the samplers take; a
    ``bind``-ed net also takes ``denoise(x, t, c)``, c the class labels or a
    CFGPrecond's condition (``sampling.generate`` calls it so with each
    batch's labels or per-seed rows).
    ``sigma_fn`` / ``sigma_inv_fn``: a discrete-time net's sigma maps, which
    its ``discrete`` schedule needs (None for an EDM net)."""

    fn: Callable
    sigma_min: float
    sigma_max: float
    sigma_fn: Optional[Callable] = None
    sigma_inv_fn: Optional[Callable] = None

    def __call__(self, x, t, *cond):
        return self.fn(x, t, *cond)


def bind(precond, class_labels=None, **cond) -> BoundDenoiser:
    """The sampling denoiser of a preconditioner: its forward, run without
    autograd.  EDMPrecond: with ``class_labels`` bound (None: a conditional
    net gets zero one-hot rows, as in the JAX package); labels passed to
    the call replace them.  CFGPrecond: with its conditioning keywords
    (``condition=``, ``unconditional_condition=``) bound and its sigma maps
    carried; a condition passed to the call (``generate``'s per-seed rows)
    replaces the bound one.  The module must be in eval mode, so that
    dropout is off."""
    if precond.training:
        raise ValueError("bind() needs the module in eval mode: call .eval() first")
    if isinstance(precond, CFGPrecond):
        @torch.no_grad()
        def cfg_fn(x, t, condition=None):
            if condition is None:
                return precond(x, t, **cond)
            return precond(x, t, **{**cond, "condition": condition})

        return BoundDenoiser(cfg_fn, precond.sigma_min, precond.sigma_max, precond.sigma,
                             precond.sigma_inv)

    bound = class_labels

    @torch.no_grad()
    def fn(x, t, class_labels=None):
        return precond(x, t, bound if class_labels is None else class_labels)

    return BoundDenoiser(fn, precond.sigma_min, precond.sigma_max)
