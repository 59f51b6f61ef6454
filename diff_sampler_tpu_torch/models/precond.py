"""EDM preconditioning and the bound denoiser the samplers consume.

Counterpart of ``diff_sampler_tpu/models/precond.py`` (``EDMPrecond`` over
SongUNet or DhariwalUNet, ``BoundDenoiser``, ``bind``).  The other
preconditioners (CM, CG, CFG) come with their model tiers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .unets import DhariwalUNet, SongUNet

__all__ = ["EDMPrecond", "BoundDenoiser", "bind"]

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


@dataclasses.dataclass
class BoundDenoiser:
    """``denoise(x, t) -> D(x, t)``, the callable the samplers take; the
    ``bind`` of a conditional net also takes ``denoise(x, t, class_labels)``
    (``sampling.generate`` calls it so with each batch's labels)."""

    fn: Callable
    sigma_min: float
    sigma_max: float

    def __call__(self, x, t, *cond):
        return self.fn(x, t, *cond)


def bind(precond: EDMPrecond, class_labels=None) -> BoundDenoiser:
    """The sampling denoiser of a preconditioner: its forward, run without
    autograd, with ``class_labels`` bound (None: a conditional net gets zero
    one-hot rows, as in the JAX package).  The module must be in eval mode,
    so that dropout is off."""
    if precond.training:
        raise ValueError("bind() needs the module in eval mode: call .eval() first")

    bound = class_labels

    @torch.no_grad()
    def fn(x, t, class_labels=None):
        return precond(x, t, bound if class_labels is None else class_labels)

    return BoundDenoiser(fn, precond.sigma_min, precond.sigma_max)
