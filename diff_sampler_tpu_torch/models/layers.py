"""Layer primitives of the EDM-family U-Nets, on NHWC activations.

Counterpart of ``diff_sampler_tpu/models/layers.py``.  Activations keep the
JAX package's NHWC layout, so the tests compare like with like and the
attention split below is the same strided view the JAX code takes.  A conv
sees the NHWC tensor as a channels-last NCHW view (a permute, no copy).
Parameters carry the reference state_dict names and layouts: conv weights
OIHW, linear weights (out, in), norm ``weight``/``bias``, and the
``resample_filter`` buffer of resampling convs.

Parameters are allocated uninitialised on ``device``;
``models.factory.init_params`` fills them from one seeded generator, and
``models.convert.load_jax_params`` loads JAX params into them.

``Linear`` and ``Conv2d`` also run as a tensor-parallel column or row shard,
and ``GroupNorm`` on a channel slice, once ``parallel/tp.py`` has cut them.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.groupnorm import groupnorm_silu
from ..parallel.tp import tp_input, tp_output

__all__ = [
    "weight_init",
    "Linear",
    "Conv2d",
    "GroupNorm",
    "attention",
    "positional_embedding",
    "FourierEmbedding",
    "dropout",
    "drop_labels",
]


def weight_init(shape, mode: str, fan_in: int, fan_out: int,
                generator: torch.Generator) -> torch.Tensor:
    """The reference's scaled uniform / normal initialisers, drawn on the CPU."""
    if mode == "xavier_uniform":
        return math.sqrt(6.0 / (fan_in + fan_out)) * (torch.rand(shape, generator=generator) * 2 - 1)
    if mode == "xavier_normal":
        return math.sqrt(2.0 / (fan_in + fan_out)) * torch.randn(shape, generator=generator)
    if mode == "kaiming_uniform":
        return math.sqrt(3.0 / fan_in) * (torch.rand(shape, generator=generator) * 2 - 1)
    if mode == "kaiming_normal":
        return math.sqrt(1.0 / fan_in) * torch.randn(shape, generator=generator)
    raise ValueError(f'Invalid init mode "{mode}"')


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init_mode: str = "kaiming_normal", init_weight: float = 1.0,
                 init_bias: float = 0.0, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.init_mode, self.init_weight, self.init_bias = init_mode, init_weight, init_bias
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device)) if bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        fans = (self.in_features, self.out_features)
        self.weight.copy_(weight_init(self.weight.shape, self.init_mode, *fans, generator)
                          * self.init_weight)
        if self.bias is not None:
            self.bias.copy_(weight_init(self.bias.shape, self.init_mode, *fans, generator)
                            * self.init_bias)

    def forward(self, x):
        x = tp_input(self, x)
        w = self.weight.to(x.dtype)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return tp_output(self, lambda bias: F.linear(x, w, bias), b)


class Conv2d(nn.Module):
    """Conv with optional 2x up/down-sampling by a separable resample filter
    (the reference's ``Conv2d``).  ``kernel=0`` gives a resample-only layer
    with no weights."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 up: bool = False, down: bool = False,
                 resample_filter: Sequence[float] = (1, 1), fused_resample: bool = False,
                 init_mode: str = "kaiming_normal", init_weight: float = 1.0,
                 init_bias: float = 0.0, device=None):
        if up and down:
            raise ValueError("Conv2d cannot both up- and down-sample")
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.up, self.down, self.fused_resample = up, down, fused_resample
        self.init_mode, self.init_weight, self.init_bias = init_mode, init_weight, init_bias
        self.weight = (nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel,
                                                device=device)) if kernel else None)
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) if kernel else None
        f = torch.as_tensor(resample_filter, dtype=torch.float32)
        f = f.ger(f)[None, None] / f.sum().square()
        self.register_buffer("resample_filter", f.to(device) if up or down else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.weight is None:
            return
        k = self.weight.shape[-1]
        fans = (self.in_channels * k * k, self.out_channels * k * k)
        self.weight.copy_(weight_init(self.weight.shape, self.init_mode, *fans, generator)
                          * self.init_weight)
        if self.bias is not None:
            self.bias.copy_(weight_init(self.bias.shape, self.init_mode, *fans, generator)
                            * self.init_bias)

    def forward(self, x):
        """x: [N, H, W, C] -> [N, H', W', C']."""
        x = tp_input(self, x).permute(0, 3, 1, 2)  # channels-last NCHW view
        w = self.weight.to(x.dtype) if self.weight is not None else None
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return tp_output(self, lambda bias: self._conv(x, w, bias), b)

    def _conv(self, x, w, b):
        f = self.resample_filter.to(x.dtype) if self.resample_filter is not None else None
        w_pad = w.shape[-1] // 2 if w is not None else 0
        f_pad = (f.shape[-1] - 1) // 2 if f is not None else 0
        # this rank's channels where the layer is a tensor-parallel shard
        cin = x.shape[1]
        cout = w.shape[0] if w is not None else cin

        if self.fused_resample and self.up and w is not None:
            x = F.conv_transpose2d(x, f.mul(4).tile([cin, 1, 1, 1]), groups=cin, stride=2,
                                   padding=max(f_pad - w_pad, 0))
            x = F.conv2d(x, w, padding=max(w_pad - f_pad, 0))
        elif self.fused_resample and self.down and w is not None:
            x = F.conv2d(x, w, padding=w_pad + f_pad)
            x = F.conv2d(x, f.tile([cout, 1, 1, 1]), groups=cout, stride=2)
        else:
            if self.up:
                x = F.conv_transpose2d(x, f.mul(4).tile([cin, 1, 1, 1]), groups=cin,
                                       stride=2, padding=f_pad)
            if self.down:
                x = F.conv2d(x, f.tile([cin, 1, 1, 1]), groups=cin, stride=2, padding=f_pad)
            if w is not None:
                x = F.conv2d(x, w, padding=w_pad)
        x = x.permute(0, 2, 3, 1)
        return x if b is None else x + b


class GroupNorm(nn.Module):
    """GroupNorm over NHWC with the reference's group count
    ``min(num_groups, C // min_channels_per_group)``."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 min_channels_per_group: int = 4, eps: float = 1e-5, device=None):
        super().__init__()
        self.num_groups = min(num_groups, num_channels // min_channels_per_group)
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_channels, device=device))
        self.bias = nn.Parameter(torch.empty(num_channels, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return groupnorm_silu(x, self.weight, self.bias, groups=self.num_groups,
                              eps=self.eps, apply_silu=False)


def attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention with an f32 softmax.

    qkv: [N, H, W, 3*C] from a 1x1 conv whose output channel factors as
    (head, c_per_head, qkv), the reference's interleaved layout; q, k and v
    are strided views of it.  Returns [N, H, W, C]."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    ch = c // num_heads
    q, k, v = qkv.reshape(n, h * w, num_heads, ch, 3).unbind(-1)  # [N, HW, heads, ch]
    out = sdpa(q, k, v, scale=1.0 / math.sqrt(ch))
    return out.reshape(n, h, w, c)


def _keep_mask(shape, keep: float, generator, device) -> torch.Tensor:
    """Bernoulli(``keep``) draws of ``shape`` from ``generator``: uniform <
    keep, as ``jax.random.bernoulli`` draws them."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """Flax's ``nn.Dropout`` with ``deterministic=False``: each element kept
    with probability 1 - rate and scaled by 1 / (1 - rate), else zero; x as
    it is at rate 0, zeros at rate 1."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    return torch.where(_keep_mask(x.shape, keep, generator, x.device), x / keep,
                       torch.zeros_like(x))


def drop_labels(labels: torch.Tensor, rate: float, n: int, generator=None) -> torch.Tensor:
    """Label dropout (``deterministic=False``): ``labels`` times a keep mask
    [n, 1] drawn with probability 1 - rate per sample."""
    if rate <= 0.0:
        return labels
    return labels * _keep_mask((n, 1), 1.0 - rate, generator, labels.device).to(labels.dtype)


def positional_embedding(x: torch.Tensor, num_channels: int, max_positions: int = 10000,
                         endpoint: bool = False) -> torch.Tensor:
    """DDPM++/ADM timestep embedding: [cos | sin]."""
    freqs = torch.arange(num_channels // 2, dtype=torch.float32, device=x.device)
    freqs = freqs / (num_channels // 2 - (1 if endpoint else 0))
    freqs = (1.0 / max_positions) ** freqs
    ang = x[:, None].float() * freqs[None, :]
    return torch.cat([ang.cos(), ang.sin()], dim=1).to(x.dtype)


class FourierEmbedding(nn.Module):
    """NCSN++ random Fourier features; ``freqs`` is a buffer, as in the
    reference."""

    def __init__(self, num_channels: int, scale: float = 16.0, device=None):
        super().__init__()
        self.scale = scale
        self.register_buffer("freqs", torch.empty(num_channels // 2, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.freqs.copy_(torch.randn(self.freqs.shape, generator=generator) * self.scale)

    def forward(self, x):
        ang = 2 * np.pi * x[:, None].float() * self.freqs[None, :].float()
        return torch.cat([ang.cos(), ang.sin()], dim=1).to(x.dtype)
