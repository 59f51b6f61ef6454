"""Layers of the guided-diffusion (ADM) family that the latent U-Net shares,
on NHWC activations.

Counterpart of the shared part of ``diff_sampler_tpu/models/adm.py``:
``timestep_embedding``, GroupNorm32 (``_GN``), ``_Conv``, ``_Linear`` and
``legacy_attention``.  ``ADMUNet`` and the classifier come with the ADM / CM
256 px tier.  Parameters use the reference's state_dict layouts: conv weights
OIHW (1x1 convs too, where the reference's attention uses Conv1d), linear
weights (out, in), norm ``weight``/``bias``.  They are allocated
uninitialised; ``factory.init_params`` draws them (LeCun normal, zero biases,
unit norms, as the JAX modules' initialisers).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa
from ..ops.groupnorm import groupnorm_silu

__all__ = ["timestep_embedding", "legacy_attention"]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """guided-diffusion's [cos | sin] embedding with exp-spaced frequencies,
    in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator) / math.sqrt(fan_in)


class _GN(nn.Module):
    """GroupNorm32: 32 groups, f32 statistics, through ``groupnorm_silu``
    (kernel K3 on the card).  ``apply_silu`` fuses the SiLU that the JAX
    code applies to the norm's output."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, apply_silu: bool = False):
        return groupnorm_silu(x, self.weight, self.bias, groups=32, eps=self.eps,
                              apply_silu=apply_silu)


class _Conv(nn.Module):
    """kernel x kernel conv with symmetric padding kernel // 2, NHWC in and
    out (a channels-last NCHW view for cuDNN), in the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        self.weight.copy_(_lecun_normal(self.weight.shape, fan_in, generator))
        self.bias.zero_()

    def forward(self, x):
        w = self.weight.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias.to(x.dtype), stride=self.stride,
                     padding=w.shape[-1] // 2)
        return y.permute(0, 2, 3, 1)


class _Linear(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.copy_(_lecun_normal(self.weight.shape, self.weight.shape[1], generator))
        self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def legacy_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """QKVAttentionLegacy: channels laid out as (head, 3 * ch), the scale
    1/sqrt(ch), an f32 softmax.  q, k and v are strided views of the [N, T,
    heads, 3 * ch] projection, handed to ``sdpa`` (kernels K1 / K2 on the card)
    as they are.  qkv: [N, T, 3C]; returns [N, T, C]."""
    n, t, w = qkv.shape
    ch = w // (3 * num_heads)
    parts = qkv.reshape(n, t, num_heads, 3 * ch)
    q, k, v = parts[..., :ch], parts[..., ch:2 * ch], parts[..., 2 * ch:]
    out = sdpa(q, k, v, scale=1.0 / math.sqrt(ch))
    return out.reshape(n, t, num_heads * ch)
