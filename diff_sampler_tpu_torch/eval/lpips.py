"""LPIPS perceptual distance on a VGG16 backbone.

Counterpart of ``diff_sampler_tpu/eval/lpips.py``, which stands in for
``piq.LPIPS(replace_pooling=True, reduction='none')`` in the SFD
second-stage loss (``sfd-main/training/loss.py:130-135``): inputs in [-1, 1]
NHWC go to [0, 1], are resized to ``resize_to`` by ``jax.image.resize``'s
bilinear (half-pixel centres, antialiased where an axis shrinks;
``eval.inception.resize_nhwc``) and ImageNet-normalised, then pass through
VGG16's 13 convs with ReLU, average pools in place of its max pools
(``replace_pooling=True``); the features after the last ReLU of each of
the 5 stages are unit-normalised over channels (``+ 1e-10``), their squared
differences weighted by ``|lin_i|``, summed over channels, averaged over H
and W and summed over the stages: one distance per image.

Parameters carry the names of their usual sources, so those state_dicts
load as they are (``load_lpips_weights``): torchvision's VGG16
``features.{0,2,5,7,10,12,14,17,19,21,24,26,28}.weight`` / ``.bias`` and
the LPIPS heads ``lin{i}.model.1.weight`` [1, C, 1, 1].
``models.convert.lpips_state_dict_from_jax`` carries the JAX package's
param tree over.  The convs are cuDNN's on the card (the JAX package runs
them as XLA convs: no Pallas kernel); x and y go through the backbone as
one batch.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .inception import resize_nhwc

__all__ = ["LPIPS", "VGG_CONV_INDICES", "load_lpips_weights"]

# VGG16: (out_channels, convs) per stage; the stage's features are tapped
# after its last ReLU (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
_VGG_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# torchvision's ``vgg16().features`` indices of the 13 convs
VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class LPIPS(nn.Module):
    """``lpips(x, y)``: [B] perceptual distances of x, y [B, H, W, 3] in
    [-1, 1].  The convs start at torch's default init: load the weights
    (``load_lpips_weights``, ``load_state_dict``) before use.  Built on
    ``device``: the card unless the caller passes ``device="cpu"``."""

    def __init__(self, resize_to: int = 224, device="cuda"):
        super().__init__()
        self.resize_to = resize_to
        self.features = nn.ModuleDict()
        cin, idx = 3, iter(VGG_CONV_INDICES)
        for ch, n in _VGG_PLAN:
            for _ in range(n):
                self.features[str(next(idx))] = nn.Conv2d(cin, ch, 3, padding=1, device=device)
                cin = ch
        for i, (ch, _) in enumerate(_VGG_PLAN):
            # the LPIPS head's layout: model = (dropout, 1x1 conv C -> 1, no bias)
            setattr(self, f"lin{i}", nn.Module())
            getattr(self, f"lin{i}").model = nn.Sequential(
                nn.Identity(), nn.Conv2d(ch, 1, 1, bias=False, device=device))

    def _prep(self, v: torch.Tensor) -> torch.Tensor:
        v = (v + 1.0) / 2.0
        if v.shape[1] != self.resize_to:
            v = resize_nhwc(v, self.resize_to, self.resize_to, "bilinear")
        mean = torch.tensor(_MEAN, dtype=v.dtype, device=v.device)
        std = torch.tensor(_STD, dtype=v.dtype, device=v.device)
        return (v - mean) / std

    def _taps(self, x: torch.Tensor) -> list:
        """VGG16's 5 stage features of x (NCHW)."""
        taps, convs = [], iter(self.features.values())
        for stage, (_, n) in enumerate(_VGG_PLAN):
            for _ in range(n):
                x = F.relu(next(convs)(x))
            taps.append(x)
            if stage < len(_VGG_PLAN) - 1:
                x = F.avg_pool2d(x, 2, 2)  # replace_pooling=True
        return taps

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        both = torch.cat([self._prep(x.float()), self._prep(y.float())]).permute(0, 3, 1, 2)
        total = 0.0
        for i, f in enumerate(self._taps(both)):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            d = (f[:b] - f[b:]) ** 2  # [B, C, H, W]
            w = getattr(self, f"lin{i}").model[1].weight.reshape(1, -1, 1, 1).abs()
            total = total + (d * w).sum(1).mean(dim=(1, 2))
        return total


def load_lpips_weights(lpips: LPIPS, vgg_state_dict: Mapping[str, torch.Tensor],
                       lin_state_dict: Mapping[str, torch.Tensor]) -> LPIPS:
    """Load torchvision's VGG16 weights (a ``vgg16()`` state_dict: its
    ``features.*`` convs; the classifier is not used) and the LPIPS heads
    (``lin{i}.model.1.weight``) into ``lpips`` in place, strictly: every
    conv and head must be there with its shape.  The counterpart of the JAX
    package's ``lpips_params_from_torch``."""
    sd = {}
    for i in VGG_CONV_INDICES:
        for leaf in ("weight", "bias"):
            sd[f"features.{i}.{leaf}"] = vgg_state_dict[f"features.{i}.{leaf}"]
    for i in range(len(_VGG_PLAN)):
        sd[f"lin{i}.model.1.weight"] = lin_state_dict[f"lin{i}.model.1.weight"]
    lpips.load_state_dict({k: v.float() for k, v in sd.items()})
    return lpips
