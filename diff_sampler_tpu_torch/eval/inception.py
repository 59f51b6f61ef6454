"""The FID Inception-V3 feature extractor (2048-dim pool3 features).

Counterpart of ``diff_sampler_tpu/eval/inception.py``: the same network in
the "FID variant" form of the pytorch-fid lineage of the TF
``inception-2015-12-05`` graph (torchvision's InceptionV3 layout; average
pools that do not count the padding; a max-pool branch in the last block).
The module carries torchvision / pytorch-fid state_dict names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``, ...),
so such a state_dict loads by name once its classifier head and
``num_batches_tracked`` counters are dropped
(``import_inception_state_dict``).

Input: uint8 NHWC images of any resolution; the resize to 299 and the
scaling to [-1, 1] happen inside, as in the JAX module:
  * ``tf_preprocessing=True``: the TF1 asymmetric bilinear resize and
    ``(x - 128) / 128`` (the NVIDIA detector's input path);
  * the default: ``jax.image.resize(..., "bilinear")``, which antialiases
    where it shrinks (a triangle filter widened by the scale) and is plain
    half-pixel bilinear where it grows, then ``x / 127.5 - 1``.  The port
    builds the same per-axis weight matrices, so both directions match.

Every call computes in f32 with TF32 off in cuDNN and in matmuls, whatever
the caller's flags say (``exact_f32``); the flags are restored afterwards.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["InceptionV3FID", "import_inception_state_dict", "import_nvidia_inception_pickle",
           "init_random_inception", "exact_f32", "FEATURE_DIM", "CONV_UNITS_GRAPH_ORDER"]

FEATURE_DIM = 2048
BN_EPS = 1e-3


@contextlib.contextmanager
def exact_f32():
    """TF32 off in cuDNN and in matmuls inside the block; the caller's flags
    come back afterwards.  TF32 moves Inception features by ~1e-3 relative,
    which FID shows at the 0.05 level, and flips PRDC's radius decisions."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _tf1_resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 ResizeBilinear with align_corners=False on NHWC f32: the
    asymmetric transform src = dst * in / out, computed in f32 as the JAX
    module does; the resize baked into the inception-2015-12-05 graph."""

    def _axis(size_in, size_out):
        src = torch.arange(size_out, dtype=torch.float32, device=x.device) * np.float32(
            size_in / size_out)
        i0 = torch.floor(src).long()
        i1 = torch.clamp(i0 + 1, max=size_in - 1)
        return i0, i1, src - i0.float()

    i0, i1, wh = _axis(x.shape[1], out_h)
    wh = wh[None, :, None, None]
    x = x.index_select(1, i0) * (1.0 - wh) + x.index_select(1, i1) * wh
    j0, j1, ww = _axis(x.shape[2], out_w)
    ww = ww[None, None, :, None]
    return x.index_select(2, j0) * (1.0 - ww) + x.index_select(2, j1) * ww


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5 (``jax/_src/image/scale.py``
    ``_fill_keys_cubic_kernel``), in its operation order."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_RESIZE_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def _resize_weights(size_in: int, size_out: int, device, method: str = "bilinear"
                    ) -> torch.Tensor:
    """[size_in, size_out] weights of ``jax.image.resize`` along one axis
    (``jax/_src/image/scale.py::compute_weight_mat`` with antialias): the
    method's kernel on half-pixel sample points, widened by in / out where
    the axis shrinks, each column normalised over the in-range pixels, in
    f32."""
    inv_scale = np.float32(1.0 / (size_out / size_in))  # JAX: 1 / scale, scale = out / in
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (torch.arange(size_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    grid = torch.arange(size_in, dtype=torch.float32, device=device)
    w = _RESIZE_KERNELS[method]((sample[None, :] - grid[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_nhwc(x: torch.Tensor, out_h: int, out_w: int, method: str = "bilinear"
                ) -> torch.Tensor:
    """``jax.image.resize(x, (N, out_h, out_w, C), method)`` on NHWC f32
    (``bilinear`` or Keys' ``bicubic``, antialiased where an axis shrinks):
    one weighted sum per spatial axis that changes size, H then W."""
    if out_h != x.shape[1]:
        x = torch.einsum("nhwc,hH->nHwc", x, _resize_weights(x.shape[1], out_h, x.device, method))
    if out_w != x.shape[2]:
        x = torch.einsum("nhwc,wW->nhWc", x, _resize_weights(x.shape[2], out_w, x.device, method))
    return x


class _BN(nn.Module):
    """Inference BatchNorm's four tensors under torchvision's names (no
    ``num_batches_tracked``): (x - mean) / sqrt(var + 1e-3) * scale + bias
    after the conv, as the JAX module computes it, in one pass
    (``F.batch_norm``) rather than four."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=BN_EPS)


class BasicConv2d(nn.Module):
    """Conv without bias, inference BN (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = _BN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)), inplace=True)


def _avg_pool_3x3_no_pad_count(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_no_pad_count(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                  self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool_3x3_no_pad_count(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for m in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = m(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` "max" in the last block (Mixed_7c, the FID variant):
    3x3 stride-1 max pooling with "SAME" padding."""

    def __init__(self, cin: int, pool_mode: str = "avg"):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "avg":
            bp = _avg_pool_3x3_no_pad_count(x)
        else:
            bp = F.max_pool2d(x, 3, 1, 1)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """uint8 NHWC images -> [N, 2048] pool3 features (f32).

    ``tf_preprocessing=True`` is the NVIDIA / TF-graph detector's input path
    (TF1 resize, (x - 128) / 128); the default is the pytorch-fid lineage's
    (half-pixel bilinear, x / 127.5 - 1)."""

    def __init__(self, tf_preprocessing: bool = False):
        super().__init__()
        self.tf_preprocessing = tf_preprocessing
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC -> f32 NCHW at 299 x 299 in [-1, 1]."""
        x = images.float()
        if self.tf_preprocessing:
            if tuple(x.shape[1:3]) != (299, 299):
                x = _tf1_resize_bilinear(x, 299, 299)
            x = (x - 128.0) / 128.0
        else:
            if tuple(x.shape[1:3]) != (299, 299):
                x = resize_nhwc(x, 299, 299)
            x = x / 127.5 - 1.0
        return x.permute(0, 3, 1, 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with exact_f32():
            x = self.preprocess(images)
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, 2)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = F.max_pool2d(x, 3, 2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                         "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
            return x.mean(dim=(2, 3))


def init_random_inception(net: InceptionV3FID, seed: int = 0) -> InceptionV3FID:
    """Random weights from an explicit ``torch.Generator``: He-scaled convs,
    identity BN.  Values are meaningless (the CLIs' ``--smoke``): Flax's init
    bits cannot be reproduced, and nothing compares to them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * (2.0 / fan_in) ** 0.5)
    return net


# BasicConv2d units in CALL (graph) order: the anchor of the order / shape
# automap of the NVIDIA detector pickle, whose module tree follows the TF
# graph order (the JAX module's table).
_A = ["branch1x1", "branch5x5_1", "branch5x5_2",
      "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"]
_B = ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]
_C = ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
      "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
      "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"]
_D = ["branch3x3_1", "branch3x3_2",
      "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"]
_E = ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
      "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
      "branch3x3dbl_3b", "branch_pool"]

CONV_UNITS_GRAPH_ORDER = (
    [("Conv2d_1a_3x3",), ("Conv2d_2a_3x3",), ("Conv2d_2b_3x3",),
     ("Conv2d_3b_1x1",), ("Conv2d_4a_3x3",)]
    + [(f"Mixed_5{s}", b) for s in "bcd" for b in _A]
    + [("Mixed_6a", b) for b in _B]
    + [(f"Mixed_6{s}", b) for s in "bcde" for b in _C]
    + [("Mixed_7a", b) for b in _D]
    + [(f"Mixed_7{s}", b) for s in "bc" for b in _E]
)

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _f32(val) -> torch.Tensor:
    return torch.as_tensor(np.array(val, dtype=np.float32))


def import_nvidia_inception_pickle(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The NVIDIA StyleGAN3 Inception detector pickle
    (``diff-solvers-main/fid.py:34``) as the port module's state_dict, read
    through the port's restricted loader (no code from the file runs):
    torchvision / pytorch-fid names (keys holding 'Mixed_5b') map by name;
    anything else through the order / shape automap (``_automap_conv_bn``).

    Returns (state_dict, report); report['mode'] is 'names' or 'automap',
    report['unused'] the tensors left over (e.g. the 1008-way logits head).
    The automap has only been validated against synthetic module trees, as
    in the JAX package: check feature parity on the real pickle before
    trusting FID at the 0.05 level."""
    from ..models.torch_import import load_torch_file, torch_state_dict

    sd = torch_state_dict(load_torch_file(path))
    if any("Mixed_5b" in k for k in sd):
        return import_inception_state_dict(sd), {"mode": "names", "n_tensors": len(sd),
                                                 "unused": []}
    return _automap_conv_bn(sd)


def _automap_conv_bn(sd: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Order / shape mapping of a flat {name: array} dict (module DFS order)
    onto the conv units in graph order: each 4-D tensor opens the next unit,
    1-D tensors of its output width attach to it by name (mean / var /
    beta|bias / gamma|weight|scale); a unit without BN gets identity values
    (var = 1 - eps, so rsqrt(var + eps) == 1: exact for a folded BN)."""
    out: Dict[str, torch.Tensor] = {}
    report: Dict[str, Any] = {"mode": "automap", "n_tensors": len(sd), "unused": []}
    unit_idx = -1
    current: Dict[str, Any] = {}

    def flush():
        if unit_idx < 0 or not current:
            return
        prefix = ".".join(CONV_UNITS_GRAPH_ORDER[unit_idx])
        out_ch = current["conv"].shape[0]
        defaults = {"weight": np.ones(out_ch), "bias": np.zeros(out_ch),
                    "running_mean": np.zeros(out_ch),
                    "running_var": np.full(out_ch, 1.0 - BN_EPS, np.float32)}
        out[f"{prefix}.conv.weight"] = _f32(current["conv"])
        for leaf in _BN_LEAVES:
            out[f"{prefix}.bn.{leaf}"] = _f32(current.get(leaf, defaults[leaf]))

    for name, arr in sd.items():
        arr = np.asarray(arr)
        if arr.ndim == 4:
            flush()
            unit_idx += 1
            if unit_idx >= len(CONV_UNITS_GRAPH_ORDER):
                report["unused"].append(name)
                unit_idx -= 1
                current = {}  # already flushed; don't attach later vectors
                continue
            current = {"conv": arr}
        elif arr.ndim == 1 and unit_idx >= 0 and "conv" in current \
                and arr.shape[0] == current["conv"].shape[0]:
            # the shape guard keeps trailing head tensors (the 1008-way logits
            # bias after the last conv) out of that unit's BN
            low = name.lower()
            if "mean" in low:
                current["running_mean"] = arr
            elif "var" in low:
                current["running_var"] = arr
            elif "beta" in low or "bias" in low:
                current["bias"] = arr
            elif "gamma" in low or "weight" in low or "scale" in low:
                current["weight"] = arr
            else:
                report["unused"].append(name)
        else:
            report["unused"].append(name)
    flush()
    n_mapped = unit_idx + 1
    if n_mapped != len(CONV_UNITS_GRAPH_ORDER):
        raise ValueError(
            f"automap matched {n_mapped}/{len(CONV_UNITS_GRAPH_ORDER)} conv units -- the "
            f"pickle's structure does not follow the expected TF graph order; inspect its "
            f"tensor names manually")
    report["n_units"] = n_mapped
    return out, report


def import_inception_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A pytorch-fid / torchvision inception_v3 state_dict -> the port
    module's state_dict (f32): its conv and BN tensors by name; the
    classifier head, the aux logits and ``num_batches_tracked`` dropped."""
    with torch.device("meta"):
        keys = InceptionV3FID().state_dict().keys()
    return {k: _f32(v) for k, v in state_dict.items() if k in keys}
