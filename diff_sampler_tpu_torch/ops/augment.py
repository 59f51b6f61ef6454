"""EDM's augmentation pipeline, which also produces the augment labels the
EDM nets condition on (``map_augment``).

Counterpart of ``diff_sampler_tpu/ops/augment.py`` (the reference's
``training/augment.py:115-330``): pixel blitting (x / y flip, integer
rotation, integer translation with mirrored edges), geometric transforms
(isotropic and anisotropic scale, fractional rotation and translation) and
colour transforms (brightness, contrast, luma flip, hue, saturation), each
applied to a sample with probability ``p`` times its own and encoded in the
label vector in the reference's layout (EDM's ``augment_dim=9``: xflip,
yflip, scale, rotate_frac x2, aniso x2, translate_frac x2).

As in the JAX package, the geometric warp is direct bilinear sampling with
scipy's ``reflect`` (half-sample symmetric) edges, the computation of
``jax.scipy.ndimage.map_coordinates(order=1, mode="reflect")`` written out
as index arithmetic and four gathers, in place of the reference's
wavelet-filtered ``grid_sample``: the labels and the transforms' parameters
are the reference's, the anti-aliasing filter is not.

The random draws are kept apart from their application: ``draw(n, h, w,
generator, device)`` returns an ``AugmentDraws`` (the per-sample flips,
rotations and translations, the inverse geometric matrix, the colour
matrix and the labels), ``apply(images, draws)`` transforms NHWC images
with it, and ``pipe(images, generator)`` does both.  The draws come from
an explicit ``torch.Generator`` in the JAX function's order of calls (each
transform's values, then its probability mask), so the same uniform,
normal and integer draws give the JAX package's result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = ["AugmentPipe", "AugmentDraws"]


# -- the random draws (the JAX package's jax.random calls) ---------------------

def _uniform(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _normal(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def _randint(shape, low: int, high: int, generator, device) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=generator, device=device)


# -- 3x3 geometric and 4x4 colour matrices --------------------------------------

def _rot2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _scale2d(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([torch.stack([sx, z, z], -1), torch.stack([z, sy, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _translate2d(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return torch.stack([torch.stack([o, z, tx], -1), torch.stack([z, o, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def _rotate3d(axis, theta):
    """Rodrigues' rotation (4x4 homogeneous) by ``theta`` [N] around the unit
    3-vector ``axis``."""
    vx, vy, vz = axis[0], axis[1], axis[2]
    s, cth = torch.sin(theta), torch.cos(theta)
    cc = 1.0 - cth
    rows = [
        (vx * vx * cc + cth, vx * vy * cc - vz * s, vx * vz * cc + vy * s),
        (vy * vx * cc + vz * s, vy * vy * cc + cth, vy * vz * cc - vx * s),
        (vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + cth),
    ]
    m = torch.zeros((theta.shape[0], 4, 4), dtype=theta.dtype, device=theta.device)
    for i, row in enumerate(rows):
        for j, v in enumerate(row):
            m[:, i, j] = v
    m[:, 3, 3] = 1.0
    return m


# -- the warp (map_coordinates, order 1, mode "reflect") ------------------------

def _mirror_index(index, size: int):
    s = size - 1
    return ((index + s) % (2 * s) - s).abs()


def _reflect_index(index, size: int):
    """scipy's ``reflect``: ... 1 0 | 0 1 ... n-1 | n-1 n-2 ..."""
    return torch.div(_mirror_index(2 * index + 1, 2 * size + 1) - 1, 2, rounding_mode="floor")


def _affine_warp(images, g_inv):
    """Per-sample affine warp of NHWC images: output(p) = input(g_inv @ p)
    about the image centre, bilinear, with reflected edges; the products
    and sums in map_coordinates' order."""
    n, h, w, c = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    f32 = dict(dtype=torch.float32, device=images.device)
    ys, xs = torch.meshgrid(torch.arange(h, **f32) - cy, torch.arange(w, **f32) - cx,
                            indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)  # [3, H*W]
    src = g_inv.float() @ grid  # [N, 3, H*W]
    sx, sy = src[:, 0] + cx, src[:, 1] + cy

    def taps(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        return [(_reflect_index(index, size), 1 - upper_w),
                (_reflect_index(index + 1, size), upper_w)]

    flat = images.reshape(n, h * w, c)
    out = None
    for iy, wy in taps(sy, h):
        for ix, wx in taps(sx, w):
            idx = (iy * w + ix)[..., None].expand(-1, -1, c)
            term = (wy * wx)[..., None] * torch.gather(flat, 1, idx)
            out = term if out is None else out + term
    return out.reshape(n, h, w, c).to(images.dtype)


def _apply_color(images, m):
    """The 4x4 colour matrices ``m`` [N, 4, 4] on 3-channel images, or their
    luma-averaged rows on 1-channel ones."""
    n, h, w, c = images.shape
    flat = images.reshape(n, h * w, c)
    if c == 3:
        flat = torch.einsum("nij,npj->npi", m[:, :3, :3], flat) + m[:, None, :3, 3]
    elif c == 1:
        mm = m[:, :3, :].mean(dim=1, keepdim=True)
        flat = flat * mm[:, :, :3].sum(-1)[:, :, None] + mm[:, :, 3:]
    else:
        raise ValueError("images must have 1 or 3 channels")
    return flat.reshape(n, h, w, c)


@dataclasses.dataclass
class AugmentDraws:
    """What one call of the pipe drew, per sample (None where the transform
    is off): the x / y flips and the integer rotation (f32 [N]), the integer
    translation (int [2, N]: x, y), the inverse of the geometric transforms
    (f32 [N, 3, 3]), the colour matrix (f32 [N, 4, 4]) and the labels
    (f32 [N, label_dim])."""

    labels: torch.Tensor
    xflip: Optional[torch.Tensor] = None
    yflip: Optional[torch.Tensor] = None
    rotate_int: Optional[torch.Tensor] = None
    translate_int: Optional[torch.Tensor] = None
    g_inv: Optional[torch.Tensor] = None
    color: Optional[torch.Tensor] = None

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(**{f.name: None if getattr(self, f.name) is None
                               else getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class AugmentPipe:
    """Each transform's probability multiplies the overall ``p``
    (augment.py:121-151).  EDM's CIFAR-10 training: ``AugmentPipe(p=0.12,
    xflip=1e8, yflip=1, scale=1, rotate_frac=1, aniso=1,
    translate_frac=1)``."""

    p: float = 1.0
    xflip: float = 0.0
    yflip: float = 0.0
    rotate_int: float = 0.0
    translate_int: float = 0.0
    translate_int_max: float = 0.125
    scale: float = 0.0
    rotate_frac: float = 0.0
    aniso: float = 0.0
    translate_frac: float = 0.0
    scale_std: float = 0.2
    rotate_frac_max: float = 1.0
    aniso_std: float = 0.2
    aniso_rotate_prob: float = 0.5
    translate_frac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0

    @property
    def label_dim(self) -> int:
        widths = (("xflip", 1), ("yflip", 1), ("rotate_int", 2), ("translate_int", 2),
                  ("scale", 1), ("rotate_frac", 2), ("aniso", 2), ("translate_frac", 2),
                  ("brightness", 1), ("contrast", 1), ("lumaflip", 1), ("hue", 2),
                  ("saturation", 1))
        return sum(d for name, d in widths if getattr(self, name) > 0)

    def draw(self, n: int, h: int, w: int, generator: Optional[torch.Generator] = None,
             device="cuda") -> AugmentDraws:
        """The random part of one call on N images of H x W, from
        ``generator`` (on ``device``)."""
        rng = dict(generator=generator, device=device)
        labels = []
        out = {}

        def gate(prob, values):
            mask = _uniform((n,), **rng) < prob * self.p
            return torch.where(mask.reshape((n,) + (1,) * (values.dim() - 1)), values,
                               torch.zeros_like(values))

        # -- pixel blitting
        if self.xflip > 0:
            out["xflip"] = gate(self.xflip, _randint((n,), 0, 2, **rng).float())
            labels.append(out["xflip"][:, None])
        if self.yflip > 0:
            out["yflip"] = gate(self.yflip, _randint((n,), 0, 2, **rng).float())
            labels.append(out["yflip"][:, None])
        if self.rotate_int > 0:
            wv = out["rotate_int"] = gate(self.rotate_int, _randint((n,), 0, 4, **rng).float())
            labels += [((wv == 1) | (wv == 2)).float()[:, None],
                       ((wv == 2) | (wv == 3)).float()[:, None]]
        if self.translate_int > 0:
            raw = _uniform((2, n), **rng) * 2 - 1
            mask = _uniform((1, n), **rng) < self.translate_int * self.p
            raw = torch.where(mask, raw, torch.zeros_like(raw))
            tx = torch.round(raw[0] * w * self.translate_int_max).to(torch.int32)
            ty = torch.round(raw[1] * h * self.translate_int_max).to(torch.int32)
            out["translate_int"] = torch.stack([tx, ty])
            labels += [(tx / (w * self.translate_int_max))[:, None],
                       (ty / (h * self.translate_int_max))[:, None]]

        # -- geometric transforms
        g_inv = torch.eye(3, device=device).expand(n, 3, 3)
        geo = False
        if self.scale > 0:
            wv = gate(self.scale, _normal((n,), **rng))
            s = torch.exp2(wv * self.scale_std)
            g_inv = g_inv @ _scale2d(1.0 / s, 1.0 / s)
            labels.append(wv[:, None])
            geo = True
        if self.rotate_frac > 0:
            wv = gate(self.rotate_frac, (_uniform((n,), **rng) * 2 - 1)
                      * (math.pi * self.rotate_frac_max))
            g_inv = g_inv @ _rot2d(wv)  # rotate2d_inv(-w) == rotate2d(w)
            labels += [(torch.cos(wv) - 1)[:, None], torch.sin(wv)[:, None]]
            geo = True
        if self.aniso > 0:
            wv = gate(self.aniso, _normal((n,), **rng))
            r = (_uniform((n,), **rng) * 2 - 1) * math.pi
            r = torch.where(_uniform((n,), **rng) < self.aniso_rotate_prob, r,
                            torch.zeros_like(r))
            s = torch.exp2(wv * self.aniso_std)
            g_inv = g_inv @ _rot2d(-r) @ _scale2d(1.0 / s, s) @ _rot2d(r)
            labels += [(wv * torch.cos(r))[:, None], (wv * torch.sin(r))[:, None]]
            geo = True
        if self.translate_frac > 0:
            raw = _normal((2, n), **rng)
            mask = _uniform((1, n), **rng) < self.translate_frac * self.p
            raw = torch.where(mask, raw, torch.zeros_like(raw))
            g_inv = g_inv @ _translate2d(-raw[0] * w * self.translate_frac_std,
                                         -raw[1] * h * self.translate_frac_std)
            labels += [raw[0][:, None], raw[1][:, None]]
            geo = True
        if geo:
            out["g_inv"] = g_inv

        # -- colour transforms
        eye4 = torch.eye(4, device=device)
        m = eye4.expand(n, 4, 4)
        luma = torch.tensor([1.0, 1.0, 1.0, 0.0], device=device) / math.sqrt(3.0)
        col = False
        if self.brightness > 0:
            wv = gate(self.brightness, _normal((n,), **rng))
            t = eye4.repeat(n, 1, 1)
            t[:, :3, 3] = (wv * self.brightness_std)[:, None]
            m = t @ m
            labels.append(wv[:, None])
            col = True
        if self.contrast > 0:
            wv = gate(self.contrast, _normal((n,), **rng))
            cc = torch.exp2(wv * self.contrast_std)
            diag = torch.stack([cc, cc, cc, torch.ones_like(cc)], -1)  # [N, 4]
            m = diag[:, :, None] * eye4[None] @ m
            labels.append(wv[:, None])
            col = True
        if self.lumaflip > 0:
            wv = gate(self.lumaflip, _randint((n,), 0, 2, **rng).float())
            outer = torch.outer(luma, luma)
            m = (eye4[None] - 2.0 * outer[None] * wv[:, None, None]) @ m
            labels.append(wv[:, None])
            col = True
        if self.hue > 0:
            wv = gate(self.hue, (_uniform((n,), **rng) * 2 - 1) * (math.pi * self.hue_max))
            m = _rotate3d(luma[:3], wv) @ m
            labels += [(torch.cos(wv) - 1)[:, None], torch.sin(wv)[:, None]]
            col = True
        if self.saturation > 0:
            wv = gate(self.saturation, _normal((n,), **rng))
            outer = torch.outer(luma, luma)[None]
            m = (outer + (eye4[None] - outer)
                 * torch.exp2(wv * self.saturation_std)[:, None, None]) @ m
            labels.append(wv[:, None])
            col = True
        if col:
            out["color"] = m

        label_vec = (torch.cat(labels, dim=1).float() if labels
                     else torch.zeros((n, 0), device=device))
        return AugmentDraws(labels=label_vec, **out)

    def apply(self, images: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
        """``images`` [N, H, W, C] (C 1 or 3 where a colour transform is on)
        transformed by ``draws``."""
        n, h, w, _ = images.shape
        if draws.xflip is not None:
            images = torch.where(draws.xflip.reshape(-1, 1, 1, 1) == 1, images.flip(2), images)
        if draws.yflip is not None:
            images = torch.where(draws.yflip.reshape(-1, 1, 1, 1) == 1, images.flip(1), images)
        if draws.rotate_int is not None:
            wb = draws.rotate_int.reshape(-1, 1, 1, 1)
            images = torch.where((wb == 1) | (wb == 2), images.flip(2), images)
            images = torch.where((wb == 2) | (wb == 3), images.flip(1), images)
            images = torch.where((wb == 1) | (wb == 3), images.transpose(1, 2), images)
        if draws.translate_int is not None:
            tx, ty = draws.translate_int.long()
            ygrid = torch.arange(h, device=images.device)[None, :, None]
            xgrid = torch.arange(w, device=images.device)[None, None, :]
            # mirror-index arithmetic (augment.py:187-190)
            xi = (w - 1) - ((w - 1) - (xgrid - tx[:, None, None]) % (2 * w - 2)).abs()
            yi = (h - 1) - ((h - 1) - (ygrid + ty[:, None, None]) % (2 * h - 2)).abs()
            images = images[torch.arange(n, device=images.device)[:, None, None], yi, xi]
        if draws.g_inv is not None:
            images = _affine_warp(images, draws.g_inv)
        if draws.color is not None:
            images = _apply_color(images, draws.color)
        return images

    def __call__(self, images: torch.Tensor, generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: [N, H, W, C] float.  Returns (augmented, labels [N, label_dim]),
        drawn from ``generator`` (on the images' device)."""
        n, h, w, _ = images.shape
        draws = self.draw(n, h, w, generator, images.device)
        return self.apply(images, draws), draws.labels
