"""The port's augment pipe (``ops/augment.py``) against the JAX package's.

The two packages' random number generators differ, so the pipe is held on
the same draws: the port draws through its ``_uniform`` / ``_normal`` /
``_randint``, patched here to numpy and recorded, and the JAX pipe is run
with ``jax.random.uniform`` / ``normal`` / ``randint`` patched to hand back
that record in order (both call them in the same order: a transform's
values, then its probability mask).  On the CPU.

Bounds: the label layouts, identity at p = 0 (aniso off), the flips,
integer rotations and mirrored integer translations exact; the geometric
warp and the colour matrices 1e-5 * max (f32 matrix products and sums in
other orders: the sample points move by an ulp); the 3x3 / 4x4 matrices
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops import augment as JA
from diff_sampler_tpu_torch.ops import augment as TA

EDM_CIFAR = dict(p=0.12, xflip=1e8, yflip=1, scale=1, rotate_frac=1, aniso=1, translate_frac=1)
BLITS = dict(p=1.0, xflip=1, yflip=1, rotate_int=1, translate_int=1)
EVERYTHING = dict(p=1.0, xflip=1, yflip=1, rotate_int=1, translate_int=1, scale=1, rotate_frac=1,
                  aniso=1, translate_frac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                  saturation=1)
GEOMETRY = dict(p=1.0, scale=1, rotate_frac=1, aniso=1, translate_frac=1)
COLOUR = dict(p=1.0, brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)


class _Record:
    """numpy draws in the port's call order, then replayed to JAX."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.draws = []

    def patch_port(self, monkeypatch):
        def keep(a):
            self.draws.append(a)
            return torch.from_numpy(a)

        monkeypatch.setattr(TA, "_uniform", lambda shape, generator, device: keep(
            self.rng.rand(*shape).astype(np.float32)))
        monkeypatch.setattr(TA, "_normal", lambda shape, generator, device: keep(
            self.rng.randn(*shape).astype(np.float32)))
        monkeypatch.setattr(TA, "_randint", lambda shape, low, high, generator, device: keep(
            self.rng.randint(low, high, size=shape).astype(np.int64)))

    def patch_jax(self, monkeypatch):
        replay = iter(self.draws)

        def give(shape, kind):
            a = next(replay)
            assert a.shape == tuple(shape) and a.dtype.kind == kind, (a.shape, shape, kind)
            return jnp.asarray(a.astype(np.int32) if kind == "i" else a)

        monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: give(shape, "f"))
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: give(shape, "f"))
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, minval, maxval, *a, **k: give(shape, "i"))


def _both(monkeypatch, settings, images, seed=0):
    rec = _Record(seed)
    rec.patch_port(monkeypatch)
    pipe = TA.AugmentPipe(**settings)
    got, labels = pipe(torch.from_numpy(images))
    rec.patch_jax(monkeypatch)
    want, jlabels = JA.AugmentPipe(**settings)(jax.random.key(0), jnp.asarray(images))
    assert len(rec.draws) > 0
    return got.numpy(), labels.numpy(), np.asarray(want), np.asarray(jlabels)


def _images(seed, n=8, size=8, c=3):
    return np.random.RandomState(seed).randn(n, size, size, c).astype(np.float32)


def _close(got, want, rel, what=""):
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("settings", [EDM_CIFAR, BLITS, EVERYTHING, GEOMETRY, COLOUR, {}],
                         ids=["edm-cifar10", "blits", "everything", "geometry", "colour",
                              "none"])
def test_label_dim_matches_jax(settings):
    assert TA.AugmentPipe(**settings).label_dim == JA.AugmentPipe(**settings).label_dim
    if settings is EDM_CIFAR:
        assert TA.AugmentPipe(**settings).label_dim == 9  # EDM's augment_dim


@pytest.mark.parametrize("name,settings,rel,channels", [
    ("edm-cifar10", EDM_CIFAR, 1e-5, 3), ("blits", BLITS, 0.0, 3),
    ("everything", EVERYTHING, 1e-5, 3), ("geometry-1ch", GEOMETRY, 1e-5, 1),
    ("colour-1ch", COLOUR, 1e-5, 1)], ids=lambda v: v if isinstance(v, str) else "")
def test_pipe_matches_jax_on_the_same_draws(monkeypatch, name, settings, rel, channels):
    """Images and labels on the same draws; the blits alone are gathers and
    match exactly.  EDM's settings at p=1 (every transform taken) too."""
    if name == "edm-cifar10":
        settings = dict(settings, p=1.0)
    images = _images(1, c=channels)
    got, labels, want, jlabels = _both(monkeypatch, settings, images)
    assert labels.shape == (8, TA.AugmentPipe(**settings).label_dim)
    _close(labels, jlabels, 1e-6, "labels")
    if rel == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, rel, "images")
    assert np.abs(got - images).max() > 0  # something happened


def test_edm_settings_at_p_012_match_jax_over_a_batch(monkeypatch):
    """EDM's CIFAR-10 pipe (p = 0.12, xflip 1e8) on 32 px images: most
    transforms gated off, x flips on about half."""
    images = _images(2, n=64, size=32)
    got, labels, want, jlabels = _both(monkeypatch, EDM_CIFAR, images, seed=3)
    _close(labels, jlabels, 1e-6, "labels")
    _close(got, want, 1e-5, "images")
    assert 0 < (labels[:, 0] == 1).sum() < 64
    assert (labels[:, 2:] == 0).all(axis=1).sum() > 16  # untouched by the geometry


def test_identity_at_p_zero():
    """Every transform on at p = 0: zero labels, and the images unchanged,
    exactly with aniso off.  Aniso's rotation r is drawn whatever p is (as
    in the JAX package and the reference), so with it on the warp samples
    rot(-r) @ rot(r), the identity to rounding: within 1e-5 * max."""
    images = torch.from_numpy(_images(4))
    for settings in (dict(EVERYTHING, p=0.0, aniso=0), dict(EVERYTHING, p=0.0)):
        pipe = TA.AugmentPipe(**settings)
        out, labels = pipe(images, torch.Generator().manual_seed(0))
        assert labels.shape == (8, pipe.label_dim) and not labels.any()
        if settings["aniso"]:
            _close(out.numpy(), images.numpy(), 1e-5, "p = 0 with aniso")
        else:
            assert torch.equal(out, images)


def test_xflip_exact_and_draws_reproducible():
    pipe = TA.AugmentPipe(p=1.0, xflip=1.0)
    images = torch.from_numpy(_images(5, n=16))
    out, labels = pipe(images, torch.Generator().manual_seed(1))
    for i in range(16):
        want = images[i].flip(1) if labels[i, 0] == 1 else images[i]
        assert torch.equal(out[i], want)
    assert 0 < labels[:, 0].sum() < 16
    again, labels2 = pipe(images, torch.Generator().manual_seed(1))
    assert torch.equal(again, out) and torch.equal(labels2, labels)
    draws = pipe.draw(16, 8, 8, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(pipe.apply(images, draws.to("cpu")), out)


def test_matrices_and_warp_match_jax_on_given_parameters():
    """``_rot2d``, ``_scale2d``, ``_translate2d``, ``_rotate3d`` and
    ``_affine_warp`` on the same parameters, sample points outside the
    image included (reflected edges)."""
    rng = np.random.RandomState(6)
    theta = rng.uniform(-np.pi, np.pi, 5).astype(np.float32)
    sx, sy = (np.exp2(rng.randn(2, 5) * 0.5)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.array(a))

    for tf, jf, args in ((TA._rot2d, JA._rot2d, (theta,)), (TA._scale2d, JA._scale2d, (sx, sy)),
                         (TA._translate2d, JA._translate2d, (sx, sy))):
        _close(tf(*map(t, args)).numpy(), np.asarray(jf(*map(jnp.asarray, args))), 1e-6)
    axis = np.array([1.0, 1.0, 1.0], np.float32) / np.sqrt(3.0)
    _close(TA._rotate3d(t(axis), t(theta)).numpy(),
           np.asarray(JA._rotate3d(jnp.asarray(axis), jnp.asarray(theta))), 1e-6)
    g_inv = np.asarray(JA._rot2d(jnp.asarray(theta)) @ JA._scale2d(
        jnp.asarray(sx), jnp.asarray(sy)) @ JA._translate2d(jnp.asarray(3 * sy),
                                                            jnp.asarray(-2 * sx)))
    images = _images(7, n=5, size=12)
    _close(TA._affine_warp(t(images), t(g_inv)).numpy(),
           np.asarray(JA._affine_warp(jnp.asarray(images), jnp.asarray(g_inv))), 1e-5, "warp")
    idx = torch.arange(-30, 31)
    np.testing.assert_array_equal(TA._reflect_index(idx, 7).numpy(), np.asarray(
        jax.scipy.ndimage.map_coordinates(jnp.arange(7.0), [jnp.arange(-30.0, 31.0)], order=0,
                                          mode="reflect")).astype(np.int64))
