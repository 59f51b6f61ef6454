"""The port's samplers against the JAX package's, on one closed-form
denoiser written once in torch and once in jnp.

The data distribution is a Gaussian N(mu, s^2 I) per pixel, so
D(x, sigma) = mu + s^2 / (s^2 + sigma^2) * (x - mu) exactly.  The latents
are one numpy draw handed to both sides.  f32, max abs error <= 1e-5 relative
to the trajectory's scale, max|x_T| = sigma_max * max|latents|: a large first
step cancels most of x_T (|x| falls from ~200 to ~10), so one rounding step
at that scale is what the two sides may differ by.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.ops import get_schedule
from diff_sampler_tpu.solvers import samplers as JS
from diff_sampler_tpu_torch.solvers import samplers as TS

SOLVERS = ["euler", "heun", "dpm", "ipndm", "ipndm_v", "deis", "dpmpp", "unipc"]
SHAPE = (4, 6, 6, 3)
S2 = 0.25
SIGMA_MAX = 80.0
MU = np.random.RandomState(10).randn(*SHAPE[1:]).astype(np.float32) * 0.5


def _jax_denoise(x, t):
    return MU + S2 / (S2 + t ** 2) * (x - MU)


_MU_T = torch.from_numpy(MU)


def _torch_denoise(x, t):
    return _MU_T + S2 / (S2 + t ** 2) * (x - _MU_T)


def _latents(seed=0):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


def _run(solver, num_steps, **kw):
    t_steps = get_schedule(num_steps, 0.002, SIGMA_MAX, "polynomial", 7.0)
    lat = _latents()
    ref = JS.get_sampler(solver)(_jax_denoise, jnp.asarray(lat), t_steps, **kw)
    ours = TS.get_sampler(solver)(_torch_denoise, torch.from_numpy(lat), t_steps, **kw)
    return ours, ref


def _close(ours, ref):
    ref = np.asarray(ref)
    ours = ours.numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    scale = SIGMA_MAX * np.abs(_latents()).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("afs", [False, True])
@pytest.mark.parametrize("num_steps", [3, 6, 11])
@pytest.mark.parametrize("solver", SOLVERS)
def test_sampler_matches_jax(solver, num_steps, afs):
    ours, ref = _run(solver, num_steps, afs=afs)
    _close(ours.x, ref.x)
    assert ours.xs is None and ours.eps is None


@pytest.mark.parametrize("denoise_to_zero", [False, True])
@pytest.mark.parametrize("solver", SOLVERS)
def test_trajectory_and_denoise_to_zero_match_jax(solver, denoise_to_zero):
    ours, ref = _run(solver, 6, afs=True, denoise_to_zero=denoise_to_zero,
                     return_inters=True)
    _close(ours.x, ref.x)
    _close(ours.xs, ref.xs)
    if ref.eps is None:  # unipc records the states only
        assert ours.eps is None
    else:
        _close(ours.eps, ref.eps)


@pytest.mark.parametrize("max_order", [1, 2, 3])
@pytest.mark.parametrize("solver", ["ipndm", "ipndm_v", "deis", "dpmpp", "unipc"])
def test_lower_orders_match_jax(solver, max_order):
    ours, ref = _run(solver, 6, max_order=max_order)
    _close(ours.x, ref.x)


@pytest.mark.parametrize("lower_order_final", [False, True])
def test_dpmpp_noise_prediction_matches_jax(lower_order_final):
    ours, ref = _run("dpmpp", 6, predict_x0=False, lower_order_final=lower_order_final)
    _close(ours.x, ref.x)


def test_dynamic_thresholding_matches_jax():
    x0 = np.random.RandomState(3).randn(*SHAPE).astype(np.float32) * 3
    x0[0] *= 0.1  # a sample whose quantile is below 1: divided by 1
    ref = np.asarray(JS.dynamic_thresholding(jnp.asarray(x0)))
    ours = TS.dynamic_thresholding(torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_samples_land_on_the_data_distribution():
    """With a Gaussian data distribution the ODE maps latents to
    close to mu + s * latents; heun at 36 steps gets there."""
    ours, _ = _run("heun", 36)
    expected = MU + np.sqrt(S2) * _latents()
    assert np.abs(ours.x.numpy() - expected).max() < 5e-2


def test_count_nfe_matches_jax():
    for solver in SOLVERS + ["dpm", "dpmpp", "unipc"]:
        for n in (2, 3, 6, 11, 36):
            for afs in (False, True):
                for dtz in (False, True):
                    for doubled in (False, True):
                        assert (TS.count_nfe(solver, n, afs, dtz, doubled)
                                == JS.count_nfe(solver, n, afs, dtz, doubled))


def test_unported_solver_raises():
    """Every solver of the JAX registry is ported; a name in neither
    registry raises."""
    assert set(TS.SOLVER_REGISTRY) == set(JS.SOLVER_REGISTRY)
    with pytest.raises(ValueError, match="unknown solver 'unipc2'"):
        TS.get_sampler("unipc2")
