"""The port's analytic denoisers against the JAX package's, and every
solver of the port converging on the exact one.

Each denoiser is built from one numpy draw on both sides and called on the
same x at a scalar sigma and at one sigma per sample; f32, max abs error
<= 1e-5 * max|D| (the mixture's softmax over log-densities of size ~D * log
sigma loses a few more bits: 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import analytic as JA
from diff_sampler_tpu_torch.models import analytic as TA
from diff_sampler_tpu_torch.ops import get_schedule
from diff_sampler_tpu_torch.solvers import samplers as TS

SHAPE = (4, 3, 4, 2)  # [B, H, W, C]
D = 3 * 4 * 2
SIGMAS = [80.0, 2.0, 0.05]


def _data(seed, n=12):
    return np.random.RandomState(seed).randn(n, *SHAPE[1:]).astype(np.float32)


def _pairs():
    rng = np.random.RandomState(3)
    mu = rng.randn(*SHAPE[1:]).astype(np.float32) * 0.3
    var = (0.2 + rng.rand(*SHAPE[1:])).astype(np.float32)
    data = _data(4)
    labels = np.arange(12) % 3
    cpu = dict(device="cpu")
    return {
        "gaussian": (JA.GaussianDenoiser(mu, var), TA.GaussianDenoiser(mu, var, **cpu)),
        "dataset": (JA.DatasetPosteriorDenoiser(data),
                    TA.DatasetPosteriorDenoiser(data, **cpu)),
        "isotropic": (JA.IsotropicGaussianDenoiser(mu),
                      TA.IsotropicGaussianDenoiser(mu, **cpu)),
        "low_rank": (JA.LowRankGaussianDenoiser.from_data(data, 3),
                     TA.LowRankGaussianDenoiser.from_data(data, 3, **cpu)),
        "mog_full": (JA.MixtureGaussianDenoiser.from_labeled_data(data, labels),
                     TA.MixtureGaussianDenoiser.from_labeled_data(data, labels, **cpu)),
        "mog_low_rank": (JA.MixtureGaussianDenoiser.from_labeled_data(data, labels, rank=2),
                         TA.MixtureGaussianDenoiser.from_labeled_data(data, labels, rank=2,
                                                                      **cpu)),
    }


PAIRS = _pairs()
TOL = {"mog_full": 1e-4, "mog_low_rank": 1e-4}


# GaussianDenoiser takes a scalar sigma in both packages; the others also one
# sigma per sample
CASES = [(name, per_sample) for name in sorted(PAIRS) for per_sample in (False, True)
         if not (name == "gaussian" and per_sample)]


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("name,per_sample", CASES,
                         ids=[f"{n}-{'per-sample' if p else 'scalar'}" for n, p in CASES])
def test_denoiser_matches_jax(name, per_sample, sigma):
    jd, td = PAIRS[name]
    x = (np.random.RandomState(5).randn(*SHAPE) * sigma).astype(np.float32)
    s = np.linspace(sigma, 2 * sigma, SHAPE[0]).astype(np.float32) if per_sample else sigma
    ref = np.asarray(jd(jnp.asarray(x), jnp.asarray(s)))
    ours = td(torch.from_numpy(x), torch.as_tensor(s)).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL.get(name, 1e-5) * np.abs(ref).max())


def test_denoisers_carry_their_sigma_range():
    for _, td in PAIRS.values():
        assert (td.sigma_min, td.sigma_max) == (0.002, 80.0)
    assert TA.IsotropicGaussianDenoiser(np.zeros(D), sigma_max=10.0,
                                        device="cpu").sigma_max == 10.0


def test_denoisers_live_on_the_card_by_default():
    """With no ``device``, the parameters go to CUDA: on a machine without a
    card (as where the tier-1 tests run) building one raises."""
    assert not torch.cuda.is_available()
    with pytest.raises((AssertionError, RuntimeError)):
        TA.GaussianDenoiser(0.0, 1.0)


def test_exact_solution_matches_jax():
    jd, td = PAIRS["gaussian"]
    x = np.random.RandomState(6).randn(*SHAPE).astype(np.float32) * 80
    ref = np.asarray(jd.exact_solution(jnp.asarray(x), 80.0, 0.002))
    ours = td.exact_solution(torch.from_numpy(x), 80.0, 0.002).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("solver", sorted(TS.SOLVER_REGISTRY))
def test_every_solver_converges_on_the_exact_denoiser(solver):
    """On data ~ N(mu, var) the ODE's end point is known in closed form.
    Every solver of the registry moves toward it as the poly-7 schedule
    grows from 11 to 41 to 161 points, gains at least 10x over the two
    steps (euler, the first-order one, 13.7x), and lands within 2.5e-2 of
    max|x_0| at 161 (euler 2.0e-2; the others below 1e-3, where ipndm_v
    meets f32 rounding).  The data lies inside [-1, 1], where the dynamic
    thresholding of dpmpp and unipc changes nothing."""
    rng = np.random.RandomState(9)
    mu = rng.randn(*SHAPE[1:]).astype(np.float32) * 0.15
    var = (0.005 + 0.015 * rng.rand(*SHAPE[1:])).astype(np.float32)
    td = TA.GaussianDenoiser(mu, var, device="cpu")
    lat = torch.from_numpy(np.random.RandomState(8).randn(*SHAPE).astype(np.float32))
    want = td.exact_solution(lat * 80.0, 80.0, 0.002)
    assert want.abs().max().item() < 1
    errs = []
    for n in (11, 41, 161):
        t = get_schedule(n, 0.002, 80.0, "polynomial", 7.0)
        got = TS.get_sampler(solver)(td, lat, t).x
        errs.append((got - want).abs().max().item())
    assert errs[0] > errs[1] > errs[2] and errs[2] < errs[0] / 10, errs
    assert errs[2] < 2.5e-2 * want.abs().max().item(), errs
