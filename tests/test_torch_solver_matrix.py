"""The port's whole solver matrix against the JAX package's samplers.

The 19 solver settings of ``tests/test_solver_parity.py`` on its two
schedules (poly-7 at 7 steps, logSNR at 11), 38 cases, run through both
packages' ``GaussianDenoiser`` (data ~ N(0.15, 0.35) per pixel, an exact
closed form written once in torch and once in jnp) on one numpy draw of
latents.  f32; the tolerance is 1e-5 * max|x_T| (max|x_T| = 80 * max
|latents|): the first step cancels most of x_T, so one rounding step at that
scale is what the two sides may differ by.  Also: trajectory shapes,
coefficients handed in through ``coeffs=`` equal to the host path, and the
NFE count of ``count_nfe`` / ``SolverConfig.nfe`` against JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu import sampling as JSAMP
from diff_sampler_tpu.models.analytic import GaussianDenoiser as JGaussian
from diff_sampler_tpu.ops import get_schedule
from diff_sampler_tpu.solvers import samplers as JS
from diff_sampler_tpu_torch import sampling as TSAMP
from diff_sampler_tpu_torch.models.analytic import GaussianDenoiser as TGaussian
from diff_sampler_tpu_torch.models.precond import BoundDenoiser
from diff_sampler_tpu_torch.ops import multistep
from diff_sampler_tpu_torch.solvers import samplers as TS

MU, VAR = 0.15, 0.35
SHAPE = (4, 8, 8, 3)

# tests/test_solver_parity.py's CASES
CASES = [
    ("euler", dict()),
    ("euler", dict(afs=True)),
    ("euler", dict(denoise_to_zero=True)),
    ("heun", dict()),
    ("heun", dict(afs=True)),
    ("dpm", dict()),
    ("dpm", dict(r=0.4)),
    ("ipndm", dict(max_order=4)),
    ("ipndm", dict(max_order=2, afs=True)),
    ("ipndm_v", dict(max_order=4)),
    ("ipndm_v", dict(max_order=3)),
    ("deis", dict(max_order=4)),
    ("deis", dict(max_order=3, deis_mode="rhoab")),
    ("dpmpp", dict(max_order=3)),
    ("dpmpp", dict(max_order=2, predict_x0=False)),
    ("dpmpp", dict(max_order=3, lower_order_final=False)),
    ("unipc", dict(max_order=3)),
    ("unipc", dict(max_order=3, variant="bh1")),
    ("unipc", dict(max_order=2, predict_x0=False)),
]


def _latents(seed=7):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


def _run(name, t_steps, **kw):
    lat = _latents()
    ref = JS.get_sampler(name)(JGaussian(MU, VAR), jnp.asarray(lat), t_steps, **kw)
    ours = TS.get_sampler(name)(TGaussian(MU, VAR, device="cpu"), torch.from_numpy(lat), t_steps, **kw)
    return ours, ref


def _close(ours, ref):
    ref = np.asarray(ref)
    ours = ours.numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * 80.0 * np.abs(_latents()).max())


@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
@pytest.mark.parametrize("num_steps,schedule", [(7, "polynomial"), (11, "logsnr")])
def test_solver_matrix_matches_jax(name, kw, num_steps, schedule):
    t_steps = get_schedule(num_steps, 0.002, 80.0, schedule, 7.0)
    ours, ref = _run(name, t_steps, **kw)
    _close(ours.x, ref.x)


@pytest.mark.parametrize("name", sorted(TS.SOLVER_REGISTRY))
def test_return_inters_shapes_and_values_match_jax(name):
    t_steps = get_schedule(6, 0.002, 80.0, "polynomial", 7.0)
    ours, ref = _run(name, t_steps, afs=True, denoise_to_zero=True, return_inters=True)
    assert ours.xs.shape == (7,) + SHAPE  # x_T, 5 steps, the denoise-to-zero output
    _close(ours.xs, ref.xs)
    if name == "unipc":  # the states only, as in the JAX package
        assert ours.eps is None and ref.eps is None
    else:
        assert ours.eps.shape == (5,) + SHAPE
        _close(ours.eps, ref.eps)


@pytest.mark.parametrize("name,coeff_fn", [
    ("dpmpp", lambda t: multistep.dpm_pp_coeffs(t, 3)),
    ("unipc", lambda t: multistep.unipc_coeffs(t, 3)),
    ("deis", lambda t: multistep.deis_coeffs(t, 4)),
])
def test_coeffs_injection_equals_the_host_path(name, coeff_fn):
    """sampler(..., coeffs=<precomputed>) is the same computation as the
    sampler building its own: bit for bit."""
    t = get_schedule(6, 0.002, 80.0)
    lat = torch.from_numpy(_latents())
    den = TGaussian(-0.1, 0.04, device="cpu")
    s = TS.get_sampler(name)
    a = s(den, lat, t, afs=True).x
    b = s(den, lat, t, afs=True, coeffs=coeff_fn(t)).x
    assert torch.equal(a, b)


def test_count_nfe_and_solver_config_nfe_match_jax():
    t_list = (80.0, 20.0, 5.0, 1.0, 0.2, 0.002)
    for solver in sorted(TS.SOLVER_REGISTRY):
        for n in (2, 3, 6, 11, 61):
            for afs in (False, True):
                for dtz in (False, True):
                    for doubled in (False, True):
                        assert (TS.count_nfe(solver, n, afs, dtz, doubled)
                                == JS.count_nfe(solver, n, afs, dtz, doubled))
        for extra in (dict(), dict(t_steps=t_list), dict(dp_list=(0, 3, 7, 60)),
                      dict(t_steps=t_list, dp_list=(0, 1, 2)), dict(afs=True),
                      dict(denoise_to_zero=True, afs=True)):
            kw = dict(solver=solver, num_steps=11, **extra)
            ours, ref = TSAMP.SolverConfig(**kw), JSAMP.SolverConfig(**kw)
            for doubled in (False, True):
                assert ours.nfe(doubled) == ref.nfe(doubled), (solver, extra)


def test_solver_config_fields_and_schedule_match_jax():
    """Every field of the JAX SolverConfig, with its default, and the
    schedule each resolves to: dp_list over t_steps over num_steps, the
    sigma_min / sigma_max override."""
    ours = {f.name: f.default for f in dataclasses.fields(TSAMP.SolverConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JSAMP.SolverConfig)}
    assert ours == ref
    for kw in (dict(), dict(num_steps=9, schedule_type="logsnr"),
               dict(sigma_min=0.01, sigma_max=40.0, schedule_rho=5.0),
               dict(t_steps=(80.0, 3.0, 0.002)), dict(num_steps=13, dp_list=(0, 4, 9, 12)),
               dict(schedule_type="time_uniform", num_steps=7)):
        a = TSAMP.SolverConfig(**kw).resolve_t_steps(0.002, 80.0)
        b = JSAMP.SolverConfig(**kw).resolve_t_steps(0.002, 80.0)
        np.testing.assert_array_equal(a, b)
        assert (TSAMP.SolverConfig(**kw).sampler_kwargs()
                == JSAMP.SolverConfig(**kw).sampler_kwargs())


def test_generate_returns_the_trajectory_joined_along_the_batch_axis():
    """return_inters through generate: [num_points, N, ...], the chunks of
    a batch split joined on axis 1, each seed's column its own trajectory."""
    gauss = TGaussian(MU, VAR, device="cpu")
    den = BoundDenoiser(lambda x, t, labels=None: gauss(x, t), 0.002, 80.0)
    cfg = TSAMP.SolverConfig(solver="unipc", num_steps=5, denoise_to_zero=True)
    seeds = list(range(5))
    full = TSAMP.generate(den, seeds, (4, 4, 3), cfg, max_batch_size=5, device="cpu",
                          return_inters=True)
    split = TSAMP.generate(den, seeds, (4, 4, 3), cfg, max_batch_size=2, device="cpu",
                           return_inters=True)
    assert full.shape == (6, 5, 4, 4, 3)
    np.testing.assert_array_equal(full, split)
    last = TSAMP.generate(den, seeds, (4, 4, 3), cfg, max_batch_size=2, device="cpu")
    np.testing.assert_array_equal(full[-1], last)
