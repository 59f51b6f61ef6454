"""The port's GITS search and trajectory geometry against the JAX
package's.

Cost matrices at the three metrics on one teacher trajectory (f32, 1e-5 of
max|cost|), ``dp_search`` and ``dp_search_multi`` bit for bit on random
upper-triangular costs, the geometry functions (1e-5 of max), and
``gits_schedule`` end to end: the same ``dp_list`` with and without the AFS
insertion search, for the LMS family, dpmpp and unipc.  Both packages draw
their warmup latents from their own ``stacked_randn`` (threefry bits and
PyTorch's); the test swaps each module's ``stacked_randn`` for one numpy
draw per seed so both search on the same latents.  The end-to-end denoiser is
the posterior mean over 6 points: its trajectories curve, where a Gaussian's
are straight lines whose "dev" cost is rounding noise on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diff_sampler_tpu.gits.search as JG
import diff_sampler_tpu_torch.gits.search as TG
from diff_sampler_tpu.models import analytic as JA
from diff_sampler_tpu.ops import geometry as JGEO
from diff_sampler_tpu.ops import get_schedule
from diff_sampler_tpu.solvers import get_sampler as jax_sampler
from diff_sampler_tpu_torch.models import analytic as TA
from diff_sampler_tpu_torch.ops import geometry as TGEO
from diff_sampler_tpu_torch.solvers import get_sampler

SAMPLE = (2, 4, 4)
DATA = np.random.RandomState(5).randn(6, *SAMPLE).astype(np.float32)


def _latents(seeds, shape):
    return np.stack([np.random.RandomState(1000 + int(s)).randn(*shape).astype(np.float32)
                     for s in seeds])


@pytest.fixture
def same_latents(monkeypatch):
    monkeypatch.setattr(JG, "stacked_randn",
                        lambda seeds, shape, *a, **k: jnp.asarray(_latents(np.asarray(seeds),
                                                                           shape)))
    monkeypatch.setattr(TG, "stacked_randn",
                        lambda seeds, shape, *a, **k: torch.from_numpy(_latents(seeds, shape)))


@pytest.fixture(scope="module")
def teacher():
    """An ipndm trajectory [9, 4, 2, 4, 4] and its gradients on the
    posterior-mean denoiser."""
    t = get_schedule(9, 0.002, 80.0, "polynomial", 7.0)
    lat = np.random.RandomState(1).randn(4, *SAMPLE).astype(np.float32)
    out = jax_sampler("ipndm")(JA.DatasetPosteriorDenoiser(DATA), jnp.asarray(lat), t,
                               return_inters=True)
    return np.array(out.xs), np.array(out.eps), t


@pytest.mark.parametrize("metric", ["l1", "l2", "dev"])
def test_cost_matrix_matches_jax(teacher, metric):
    xs, eps, t = teacher
    ref = np.asarray(JG.compute_cost_matrix(jnp.asarray(xs), jnp.asarray(eps), t, metric))
    ours = TG.compute_cost_matrix(torch.from_numpy(xs), torch.from_numpy(eps), t, metric).numpy()
    assert ours.shape == (9, 9)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.all(ours[np.tril_indices(9)] == 0)


def test_cost_matrix_rejects_an_unknown_metric(teacher):
    xs, eps, t = teacher
    with pytest.raises(NotImplementedError, match="Unknown metric"):
        TG.compute_cost_matrix(torch.from_numpy(xs), torch.from_numpy(eps), t, "cos")


@pytest.mark.parametrize("n_tea", [11, 21])
def test_dp_search_is_bit_equal_to_jax(n_tea):
    cost = np.triu(np.random.RandomState(n_tea).rand(n_tea, n_tea), k=1)
    for num_steps in (3, 4, 6, 8):
        for coeff in (0.9, 1.0, 1.15):
            ours = TG.dp_search(cost, num_steps, n_tea, coeff)
            assert ours == JG.dp_search(cost, num_steps, n_tea, coeff)
            assert ours[0] == 0 and ours[-1] == n_tea - 1 and len(ours) == num_steps
            assert all(a < b for a, b in zip(ours, ours[1:]))


def test_dp_search_multi_is_bit_equal_to_jax(tmp_path):
    cost = np.triu(np.random.RandomState(2).rand(11, 11), k=1)
    t = np.linspace(80.0, 0.002, 11)
    ours = TG.dp_search_multi(cost, 6, 11, dump_path=str(tmp_path / "ours.txt"), desc="x",
                              t_steps=t)
    ref = JG.dp_search_multi(cost, 6, 11, dump_path=str(tmp_path / "ref.txt"), desc="x",
                             t_steps=t)
    assert ours == ref and (1.15, 5) in ours
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "ref.txt").read_text()


@pytest.mark.parametrize("fn", ["trajectory_deviation", "trajectory_lengths",
                                "trajectory_curvature"])
def test_geometry_matches_jax(teacher, fn):
    xs = teacher[0]
    ref = np.asarray(getattr(JGEO, fn)(jnp.asarray(xs)))
    ours = getattr(TGEO, fn)(torch.from_numpy(xs)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_gits_config_defaults_match_jax():
    assert TG.GITSConfig() == TG.GITSConfig(**vars(JG.GITSConfig()))


@pytest.mark.parametrize("afs", [False, True], ids=["no-afs", "afs"])
@pytest.mark.parametrize("solver,metric", [("ipndm", "dev"), ("deis", "l2"), ("dpmpp", "dev"),
                                           ("unipc", "l1"), ("heun", "dev")])
def test_gits_schedule_matches_jax(same_latents, solver, metric, afs):
    cfg = dict(num_steps=5, num_steps_tea=13, num_warmup=8, batch_size=4, metric=metric,
               afs=afs, solver=solver)
    ref = JG.gits_schedule(JA.DatasetPosteriorDenoiser(DATA), SAMPLE, JG.GITSConfig(**cfg),
                           return_cost=True)
    ours = TG.gits_schedule(TA.DatasetPosteriorDenoiser(DATA, device="cpu"), SAMPLE, TG.GITSConfig(**cfg),
                            return_cost=True, device="cpu")
    assert ours[0] == ref[0]
    assert len(ours[0]) == 5 + (1 if afs and len(ref[0]) == 6 else 0)
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-5 * np.abs(ref[2]).max())


def test_gits_schedule_with_per_seed_conditioning(same_latents):
    """Each warmup batch runs on its own conditioning rows: a denoiser that
    shifts toward c gives the search the same cost matrix as the JAX one."""
    cond = np.random.RandomState(3).randn(8, 1).astype(np.float32) * 0.5
    jd, td = JA.DatasetPosteriorDenoiser(DATA), TA.DatasetPosteriorDenoiser(DATA, device="cpu")
    cfg = dict(num_steps=4, num_steps_tea=9, num_warmup=8, batch_size=4, afs=True)
    ref = JG.gits_schedule(jd, SAMPLE, JG.GITSConfig(**cfg), per_seed_cond=cond,
                           denoise_with_cond=lambda x, t, c: jd(x, t) + c[:, :, None, None] * 0.1,
                           return_cost=True)
    ours = TG.gits_schedule(td, SAMPLE, TG.GITSConfig(**cfg), per_seed_cond=cond,
                            denoise_with_cond=lambda x, t, c: td(x, t) + c[:, :, None, None] * 0.1,
                            return_cost=True, device="cpu")
    assert ours[0] == ref[0]
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-5 * np.abs(ref[2]).max())
