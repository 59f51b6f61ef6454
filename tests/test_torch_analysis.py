"""The port's trajectory analyzer (``analysis.py``,
``cli/analyze_trajectories.py``, ``cli/analyze_extend.py``) against the JAX
package's ``analysis.py`` and ``scripts/analyze_{trajectories,extend}.py``.

Functions: seeded f32 trajectories [9, 4, 2, 4, 4] through both.  The torch
statistics within 1e-5 * max|JAX| (both sum in f32 in other orders); the
numpy ones (PCA projection, Frenet and windowed curvature / torsion,
regularity projection, calibration) on the same float64 inputs bit for bit,
being the same numpy code.

CLIs: both packages' scripts at 8 px on the same denoiser (the posterior
mean over 6 images, whose trajectories curve) and the same latents (each
package's ``stacked_randn`` swapped for one numpy draw per seed).  Their
trajectories then differ by f32 rounding in the samplers (~1e-7 relative),
which the statistics carry at 1e-5 * max|JAX| (relative), but for the mean
windowed torsion of analyze_extend, a third derivative of a near-planar
curve, at 1e-3.
A tiny 8 px SongUNet runs the port's CLIs through ``create_model`` and
``bind`` as a user does.
"""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import diff_sampler_tpu.models.factory as jfactory
import diff_sampler_tpu.models.precond as jprecond
import diff_sampler_tpu.utils.rng as jrng
from diff_sampler_tpu import analysis as JAN
from diff_sampler_tpu.models import analytic as JA
from diff_sampler_tpu_torch import analysis as TAN
from diff_sampler_tpu_torch.cli import analyze_extend as ext
from diff_sampler_tpu_torch.cli import analyze_trajectories as traj_cli
from diff_sampler_tpu_torch.models import analytic as TA
from diff_sampler_tpu_torch.models import factory

REPO = pathlib.Path(__file__).resolve().parents[1]
RES = 8
DATA = np.random.RandomState(5).randn(6, RES, RES, 3).astype(np.float32) * 0.5
TINY = (dict(img_resolution=RES, img_channels=3, label_dim=0, model_type="SongUNet"),
        dict(model_channels=8, channel_mult=[1], num_blocks=1, attn_resolutions=[8],
             dropout=0.0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.fixture(scope="module")
def traj():
    """A trajectory, its gradients and schedule (xs [9, 4, 2, 4, 4])."""
    rng = np.random.RandomState(0)
    xs = np.cumsum(rng.randn(9, 4, 2, 4, 4), axis=0).astype(np.float32)
    eps = rng.randn(8, 4, 2, 4, 4).astype(np.float32)
    ref = (xs + 0.1 * rng.randn(*xs.shape)).astype(np.float32)
    t = np.linspace(80.0, 0.002, 9)
    return xs, eps, ref, t


@pytest.mark.parametrize("fn", ["trajectory_magnitude", "direction_cosines"])
def test_torch_statistics_match_jax(traj, fn):
    xs = traj[0]
    _close(getattr(TAN, fn)(torch.from_numpy(xs)).numpy(),
           getattr(JAN, fn)(jnp.asarray(xs)), 1e-5, fn)


def test_denoised_and_reference_deviation_match_jax(traj):
    xs, eps, ref, t = traj
    _close(TAN.denoised_trajectory(torch.from_numpy(xs), torch.from_numpy(eps), t).numpy(),
           JAN.denoised_trajectory(jnp.asarray(xs), jnp.asarray(eps), t), 1e-6, "denoised")
    _close(TAN.deviation_to_reference(torch.from_numpy(xs), torch.from_numpy(ref)).numpy(),
           JAN.deviation_to_reference(jnp.asarray(xs), jnp.asarray(ref)), 1e-5, "deviation")


def test_numpy_geometry_is_bit_equal_to_jax(traj):
    xs = traj[0]
    p3 = TAN.pca_project(torch.from_numpy(xs), 3)
    np.testing.assert_array_equal(p3, JAN.pca_project(jnp.asarray(xs), 3))
    ct, jct = TAN.discrete_curvature_torsion(p3), JAN.discrete_curvature_torsion(p3)
    for k in ("curvature", "torsion"):
        np.testing.assert_array_equal(ct[k], jct[k])
    proj = TAN.regularity_projection(torch.from_numpy(xs))
    jproj = JAN.regularity_projection(jnp.asarray(xs))
    for a, b in zip(proj, jproj):
        np.testing.assert_array_equal(a, b)
    kept = TAN.keep_central(*proj, ratio=0.75)
    for a, b in zip(kept, JAN.keep_central(*proj, ratio=0.75)):
        np.testing.assert_array_equal(a, b)
    for dim in (2, 3):
        for a, b in zip(TAN.procrustes_align(*proj, base_idx=1, proj_dim=dim),
                        JAN.procrustes_align(*proj, base_idx=1, proj_dim=dim)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TAN.arc_length(*proj), JAN.arc_length(*proj))
    for a, b in zip(TAN.windowed_curvature_torsion(*proj, window_size=5),
                    JAN.windowed_curvature_torsion(*proj, window_size=5)):
        np.testing.assert_array_equal(a, b)


def test_trajectory_report_matches_jax(traj):
    xs, eps, ref, t = traj
    ours = TAN.trajectory_report(torch.from_numpy(xs), torch.from_numpy(eps), t,
                                 torch.from_numpy(ref))
    want = JAN.trajectory_report(jnp.asarray(xs), jnp.asarray(eps), t, jnp.asarray(ref))
    assert set(ours) == set(want) and len(want) == 9
    for k in want:
        _close(ours[k], want[k], 1e-5, k)


def test_optimal_denoiser_matches_jax():
    images = np.random.RandomState(1).randint(0, 256, (5, RES, RES, 3), np.uint8)
    x = np.random.RandomState(2).randn(3, RES, RES, 3).astype(np.float32) * 2.0
    den = TAN.optimal_denoiser_from_images(images, device="cpu")
    jden = JAN.optimal_denoiser_from_images(images)
    assert (den.sigma_min, den.sigma_max) == (0.002, 80.0)
    for sigma in (0.5, 3.0):
        _close(den(torch.from_numpy(x), torch.tensor(sigma)).numpy(),
               jden(jnp.asarray(x), jnp.asarray(sigma)), 1e-5, f"D at {sigma}")


def _latents(seeds, shape):
    return np.stack([np.random.RandomState(1000 + int(s)).randn(*shape).astype(np.float32)
                     for s in seeds])


class _Stub:
    img_resolution, img_channels, label_dim = RES, 3, 0


@pytest.fixture
def same_model(monkeypatch):
    """Both packages' scripts on the posterior mean over ``DATA`` and on
    the same numpy latents."""
    monkeypatch.setattr(jfactory, "create_model", lambda *a, **k: (_Stub(), None, "edm"))
    monkeypatch.setattr(jprecond, "bind", lambda *a, **k: JA.DatasetPosteriorDenoiser(DATA))
    monkeypatch.setattr(jrng, "stacked_randn",
                        lambda seeds, shape, *a, **k: jnp.asarray(_latents(np.asarray(seeds),
                                                                           shape)))
    for mod in (traj_cli, ext):
        monkeypatch.setattr(mod, "create_model", lambda *a, **k: (_Stub(), "edm"))
        monkeypatch.setattr(mod, "bind",
                            lambda *a, **k: TA.DatasetPosteriorDenoiser(DATA, device="cpu"))
        monkeypatch.setattr(mod, "stacked_randn",
                            lambda seeds, shape, *a, **k: torch.from_numpy(_latents(seeds,
                                                                                    shape)))


def _reports_close(ours, want, keys):
    assert set(ours) == set(want) == set(keys)
    for k in keys:
        _close(ours[k], want[k], 1e-5, k)


def test_analyze_trajectories_matches_the_jax_script(same_model, tmp_path):
    """The default run with ``--data`` (the optimal-denoiser comparison on 4
    PNGs), then ``--num_images=10`` at batch 4 (a ragged last batch)."""
    data = tmp_path / "data"
    data.mkdir()
    for i, img in enumerate(np.random.RandomState(3).randint(0, 256, (4, RES, RES, 3),
                                                             np.uint8)):
        PIL.Image.fromarray(img).save(data / f"{i}.png")
    jscript = _script("analyze_trajectories")
    common = ["--dataset_name=cifar10", "--model_path=random", "--num_steps=7", "--batch=4"]
    for tag, extra, keys in (("with_data", [f"--data={data}"], ["magnitude", "deviation", "segment_lengths",
                                              "direction_cosine", "curvature",
                                              "denoised_magnitude", "deviation_to_reference",
                                              "pca_curvature", "pca_torsion"]),
                        ("num_images", ["--num_images=10"], ["magnitude", "deviation", "segment_lengths",
                                               "direction_cosine", "curvature",
                                               "denoised_magnitude"])):
        jscript.main.main(args=[*common, *extra, f"--outdir={tmp_path / ('jax_' + tag)}"],
                          standalone_mode=False)
        ours = traj_cli.main([*common, *extra, f"--outdir={tmp_path / tag}", "--device=cpu"])
        report = json.loads((tmp_path / tag / "report.json").read_text())
        want = json.loads((tmp_path / ("jax_" + tag) / "report.json").read_text())
        _reports_close(report, want, keys)
        _reports_close({k: np.asarray(v) for k, v in ours.items()}, want, keys)
        assert len(report["magnitude"]) == 7 and len(report["curvature"]) == 5
    assert (tmp_path / "with_data" / "geometry.png").exists()


@pytest.mark.parametrize("mode", ["sampling", "low_rank_mog"])
def test_analyze_extend_matches_the_jax_script(same_model, tmp_path, mode):
    """One model mode (the posterior-mean stub) and one approximated-score
    mode on the synthetic dataset: the same stats JSON and the three PNGs."""
    jscript = _script("analyze_extend")
    args = [f"--mode={mode}", "--num_steps=21", "--batch=5", f"--resolution={RES}",
            "--rank=4", "--window=11"]
    jscript.main.main(args=[*args, f"--outdir={tmp_path / 'jax'}"], standalone_mode=False)
    ours = ext.main([*args, f"--outdir={tmp_path / 'port'}", "--device=cpu"])
    want = json.loads((tmp_path / "jax" / f"stats_{mode}.json").read_text())
    assert json.loads((tmp_path / "port" / f"stats_{mode}.json").read_text()) == ours
    assert {k: ours[k] for k in ("mode", "num_steps", "batch", "window_size")} == {
        k: want[k] for k in ("mode", "num_steps", "batch", "window_size")}
    assert ours["mean_final_norm"] == pytest.approx(want["mean_final_norm"], rel=1e-5)
    assert ours["mean_curvature"] == pytest.approx(want["mean_curvature"], rel=1e-5)
    # the torsion's third derivative of a near-planar curve carries the
    # samplers' f32 rounding at up to 4e-4 relative
    assert ours["mean_abs_torsion"] == pytest.approx(want["mean_abs_torsion"], rel=1e-3)
    for name in ("traj_3d_raw", "traj_3d_calibrated", "curv_tors"):
        assert (tmp_path / "port" / f"{name}_{mode}.png").exists()


@pytest.mark.parametrize("mode", ["full_rank_gaussian", "low_rank_gaussian", "full_rank_mog",
                                  "low_rank_mog"])
def test_approximated_score_denoisers_match_jax(mode):
    """``build_denoiser`` of each approximated-score mode on the synthetic
    dataset: D within 1e-5 * max of the JAX script's."""
    den, res, ch = ext.build_denoiser(mode, "cifar10", "random", None, 4, RES, device="cpu")
    jden, jres, jch = _script("analyze_extend").build_denoiser(mode, "cifar10", "random", None,
                                                               4, RES)
    assert (res, ch) == (jres, jch) == (RES, 3)
    x = np.random.RandomState(4).randn(3, RES, RES, 3).astype(np.float32)
    for sigma in (0.3, 5.0):
        _close(den(torch.from_numpy(x), torch.tensor(sigma)).numpy(),
               jden(jnp.asarray(x), jnp.asarray(sigma)), 1e-5, f"{mode} at {sigma}")


def test_port_clis_run_a_tiny_songunet(monkeypatch, tmp_path):
    """``create_model`` and ``bind`` as a user runs them, on an 8 px
    SongUNet under the cifar10 name; the ``--num_images`` statistics equal
    the per-batch statistics combined on the host in float64."""
    monkeypatch.setitem(factory.EDM_ARCHS, "cifar10", TINY)
    common = ["--num_steps=5", "--batch=3", "--device=cpu"]
    report = traj_cli.main([*common, f"--outdir={tmp_path / 'a'}"])
    assert all(np.isfinite(np.asarray(v)).all() for v in report.values())
    big = traj_cli.main([*common, "--num_images=7", f"--outdir={tmp_path / 'b'}"])
    module, _ = factory.create_model("cifar10", "random", device="cpu")
    from diff_sampler_tpu_torch.models.precond import bind
    from diff_sampler_tpu_torch.ops import get_schedule
    from diff_sampler_tpu_torch.solvers import get_sampler
    from diff_sampler_tpu_torch.utils.rng import stacked_randn

    t = get_schedule(5, 0.002, 80.0)
    per_sample = {k: [] for k in big}
    with torch.no_grad():
        for seeds in ([0, 1, 2], [3, 4, 5], [6]):
            out = get_sampler("ipndm")(bind(module), stacked_randn(seeds, (RES, RES, 3),
                                                                   device="cpu"),
                                       t, return_inters=True)
            for k, v in traj_cli.batch_stat_sums(out.xs, out.eps, t).items():
                per_sample[k].append(v.double().numpy())
    for k, v in big.items():
        _close(v, np.sum(per_sample[k], axis=0) / 7, 1e-12, k)
    stats = ext.main(["--mode=sampling", "--num_steps=9", "--batch=3", "--window=5",
                      f"--outdir={tmp_path / 'c'}", "--device=cpu"])
    assert np.isfinite([stats["mean_curvature"], stats["mean_abs_torsion"],
                        stats["mean_final_norm"]]).all()
