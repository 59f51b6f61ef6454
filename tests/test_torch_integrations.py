"""The port's AMED integrations and the trainers' ``log.txt``.

  * ``integrations/amed_export.py::export_amed_schedule`` against the JAX
    package's, the predictor's weights carried across
    (``convert.load_jax_params``) and both on the same latents and the
    same analytic denoiser: every number within 1e-5 (relative), the
    discrete ``timesteps`` equal;
  * ``integrations/diffusers_emulation.py``, the port's copy of the JAX
    emulator: the same outputs bit for bit;
  * the round trip of ``tests/test_diffusers_roundtrip.py`` on the port: its
    AMED DPM++(2M) sampler and the emulator of the diffusers plugin, driven
    by the exported schedule, produce the same images (1e-3, the JAX test's
    bound; measured ~1e-6);
  * ``utils/logger.py``, the port's copy of ``utils/common.py::Logger``,
    and the ``log.txt`` that ``cli.train_amed`` / ``cli.train_sfd`` write
    at tiny size: it holds every line the CLI printed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.integrations import amed_export as JE
from diff_sampler_tpu.integrations.diffusers_emulation import (
    AMEDDPMSolverMultistepEmulator as JaxEmulator)
from diff_sampler_tpu.models import analytic as JAN
from diff_sampler_tpu.solvers import amed as JAMED
from diff_sampler_tpu.utils import common as jcommon
from diff_sampler_tpu_torch.cli import train_amed, train_sfd
from diff_sampler_tpu_torch.integrations import amed_export as TE
from diff_sampler_tpu_torch.integrations.diffusers_emulation import (
    AMEDDPMSolverMultistepEmulator)
from diff_sampler_tpu_torch.models import analytic as TAN
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models.convert import load_jax_params
from diff_sampler_tpu_torch.models.precond import CFGPrecond
from diff_sampler_tpu_torch.ops import get_schedule
from diff_sampler_tpu_torch.solvers import amed as TAMED
from diff_sampler_tpu_torch.utils.logger import Logger
from test_diffusers_roundtrip import (MU, N_STEPS, SHAPE, SIGMA_MAX, SIGMA_MIN, VAR,
                                      _build_problem, _eps_from_sigma)

TINY = (dict(img_resolution=8, img_channels=3, label_dim=0, model_type="SongUNet"),
        dict(model_channels=8, channel_mult=[1], num_blocks=4, attn_resolutions=[8],
             dropout=0.0))
DATA = np.random.RandomState(5).randn(6, 4, 4, 4).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _latents(seeds, shape):
    return np.stack([np.random.RandomState(100 + int(s)).randn(*shape).astype(np.float32)
                     for s in seeds])


def _bottleneck(x):
    """[B, 4, 4, 4] -> a [B, 64] stand-in for the U-Net's pooled bottleneck."""
    return x.reshape(x.shape[0], 64) / 10.0


def test_export_matches_jax(monkeypatch):
    """A random predictor (r, scale_dir and scale_time heads) on the
    posterior mean over 6 points, 16 seeds, 5 steps; with an alphas_cumprod
    table the interleaved discrete timesteps too."""
    kw = dict(scale_dir=0.05, scale_time=0.1)
    params = JAMED.AMEDPredictor(**kw).init(jax.random.key(3), jnp.zeros((2, 64)),
                                            jnp.asarray(1.0), jnp.asarray(0.5))["params"]
    params = jax.tree.map(np.asarray, params)
    pred = load_jax_params(TAMED.AMEDPredictor(**kw, device="cpu"), params).eval()

    jden = JAN.DatasetPosteriorDenoiser(jnp.asarray(DATA))
    jden_b = JAMED.BottleneckDenoiser(fn=lambda x, t: (jden(x, t), _bottleneck(x)),
                                      plain_fn=jden, sigma_min=0.002, sigma_max=80.0)
    tden = TAN.DatasetPosteriorDenoiser(DATA, device="cpu")
    tden_b = TAMED.BottleneckDenoiser(fn=lambda x, t: (tden(x, t), _bottleneck(x)),
                                      plain_fn=tden, sigma_min=0.002, sigma_max=80.0)
    import diff_sampler_tpu.utils.rng as jrng

    monkeypatch.setattr(jrng, "stacked_randn",
                        lambda seeds, shape, *a, **k: jnp.asarray(_latents(seeds, shape)))
    monkeypatch.setattr(TE, "stacked_randn",
                        lambda seeds, shape, *a, **k: torch.from_numpy(_latents(seeds, shape)))
    ac = 1.0 / (1.0 + np.geomspace(0.002, 80.0, 300) ** 2)
    want = JE.export_amed_schedule(
        lambda b, tc, tn: JAMED.AMEDPredictor(**kw).apply({"params": params}, b, tc, tn),
        jden_b, (4, 4, 4), 5, 0.002, 80.0, alphas_cumprod=ac)
    ours = TE.export_amed_schedule(pred, tden_b, (4, 4, 4), 5, 0.002, 80.0, alphas_cumprod=ac,
                                   device="cpu")
    assert set(ours) == set(want)
    for k, v in want.items():
        if isinstance(v, list) and k != "timesteps":
            np.testing.assert_allclose(ours[k], v, rtol=1e-5, atol=0, err_msg=k)
        else:
            assert ours[k] == v, k
    assert len(set(ours["r"])) == 4  # the predictor's r differs by step
    t = np.asarray(ours["sigmas"])
    assert all(lo < m < hi for lo, m, hi in zip(t[1:], ours["t_mid"], t[:-1]))


def test_save_amed_schedule_round_trips(tmp_path):
    sched = {"sigmas": [80.0, 1.0], "r": [0.5], "timesteps": [999, 10, 0]}
    TE.save_amed_schedule(str(tmp_path / "ours.json"), sched)
    JE.save_amed_schedule(str(tmp_path / "jax.json"), sched)
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "jax.json").read_text()


@pytest.mark.parametrize("order,scale_time", [(2, 1.0), (3, 0.9), (1, 1.1)])
def test_emulator_is_bit_equal_to_jax(order, scale_time):
    ac, _pre, t_base = _build_problem()
    all_sigmas = np.sqrt((1.0 - ac) / ac)
    t_mid = np.sqrt(t_base[1:] * t_base[:-1])
    inter = np.empty(2 * (N_STEPS - 1) + 1)
    inter[0::2], inter[1::2] = t_base, t_mid
    timesteps = [int(np.abs(all_sigmas - s).argmin()) for s in inter]
    sd = 1.0 + 0.01 * np.random.RandomState(order).randn(len(inter))
    st = np.ones(len(inter))
    st[1::2] = scale_time
    x0 = np.random.RandomState(7).randn(3, *SHAPE) * t_base[0] / np.sqrt(1 + t_base[0] ** 2)
    outs = []
    for cls in (AMEDDPMSolverMultistepEmulator, JaxEmulator):
        emu = cls(ac, solver_order=order, lower_order_final=True)
        emu.set_timesteps(timesteps, sd, st)
        outs.append((emu.timesteps.copy(), emu.sample(
            lambda x, t_idx: _eps_from_sigma(x, all_sigmas[t_idx]), x0)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_amed_dpmpp_roundtrip_through_plugin_emulation():
    """tests/test_diffusers_roundtrip.py:77 on the port: r = 0.5 everywhere
    (a zeroed predictor), scale_time 1, an exact interleaved sigma grid, so
    the emulator's snapping is lossless."""
    ac, _jpre, t_base = _build_problem()
    pre = CFGPrecond(model_fn=None, alphas_cumprod=ac, img_resolution=4, img_channels=2,
                     guidance_type="uncond", guidance_rate=1.0, label_dim=0,
                     epsilon_t=1.0 / len(ac))

    def model_fn(x_vp, c_noise, cond):
        sigma_ve = pre.sigma((c_noise + 1.0) / pre.M).reshape((-1,) + (1,) * (x_vp.ndim - 1))
        x_ve = x_vp * torch.sqrt(1.0 + sigma_ve ** 2)
        x0 = (VAR * x_ve + sigma_ve ** 2 * MU) / (VAR + sigma_ve ** 2)
        return (x_ve - x0) / sigma_ve

    pre.model_fn = model_fn
    pred = TAMED.AMEDPredictor(device="cpu")
    with torch.no_grad():
        for p in pred.parameters():
            p.zero_()
    den_b = TAMED.BottleneckDenoiser(
        fn=lambda x, t: (pre(x, t), torch.zeros((x.shape[0], 64))),
        plain_fn=lambda x, t: pre(x, t), sigma_min=pre.sigma_min, sigma_max=pre.sigma_max)
    latents = torch.from_numpy(_latents(range(3), SHAPE))
    with torch.no_grad():
        out = TAMED.AMED_SOLVER_REGISTRY["dpmpp"](den_b, pred, latents, t_base, max_order=2,
                                                  lower_order_final=True).x.double().numpy()
    sched = TE.export_amed_schedule(pred, den_b, SHAPE, N_STEPS, SIGMA_MIN, SIGMA_MAX,
                                    alphas_cumprod=ac, seeds=range(3), device="cpu")
    np.testing.assert_allclose(sched["sigmas"], get_schedule(N_STEPS, SIGMA_MIN, SIGMA_MAX),
                               rtol=1e-12)
    np.testing.assert_allclose(sched["r"], 0.5, atol=1e-7)
    all_sigmas = np.sqrt((1.0 - ac) / ac)
    inter = np.empty(2 * (N_STEPS - 1) + 1)
    inter[0::2], inter[1::2] = t_base, sched["t_mid"]
    np.testing.assert_allclose(all_sigmas[sched["timesteps"]], inter, rtol=1e-7)

    emu = AMEDDPMSolverMultistepEmulator(ac, solver_order=2, lower_order_final=True)
    emu.set_timesteps(sched["timesteps"], sched["scale_dirs_interleaved"],
                      sched["scale_times_interleaved"])
    x_vp = emu.sample(lambda x, t_idx: _eps_from_sigma(x, all_sigmas[t_idx]),
                      latents.double().numpy() * t_base[0] / np.sqrt(1.0 + t_base[0] ** 2))
    out_emu = x_vp * np.sqrt(1.0 + inter[-1] ** 2)
    assert np.abs(out - out_emu).max() < 1e-3


def test_logger_tees_as_the_jax_logger(tmp_path, capsys):
    """The same bytes in the file and on stdout, stdout and stderr restored
    on close, appended in mode "a"."""
    for cls, name in ((Logger, "ours.txt"), (jcommon.Logger, "jax.txt")):
        for text in ("first\n", "second\n"):
            log = cls(str(tmp_path / name), "a")
            print(text, end="")
            print("to stderr", file=__import__("sys").stderr)
            log.close()
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "jax.txt").read_text() == \
        "first\nto stderr\nsecond\nto stderr\n"
    assert capsys.readouterr().out.count("first\n") == 2
    with Logger(None) as log:
        print("no file")
    assert log.file is None and "no file" in capsys.readouterr().out


def _printed_lines_in_log(run_dir, out):
    """Every line the CLI printed, from "Run dir: ..." on, is in log.txt in
    order (which also holds whatever went to stderr)."""
    with open(os.path.join(run_dir, "log.txt"), encoding="utf-8") as f:
        logged = f.read().splitlines()
    printed = out.splitlines()
    assert printed and printed[0] == f"Run dir: {run_dir}"
    rest = iter(logged)
    assert all(any(line == got for got in rest) for line in printed), (printed, logged)
    return logged


def test_train_amed_and_train_sfd_write_log_txt(monkeypatch, tmp_path, capsys):
    monkeypatch.setitem(factory.EDM_ARCHS, "cifar10", TINY)
    run = train_amed.main(["--dataset_name=cifar10", "--model_path=random", "--batch=1000",
                           "--num_steps=3", "--m=0", "--sampler_tea=euler", "--afs=True",
                           "--total_kimg=1", "--device=cpu",
                           f"--outdir={tmp_path / 'amed'}"])
    logged = _printed_lines_in_log(run, capsys.readouterr().out)
    assert any(line.startswith("kimg 1.00") for line in logged) and logged[-1] == "Done."
    assert sorted(os.listdir(run)) == ["log.txt", "predictor.npz", "predictor_config.json",
                                       "stats.jsonl"]
    run = train_sfd.main(["--dataset_name=cifar10", "--model_path=random", "--batch=1000",
                          "--num_steps=3", "--m=1", "--total_kimg=1", "--device=cpu",
                          f"--outdir={tmp_path / 'sfd'}"])
    logged = _printed_lines_in_log(run, capsys.readouterr().out)
    assert any(line.startswith("Saved ") for line in logged) and logged[-1] == "Done."
    assert "log.txt" in os.listdir(run)
