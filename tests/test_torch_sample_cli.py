"""The port's sampling CLI with the JAX CLI's solver, schedule and GITS
flags, on tiny nets (a 16x16 SongUNet entry of ``EDM_ARCHS``, an 8x8 latent
LDM entry of ``LDM_CONFIGS``, monkeypatched in).

Each flag reaches a ``SolverConfig`` equal field by field to the one the JAX
CLI builds from the same arguments (its model and ``generate`` are replaced
by stubs that record the config).  The outputs: ``trajectory.npz``,
``grid.png`` (of the images, or of every trajectory point), PNGs without
subdirectories, and ``--dp=True``, whose ``dp_list`` is the port's
``gits_schedule`` on the same net and whose PNGs are ``generate`` on it.
"""

import dataclasses
import os

import numpy as np
import PIL.Image
import pytest
import torch

import diff_sampler_tpu.cli.sample as jcli
from diff_sampler_tpu_torch import sampling as S
from diff_sampler_tpu_torch.cli import sample as cli
from diff_sampler_tpu_torch.gits.search import GITSConfig, gits_schedule
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.utils.image import save_grid

TINY = (dict(img_resolution=16, img_channels=3, label_dim=0, model_type="SongUNet"),
        dict(model_channels=16, channel_mult=[1, 2], num_blocks=1, attn_resolutions=[8],
             dropout=0.0))
SHAPE = (16, 16, 3)
TINY_LDM = dict(
    linear_start=0.0015, linear_end=0.0195, timesteps=1000, scale_factor=1.0,
    conditioning_key=None, first_stage="vq",
    unet=dict(image_size=8, in_channels=3, out_channels=3, model_channels=32,
              attention_resolutions=(1,), num_res_blocks=1, channel_mult=(1,),
              num_head_channels=16),
    vae=dict(z_channels=3, resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=()),
    n_embed=32, embed_dim=3)

FLAG_SETS = [
    [],
    ["--solver=unipc", "--variant=bh1", "--max_order=2", "--predict_x0=False",
     "--lower_order_final=False"],
    ["--solver=deis", "--deis_mode=rhoab", "--afs=True", "--denoise_to_zero=True",
     "--num_steps=8"],
    ["--solver=dpm", "--r=0.3", "--schedule_type=logsnr", "--schedule_rho=5.0",
     "--sigma_min=0.01", "--sigma_max=40"],
    ["--solver=heun", "--t_steps=[80.0, 10.0, 1.0, 0.002]"],
    ["--solver=dpmpp", "--schedule_type=time_uniform", "--max_order=3", "--grid=True"],
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.setitem(factory.EDM_ARCHS, "tiny16", TINY)
    monkeypatch.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", TINY_LDM)
    monkeypatch.chdir(tmp_path)


def _recording_generate(store):
    def generate(den, seeds, shape, cfg, **kw):
        store.append(cfg)
        return np.zeros((len(seeds),) + tuple(shape), np.float32)
    return generate


@pytest.mark.parametrize("flags", FLAG_SETS, ids=[str(i) for i in range(len(FLAG_SETS))])
def test_flags_build_the_solver_config_of_the_jax_cli(tiny, monkeypatch, flags):
    class Stub:
        img_resolution, img_channels, label_dim = 16, 3, 0

    jax_cfgs, port_cfgs = [], []
    monkeypatch.setattr(jcli, "create_model", lambda *a, **k: (Stub(), None, "edm"))
    monkeypatch.setattr(jcli, "bind", lambda *a, **k: None)
    monkeypatch.setattr(jcli, "generate", _recording_generate(jax_cfgs))
    monkeypatch.setattr(jcli, "_save", lambda *a, **k: None)
    jcli.main.main(args=["--dataset_name=tiny16", "--seeds=0-1", "--outdir=jax", *flags],
                   standalone_mode=False)
    monkeypatch.setattr(cli, "generate", _recording_generate(port_cfgs))
    monkeypatch.setattr(cli, "_save", lambda *a, **k: None)
    cli.main(["--dataset_name=tiny16", "--seeds=0-1", "--outdir=port", "--device=cpu", *flags])
    assert dataclasses.asdict(port_cfgs[0]) == dataclasses.asdict(jax_cfgs[0])


def test_trajectory_npz(tiny):
    cli.main(["--dataset_name=tiny16", "--solver=unipc", "--num_steps=4",
              "--denoise_to_zero=True", "--return_inters=True", "--seeds=0-2", "--batch=2",
              "--device=cpu", "--outdir=out"])
    xs = np.load("out/trajectory.npz")["xs"]
    assert xs.shape == (5, 3) + SHAPE  # x_T, 3 steps, the denoise-to-zero output
    module, _ = factory.create_model("tiny16", "random", device="cpu")
    want = S.generate(bind(module), [0, 1, 2], SHAPE,
                      S.SolverConfig(solver="unipc", num_steps=4, denoise_to_zero=True),
                      max_batch_size=2, device="cpu", return_inters=True)
    np.testing.assert_array_equal(xs, want)


def _grid_of(images):
    save_grid(S.to_uint8(images), "want.png")
    return np.asarray(PIL.Image.open("want.png"))


def test_grid_of_images_and_of_the_trajectory(tiny):
    cli.main(["--dataset_name=tiny16", "--solver=ipndm", "--num_steps=3", "--seeds=0-4",
              "--grid=True", "--device=cpu", "--outdir=grid"])
    module, _ = factory.create_model("tiny16", "random", device="cpu")
    cfg = S.SolverConfig(solver="ipndm", num_steps=3)
    images = S.generate(bind(module), range(5), SHAPE, cfg, device="cpu")
    got = np.asarray(PIL.Image.open("grid/grid.png"))
    assert got.shape == (2 * 16, 3 * 16, 3)  # 5 images, 3 a row
    np.testing.assert_array_equal(got, _grid_of(images))
    assert os.listdir("grid") == ["grid.png"]

    cli.main(["--dataset_name=tiny16", "--solver=ipndm", "--num_steps=3", "--seeds=0-1",
              "--grid=True", "--return_inters=True", "--device=cpu", "--outdir=traj"])
    xs = S.generate(bind(module), range(2), SHAPE, cfg, device="cpu", return_inters=True)
    got = np.asarray(PIL.Image.open("traj/grid.png"))
    assert got.shape == (2 * 16, 3 * 16, 3)  # 3 points x 2 seeds
    np.testing.assert_array_equal(got, _grid_of(xs.reshape((-1,) + SHAPE)))


def test_subdirs_false_writes_flat(tiny):
    cli.main(["--dataset_name=tiny16", "--num_steps=2", "--solver=euler", "--seeds=998-1000",
              "--subdirs=False", "--device=cpu", "--outdir=flat"])
    assert sorted(os.listdir("flat")) == ["000998.png", "000999.png", "001000.png"]


@pytest.mark.parametrize("afs", [False, True], ids=["no-afs", "afs"])
def test_dp_searches_the_schedule_then_samples_on_it(tiny, capsys, afs):
    out = cli.main(["--dataset_name=tiny16", "--solver=ipndm", "--num_steps=4", "--dp=True",
                    "--num_steps_tea=9", "--num_warmup=4", "--metric=l2", f"--afs={afs}",
                    "--seeds=0-1", "--batch=2", "--device=cpu", "--outdir=dp"])
    module, _ = factory.create_model("tiny16", "random", device="cpu")
    den = bind(module)
    gcfg = GITSConfig(num_steps=4, num_steps_tea=9, num_warmup=4, metric="l2", afs=afs,
                      batch_size=2)
    dp_list, sigmas = gits_schedule(den, SHAPE, gcfg, device="cpu")
    assert out["dp_list"] == dp_list and out["gits_seconds"] > 0
    assert dp_list[0] == 0 and dp_list[-1] == 8 and len(dp_list) in ((5,) if afs else (4,))
    text = capsys.readouterr().out
    assert f"GITS dp_list: {dp_list}" in text
    cfg = S.SolverConfig(solver="ipndm", num_steps=9, dp_list=tuple(dp_list), afs=afs)
    assert f"NFE: {cfg.nfe()}" in text
    np.testing.assert_array_equal(cfg.resolve_t_steps(den.sigma_min, den.sigma_max), sigmas)
    images = S.to_uint8(S.generate(den, [0, 1], SHAPE, cfg, device="cpu"))
    for seed in (0, 1):
        got = np.asarray(PIL.Image.open(f"dp/000000/{seed:06d}.png"))
        np.testing.assert_array_equal(got, images[seed])


def test_latent_tier_keeps_an_asked_schedule_and_refuses_trajectories(tiny, capsys):
    cli.main(["--dataset_name=lsun_bedroom_ldm", "--solver=euler", "--num_steps=3",
              "--schedule_type=logsnr", "--seeds=0", "--device=cpu", "--outdir=ldm"])
    assert "schedule: logsnr(rho=7.0) | source: ldm" in capsys.readouterr().out
    cli.main(["--dataset_name=lsun_bedroom_ldm", "--solver=euler", "--t_steps=[80, 1, 0.01]",
              "--seeds=0", "--device=cpu", "--outdir=ldm_t"])
    assert "schedule: polynomial(rho=7.0) | source: ldm" in capsys.readouterr().out
    cli.main(["--dataset_name=lsun_bedroom_ldm", "--solver=euler", "--num_steps=3",
              "--seeds=0", "--device=cpu", "--outdir=ldm_d"])
    assert "schedule: discrete(rho=1.0) | source: ldm" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--return_inters is not supported for latent"):
        cli.main(["--dataset_name=lsun_bedroom_ldm", "--return_inters=True", "--device=cpu"])
