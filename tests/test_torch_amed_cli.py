"""The port's AMED CLIs and checkpoints: ``cli.train_amed`` writes a run
directory whose files the JAX package reads, a predictor saved by the JAX
package loads in the port, and ``cli.sample --predictor`` restores every
solver setting from the sidecar.  The net is a tiny stand-in for the
CIFAR-10 entry of ``EDM_ARCHS`` (8x8, 8 channels, one level of 4 blocks
with attention), so the CLIs run in seconds on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.solvers import amed as JA
from diff_sampler_tpu.utils import checkpoint as jckpt
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed as cli_train
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models.convert import load_jax_params, params_to_jax
from diff_sampler_tpu_torch.ops import get_schedule
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.sampling import SolverConfig, generate, to_uint8
from diff_sampler_tpu_torch.solvers import amed as TA
from diff_sampler_tpu_torch.utils import checkpoint as ckpt
from diff_sampler_tpu_torch.utils.image import encode_png
from diff_sampler_tpu_torch.utils.rng import stacked_randn

TINY = (dict(img_resolution=8, img_channels=3, label_dim=0, model_type="SongUNet"),
        dict(model_channels=8, channel_mult=[1], num_blocks=4, attn_resolutions=[8],
             dropout=0.0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU,
    where torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cifar(monkeypatch):
    monkeypatch.setitem(factory.EDM_ARCHS, "cifar10", TINY)


def _bott(seed=0):
    return np.random.RandomState(seed).randn(3, 64).astype(np.float32)


def _jax_apply(params, bott, **kw):
    return JA.AMEDPredictor(**kw).apply({"params": params}, jnp.asarray(bott),
                                        jnp.asarray(2.0), jnp.asarray(0.5))


def test_train_amed_run_dir_loads_in_the_jax_package(tiny_cifar, tmp_path):
    run = cli_train.main(["--dataset_name=cifar10", "--model_path=random", "--batch=1000",
                          "--num_steps=3", "--total_kimg=1", "--device=cpu",
                          f"--outdir={tmp_path}"])
    assert os.path.basename(run) == "00000-cifar10-3-3-amed-heun"
    assert sorted(os.listdir(run)) == ["predictor.npz", "predictor_config.json", "stats.jsonl"]
    cfg = ckpt.load_config(os.path.join(run, "predictor_config.json"))
    assert (cfg["num_steps"], cfg["batch"], cfg["sigma_min"], cfg["sigma_max"]) == (3, 1000,
                                                                                    0.002, 80.0)
    with open(os.path.join(run, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    assert len(ticks) == 1 and ticks[0]["Loss/loss"]["num"] == 2  # one loss per segment
    assert np.isfinite(ticks[0]["Loss/loss"]["mean"]) and ticks[0]["sec_per_kimg"] > 0

    params = jckpt.load_params(os.path.join(run, "predictor.npz"))["params"]
    assert set(params) == {"map_layer0", "enc_layer0", "enc_layer1", "fc_r", "fc_scale_dir"}
    want = _jax_apply(params, _bott(), scale_dir=cfg["scale_dir"])
    pred = load_jax_params(cli_train.predictor_from_config(cli_train.AMEDConfig(**cfg)),
                           ckpt.load_params(os.path.join(run, "predictor.npz"))["params"])
    with torch.no_grad():
        got = pred(torch.from_numpy(_bott()), 2.0, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_jax_saved_predictor_loads_in_the_port(tmp_path):
    kw = dict(scale_dir=0.05, scale_time=0.1)
    params = JA.AMEDPredictor(**kw).init(jax.random.key(4), jnp.zeros((2, 64)),
                                         jnp.asarray(1.0), jnp.asarray(0.5))["params"]
    path = str(tmp_path / "predictor.npz")
    jckpt.save_params(path, jax.device_get(params))
    pred = load_jax_params(TA.AMEDPredictor(**kw), ckpt.load_params(path)["params"])
    with torch.no_grad():
        got = pred(torch.from_numpy(_bott(1)), 2.0, 0.5)
    for g, w in zip(got, _jax_apply(params, _bott(1), **kw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    # and back: the port's params_to_jax gives the JAX tree it came from
    back = params_to_jax(pred.state_dict())
    for layer, leaves in jax.device_get(params).items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], value)


def _fake_run(base, cfg):
    """A run directory as train_amed leaves it, with a seeded predictor."""
    run = ckpt.create_run_dir(str(base), "cifar10-3-3-euler-heun")
    ckpt.save_config(os.path.join(run, "predictor_config.json"), cfg)
    pred = factory.init_params(cli_train.predictor_from_config(cfg), seed=5)
    ckpt.save_params(os.path.join(run, "predictor.npz"), params_to_jax(pred.state_dict()))
    return run, pred


@pytest.mark.parametrize("how", ["run_dir", "npz", "number"])
def test_sample_predictor_restores_the_sidecar(tiny_cifar, tmp_path, monkeypatch, capsys, how):
    cfg = cli_train.AMEDConfig(num_steps=3, sampler_stu="euler", scale_dir=0.02,
                               scale_time=0.05)
    monkeypatch.chdir(tmp_path)
    run, pred = _fake_run(tmp_path / "exps", cfg)
    arg = {"run_dir": run, "npz": os.path.join(run, "predictor.npz"), "number": "0"}[how]
    seeds = list(range(5))
    cli_sample.main(["--dataset_name=cifar10", f"--predictor={arg}", "--seeds=0-4",
                     "--batch=2", "--device=cpu", "--outdir=out"])
    assert "student=euler steps=3 NFE=4" in capsys.readouterr().out

    # the same images, from the same (seeded) net and predictor directly
    module, _ = factory.create_model("cifar10", "random", device="cpu")
    t_steps = get_schedule(3, cfg.sigma_min, cfg.sigma_max, "polynomial", 7.0)
    with torch.no_grad():
        x = TA.amed_euler_sampler(TA.bind_with_bottleneck(module), pred.eval(),
                                  stacked_randn(seeds, (8, 8, 3), device="cpu"), t_steps).x
    want = to_uint8(x.numpy())
    for i, seed in enumerate(seeds):
        with open(os.path.join("out", "000000", f"{seed:06d}.png"), "rb") as f:
            assert f.read() == encode_png(want[i])


def test_train_amed_rejects_what_is_not_ported(tmp_path, capsys):
    for name in ("lsun_bedroom", "lsun_cat", "imagenet256"):  # ported: a dry run passes
        cli_train.main([f"--dataset_name={name}", "-n", f"--outdir={tmp_path}"])
        assert f'"dataset_name": "{name}"' in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="slice 10"):
        cli_train.main(["--dataset_name=cifar10", "--tp=2", f"--outdir={tmp_path}"])
    assert not os.listdir(tmp_path)


def test_train_amed_dry_run(capsys, tmp_path):
    assert cli_train.main(["--dataset_name=cifar10", "-n", "--batch_gpu=128",
                           f"--outdir={tmp_path}"]) is None
    out = capsys.readouterr().out
    assert '"batch_gpu": 128' in out and "Dry run" in out and not os.listdir(tmp_path)


def test_checkpoint_files_and_run_dirs_match_the_jax_package(tmp_path):
    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": np.ones(2, np.float32)}
    ckpt.save_params(str(tmp_path / "t.npz"), tree, opt={"m": np.zeros(3, np.float32)})
    for loaded in (jckpt.load_params(str(tmp_path / "t.npz")),
                   ckpt.load_params(str(tmp_path / "t.npz"))):
        np.testing.assert_array_equal(loaded["params"]["a"]["kernel"], tree["a"]["kernel"])
        np.testing.assert_array_equal(loaded["opt"]["m"], np.zeros(3))
    runs = [ckpt.create_run_dir(str(tmp_path / "exps"), "x") for _ in range(2)]
    assert [os.path.basename(r) for r in runs] == ["00000-x", "00001-x"]
    assert jckpt.create_run_dir(str(tmp_path / "exps"), "y").endswith("00002-y")
    assert ckpt.find_run_dir(str(tmp_path / "exps"), 1) == runs[1]
    assert ckpt.find_run_dir(str(tmp_path / "exps"), 7) is None


# A tiny stand-in for the class-conditional imagenet64 entry: DhariwalUNet at
# 8x8, 8 channels (no attention head fits), one level of 3 blocks, so the
# AMED tap ``enc_8x8_block2`` exists.
TINY_IN64 = (dict(img_resolution=8, img_channels=3, label_dim=3, model_type="DhariwalUNet"),
             dict(model_channels=8, channel_mult=[1], num_blocks=3, attn_resolutions=[8],
                  dropout=0.0))


def test_imagenet64_trains_and_samples_through_the_clis(tmp_path, monkeypatch, capsys):
    """train_amed on the conditional tier (the net bound without labels, as
    in the JAX CLI), then sample --predictor, whose PNGs are the AMED sampler
    on the unlabelled net; plain sampling draws a label per seed."""
    monkeypatch.setitem(factory.EDM_ARCHS, "imagenet64", TINY_IN64)
    monkeypatch.chdir(tmp_path)
    run = cli_train.main(["--dataset_name=imagenet64", "--model_path=random", "--batch=1000",
                          "--num_steps=3", "--total_kimg=1", "--afs=True", "--device=cpu",
                          "--outdir=exps"])
    assert os.path.basename(run) == "00000-imagenet64-3-3-amed-heun"
    cfg = cli_train.AMEDConfig(**ckpt.load_config(os.path.join(run, "predictor_config.json")))
    assert cfg.dataset_name == "imagenet64" and cfg.afs
    with open(os.path.join(run, "stats.jsonl")) as f:
        assert np.isfinite(json.loads(f.readline())["Loss/loss"]["mean"])

    seeds = list(range(3))
    cli_sample.main(["--dataset_name=imagenet64", f"--predictor={run}", "--seeds=0-2",
                     "--device=cpu", "--outdir=amed"])
    assert "student=amed steps=3 NFE=3" in capsys.readouterr().out
    module, _ = factory.create_model("imagenet64", "random", device="cpu")
    pred = load_jax_params(cli_train.predictor_from_config(cfg),
                           ckpt.load_params(os.path.join(run, "predictor.npz"))["params"])
    t_steps = get_schedule(3, cfg.sigma_min, cfg.sigma_max, "polynomial", 7.0)
    with torch.no_grad():
        x = TA.amed_sampler(TA.bind_with_bottleneck(module), pred.eval(),
                            stacked_randn(seeds, (8, 8, 3), device="cpu"), t_steps,
                            afs=True).x
    want = to_uint8(x.numpy())
    for i, seed in enumerate(seeds):
        with open(os.path.join("amed", "000000", f"{seed:06d}.png"), "rb") as f:
            assert f.read() == encode_png(want[i])

    # the random net's zero-init out_conv makes D = c_skip * x whatever the
    # labels, so the CLI is also checked to ask generate for them
    asked = []
    monkeypatch.setattr(cli_sample, "generate",
                        lambda *a, **kw: asked.append(kw["label_dim"]) or generate(*a, **kw))
    cli_sample.main(["--dataset_name=imagenet64", "--model_path=random", "--solver=euler",
                     "--num_steps=3", "--seeds=0-2", "--device=cpu", "--outdir=plain"])
    assert asked == [3]
    want = to_uint8(generate(bind(module), seeds, (8, 8, 3),
                             SolverConfig(solver="euler", num_steps=3), device="cpu",
                             label_dim=3))
    for i, seed in enumerate(seeds):
        with open(os.path.join("plain", "000000", f"{seed:06d}.png"), "rb") as f:
            assert f.read() == encode_png(want[i])
