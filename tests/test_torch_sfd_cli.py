"""The port's ``cli.train_sfd`` and the SFD side of ``cli.sample``.

The nets are tiny stand-ins, monkeypatched into the tier tables so that
the CLIs run in seconds on the CPU: CIFAR-10's ``EDM_ARCHS`` entry as
tests/test_torch_amed_cli.py makes it (8x8, 8 channels, one level of 4
blocks with attention), the LSUN LDM's and Stable Diffusion's
``LDM_CONFIGS`` entries as tests/test_torch_ldm.py and
tests/test_torch_sd.py make them (8x8 latents).  Samples are compared byte
for byte, as PNGs, with ``generate`` on the student loaded from the
snapshot; a resumed run's snapshot bit for bit with an unbroken run's.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.utils import checkpoint as jckpt
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_sfd as cli_train
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.models.convert import (ldm_params_from_jax, load_jax_params,
                                                   params_to_jax)
from diff_sampler_tpu_torch.models.precond import bind
from diff_sampler_tpu_torch.sampling import SolverConfig, generate, to_uint8
from diff_sampler_tpu_torch.utils import checkpoint as ckpt
from diff_sampler_tpu_torch.utils.image import encode_png
from test_torch_ldm import TINY_CLI as LDM_TINY
from test_torch_sd import TINY_CLI as SD_TINY

TINY = (dict(img_resolution=8, img_channels=3, label_dim=0, model_type="SongUNet"),
        dict(model_channels=8, channel_mult=[1], num_blocks=4, attn_resolutions=[8],
             dropout=0.0))
SEEDS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_tiers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(factory.EDM_ARCHS, "cifar10", TINY)
        mp.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", LDM_TINY)
        mp.setitem(TL.LDM_CONFIGS, "ms_coco", SD_TINY)
        yield


def _train(outdir, *argv):
    return cli_train.main([f"--outdir={outdir}", "--model_path=random", "--device=cpu",
                           "--num_steps=3", "--m=1", *argv])


def _unit_scale(module, seed=0):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                    / math.sqrt(fan_in))
    return module


@pytest.fixture(scope="module")
def cifar_run(tiny_tiers, tmp_path_factory):
    """Two iterations of 500 trajectories (3 steps, M=1, AFS), a tick and a
    snapshot each, from a start written as a params .npz (the path a second
    stage takes) at unit scale, so that the net shows in the samples."""
    out = tmp_path_factory.mktemp("exps")
    start = str(out / "start.npz")
    ckpt.save_params(start, params_to_jax(_unit_scale(
        factory.init_params(factory.build_edm_model("cifar10", device="cpu"))).state_dict()))
    return cli_train.main([f"--outdir={out}", f"--model_path={start}", "--device=cpu",
                           "--num_steps=3", "--m=1", "--dataset_name=cifar10", "--batch=500",
                           "--total_kimg=1", "--tick=1", "--snap=1"])


def _pngs(outdir, seeds=SEEDS):
    out = []
    for seed in range(seeds):
        with open(os.path.join(outdir, f"{seed:06d}.png"), "rb") as f:
            out.append(f.read())
    return out


def _sample(tmp_path, *argv):
    out = tmp_path / "samples"
    cli_sample.main([*argv, f"--seeds=0-{SEEDS - 1}", f"--batch={SEEDS}", "--device=cpu",
                     f"--outdir={out}", "--subdirs=False"])
    return out


def test_train_sfd_run_dir_loads_in_the_jax_package(cifar_run):
    """The run dir holds the JAX CLI's files; its snapshot's params have the
    JAX student's tree, and its optimizer leaves unflatten into
    ``optax.adam(schedule)``'s state (the JAX CLI's --resume path) with
    count 2 (2 iterations of 3 steps under AFS: one update each)."""
    assert os.path.basename(cifar_run) == "00000-cifar10-3step-dpmpp1"
    assert sorted(os.listdir(cifar_run)) == ["log.txt", "snapshot-000000.npz",
                                             "snapshot-000001.npz", "stats.jsonl",
                                             "training_options.json"]
    opts = ckpt.load_config(os.path.join(cifar_run, "training_options.json"))
    assert (opts["num_steps"], opts["M"], opts["afs"], opts["sigma_min"], opts["batch"]) == (
        3, 1, True, 0.006, 500)
    with open(os.path.join(cifar_run, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    assert len(ticks) == 2 and all(math.isfinite(t["Loss/loss"]["mean"]) for t in ticks)

    loaded = jckpt.load_params(os.path.join(cifar_run, "snapshot-000001.npz"))
    net = JP.EDMPrecond(img_resolution=8, img_channels=3, label_dim=0, model_type="SongUNet",
                        model_kwargs=TINY[1])
    shapes = jax.eval_shape(net.init, jax.random.key(0), jnp.zeros((1, 8, 8, 3)),
                            jnp.ones((1,)))["params"]
    assert jax.tree.structure(shapes) == jax.tree.structure(loaded["params"])
    opt = optax.adam(optax.join_schedules([optax.constant_schedule(5e-5),
                                           optax.constant_schedule(5e-6)], [2]))
    struct = jax.eval_shape(opt.init, shapes)
    leaves = [loaded["opt_state"][k] for k in sorted(loaded["opt_state"])]
    state = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(struct), leaves)
    for got, want in zip(jax.tree.leaves(state), jax.tree.leaves(struct)):
        assert got.shape == want.shape and got.dtype == want.dtype
    assert int(state[0].count) == int(state[1].count) == 2
    assert int(loaded["meta"]["cur_nimg"][0]) == 1000


@pytest.mark.parametrize("skip_tuning", [False, True])
def test_sample_from_run_dir_restores_settings(cifar_run, tmp_path, capsys, skip_tuning):
    """``cli.sample --model_path=<run dir>``: euler at the training's 3 steps
    on poly-7 with AFS, the student at the sampling sigma_min 0.002, its
    PNGs byte for byte ``generate`` on the snapshot's student, with and
    without ``--skip_tuning`` (which changes the samples)."""
    out = _sample(tmp_path, "--dataset_name=cifar10", f"--model_path={cifar_run}",
                  "--solver=ipndm", "--num_steps=6", f"--skip_tuning={skip_tuning}")
    assert ("Restored SFD sampling settings: num_steps=3 schedule=polynomial(7.0) afs=True"
            in capsys.readouterr().out)
    student = load_jax_params(factory.init_params(factory.build_edm_model(
        "cifar10", device="cpu")), ckpt.load_params(
        os.path.join(cifar_run, "snapshot-000001.npz"))["params"])
    assert student.sigma_min == 0.002
    cfg = SolverConfig(solver="euler", num_steps=3, afs=True)
    images = {st: generate(bind(student, **({"skip_tuning": True} if st else {})),
                           list(range(SEEDS)), (8, 8, 3), cfg, max_batch_size=SEEDS,
                           device="cpu") for st in (False, True)}
    want = [encode_png(im) for im in to_uint8(images[skip_tuning])]
    assert _pngs(out) == want
    assert np.abs(images[True] - images[False]).max() > 1e-3


def test_sfdv_snapshot_samples_without_its_step_condition(tiny_tiers, tmp_path):
    """A suspected reference fault, matched: the JAX sampling CLI never binds
    an SFD-v student's step condition, so its trained ``affine_step`` is
    unused at sampling.  The CLI's PNGs equal ``generate`` on the student
    without a step condition, and differ from those with step_condition =
    num_steps (unit-scale weights, so that the modulation shows)."""
    student = cli_train._create_student("cifar10", "random", True, False, "cpu")
    _unit_scale(student.module)
    run = tmp_path / "00003-cifar10-4step-dpmpp3"
    run.mkdir()
    ckpt.save_config(str(run / "training_options.json"),
                     dict(dataset_name="cifar10", num_steps=4, schedule_type="polynomial",
                          schedule_rho=7.0, afs=False, use_step_condition=True))
    opt = torch.optim.Adam([p for _, p in student.named])
    cli_train.save_snapshot(str(run / "snapshot-000000.npz"), student, opt, 0)
    out = _sample(tmp_path, "--dataset_name=cifar10", f"--model_path={run}", "--num_steps=4")
    pre = student.module
    pre.sigma_min = 0.002
    cfg = SolverConfig(solver="euler", num_steps=4)
    without, with_sc = (generate(bind(pre, **kw), list(range(SEEDS)), (8, 8, 3), cfg,
                                 max_batch_size=SEEDS, device="cpu")
                        for kw in ({}, {"step_condition": 4.0}))
    assert _pngs(out) == [encode_png(im) for im in to_uint8(without)]
    assert np.abs(with_sc - without).max() > 0.05


def test_resume_continues_bit_equal(tiny_tiers, tmp_path):
    """Batch 1000 for 2 kimg, the lr dropping after the first iteration's
    two updates: resumed from the first iteration's snapshot, the run's
    final snapshot (params, Adam's moments and count) equals the unbroken
    run's bit for bit."""
    args = ["--dataset_name=cifar10", "--batch=1000", "--total_kimg=2", "--tick=1", "--snap=1",
            "--afs=False", "--seed=3"]
    whole = _train(tmp_path / "a", *args)
    resumed = _train(tmp_path / "b", *args,
                     f"--resume={os.path.join(whole, 'snapshot-000001.npz')}")
    assert sorted(os.listdir(resumed)) == ["log.txt", "snapshot-000002.npz", "stats.jsonl",
                                           "training_options.json"]
    with np.load(os.path.join(whole, "snapshot-000002.npz")) as a, \
            np.load(os.path.join(resumed, "snapshot-000002.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        first = np.load(os.path.join(whole, "snapshot-000001.npz"))
        assert not np.array_equal(first["opt_state/000000"], a["opt_state/000000"])


def test_latent_student_trains_and_samples(tiny_tiers, tmp_path, capsys):
    """The LSUN LDM tier: two iterations of 500 latent trajectories, then
    ``cli.sample`` from the run dir rebuilds the stack from the training's
    model_path ('random'), swaps in the snapshot's U-Net and samples on the
    discrete schedule (the training's polynomial switches to it) with the
    restored settings; its PNGs equal ``generate`` + the decode on that
    stack."""
    run = _train(tmp_path, "--dataset_name=lsun_bedroom_ldm", "--guidance_type=uncond",
                 "--batch=500", "--total_kimg=1")
    out = _sample(tmp_path, "--dataset_name=lsun_bedroom_ldm", f"--model_path={run}")
    assert "Restored SFD sampling settings: num_steps=3" in capsys.readouterr().out
    pre, _ = factory.create_model("lsun_bedroom_ldm", "random", device="cpu")
    unet = pre.latent_diffusion.unet
    unet.load_state_dict(ldm_params_from_jax(ckpt.load_params(
        os.path.join(run, "snapshot-000001.npz"))["params"], unet.state_dict()))
    cfg = SolverConfig(solver="euler", num_steps=3, afs=True, schedule_type="discrete",
                       schedule_rho=1.0)
    lat = generate(bind(pre), list(range(SEEDS)), (8, 8, 3), cfg, max_batch_size=SEEDS,
                   device="cpu")
    images = pre.latent_diffusion.decode_in_chunks(lat)
    assert _pngs(out) == [encode_png(im) for im in to_uint8(images)]


def test_ms_coco_forces_128_accumulation(tiny_tiers, tmp_path, capsys):
    """ms_coco forces an effective batch of 128 through accumulation rounds
    of fresh trajectories (training_loop.py:227,246): --batch=64 -> 2 rounds
    of 64, 128 trajectories an iteration, 8 iterations to the kimg, on
    seeded random contexts (no captions)."""
    run = _train(tmp_path, "--dataset_name=ms_coco", "--guidance_type=cfg",
                 "--guidance_rate=7.5", "--batch=64", "--total_kimg=1", "--tick=4",
                 "--snap=2")
    text = capsys.readouterr().out
    assert "Gradient accumulation: 2 rounds of 64" in text and "(batch 128)" in text
    with open(os.path.join(run, "stats.jsonl")) as f:
        ticks = [json.loads(line) for line in f]
    assert [t["kimg"] for t in ticks] == [0.512, 1.024]
    assert all(t["Loss/loss"]["num"] == 8 for t in ticks)  # 4 iterations x 2 segments
    opts = ckpt.load_config(os.path.join(run, "training_options.json"))
    assert opts["guidance_rate"] == 7.5 and opts["guidance_type"] == "cfg"


REFUSALS = [
    # --tp and --sp are ported: one process does not split into groups of 2
    (["--dataset_name=cifar10", "--tp=2"], ValueError, "model groups of --tp=2"),
    (["--dataset_name=cifar10", "--sp=2"], ValueError, "seq groups of --sp=2"),
    # --fsdp is ported (one process runs it whole): the JAX CLI's exclusion
    (["--dataset_name=cifar10", "--fsdp", "--tp=2"], ValueError, "mutually exclusive"),
    (["--dataset_name=ms_coco"], ValueError, "guidance_type=cfg"),
    (["--dataset_name=lsun_bedroom_ldm", "--guidance_type=cfg"], ValueError,
     "guidance_type=uncond"),
    (["--dataset_name=cifar10", "--num_steps=1"], ValueError, "out of range"),
    (["--dataset_name=cifar10", "--batch=100", "--batch_gpu=30"], ValueError, "divisible"),
]


@pytest.mark.parametrize("argv,exc,match", REFUSALS, ids=[" ".join(a) for a, _, _ in REFUSALS])
def test_train_sfd_refusals(tiny_tiers, tmp_path, argv, exc, match):
    with pytest.raises(exc, match=match):
        _train(tmp_path, *argv)


@pytest.mark.parametrize("argv", [["--dataset_name=lsun_bedroom_ldm"],
                                  ["--dataset_name=cifar10", "--predictor=0"]])
def test_sample_refuses_skip_tuning_off_the_edm_path(argv):
    with pytest.raises(NotImplementedError, match="--skip_tuning"):
        cli_sample.main([*argv, "--skip_tuning=True", "--device=cpu"])


def test_dry_run_prints_the_jax_options(capsys, tmp_path):
    assert cli_train.main(["--dataset_name=cifar10", "-n", f"--outdir={tmp_path}"]) is None
    text = capsys.readouterr().out
    opts = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert list(opts)[:8] == ["dataset_name", "batch", "lr", "total_kimg", "seed",
                              "model_path", "guidance_type", "guidance_rate"]
    assert opts["sigma_min"] == 0.006 and opts["afs"] is True and not os.listdir(tmp_path)
