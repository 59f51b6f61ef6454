"""Data and sequence parallelism of the port (``parallel/``, the CLIs'
multi-process paths) on the CPU, in gloo processes.

Three launches of ``tests/torch_dist_jobs.py`` (two processes each, one
per module fixture, 120 s limit each):

  * ``generate`` over 2 data ranks against the JAX ``generate`` on a
    2-device mesh (per-seed numpy latents and labels on both sides, an
    analytic denoiser; unlabelled with its trajectory, labelled, per-seed
    rows), the stats ``Collector`` across ranks whose names differ,
    ``JsonlWriter`` and ``create_run_dir``;
  * the sampling CLI: PNGs byte-equal to one process, GITS's ``dp_list``
    equal to one process's, ``--sp=2`` on a tiny LDM within one uint8 level
    of ``--sp=1`` with the ring dispatched;
  * ``train_amed`` and ``train_sfd``, data parallel and with ``--sp=2``,
    against one process after 2 iterations, with only process 0's files.

In one process: the launcher's kill on failure and on timeout, the
environment surface, the layout and the CLIs' refusals of the parallel
flags (the JAX CLIs' exclusions, and a degree that one process cannot
split into).
"""

import json
import os
import pathlib
import time

import numpy as np
import PIL.Image
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import diff_sampler_tpu.sampling as JS
import diff_sampler_tpu.utils.rng as JR
from diff_sampler_tpu.models.precond import BoundDenoiser as JBoundDenoiser
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed, train_sfd
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.ops import ring_attention as RA
from diff_sampler_tpu_torch.parallel import mesh
from diff_sampler_tpu_torch.parallel.launch import run_local
from diff_sampler_tpu_torch.utils import checkpoint as ckpt

import torch_dist_jobs as J

REPO = pathlib.Path(__file__).resolve().parents[1]
# Two f32 runs of one training that differ only in where the batch's rows
# are summed.  Adam scales each gradient by its own size, so the weights agree
# to about 1e-6 where every gradient is well above rounding noise; the tiny
# nets' zero-initialised layers give the weights behind them exact zeros.
TRAIN_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launch(job: str, out: pathlib.Path, spec: dict = None, nproc: int = 2):
    """Run one job of ``torch_dist_jobs`` as ``nproc`` gloo processes."""
    (out / "spec.json").write_text(json.dumps({"out": str(out), **(spec or {})}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    results = run_local(nproc, ["tests/torch_dist_jobs.py", job, str(out / "spec.json")],
                        env=env, cwd=str(REPO), timeout_s=120)
    for rank, (code, text) in enumerate(results):
        assert code == 0, f"{job}: rank {rank} exited {code}:\n{text[-4000:]}"
    return results


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(factory.EDM_ARCHS, "tiny8", J.TINY_EDM)
    monkeypatch.setitem(factory.EDM_ARCHS, "cifar10", J.TINY_EDM)
    monkeypatch.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", J.TINY_LDM)


# ---------------------------------------------------------------------------
# generate, stats, run directories

GEN = dict(seeds=list(range(10)), shape=[4, 4, 3], max_batch_size=3, label_dim=5,
           cfg=dict(solver="heun", num_steps=5))


@pytest.fixture(scope="module")
def generate_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("generate")
    _launch("generate", out, GEN)
    return out


def _jax_generate():
    """The JAX ``generate`` on a 2-device mesh with the jobs' numpy latents,
    labels and denoisers."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JS, "stacked_randn", lambda s, shape, dtype=jnp.float32: jnp.asarray(
        J.numpy_randn(np.asarray(s), shape).numpy(), dtype))
    mp.setattr(JR, "stacked_randint", lambda s, shape, low, high: jnp.asarray(
        J.numpy_randint(np.asarray(s), shape, low, high).numpy()))
    try:
        mesh2 = Mesh(np.asarray(jax.devices()[:2]), ("data",))
        cfg = JS.SolverConfig(**GEN["cfg"])
        seeds, shape = GEN["seeds"], tuple(GEN["shape"])
        means = jnp.asarray(J.label_means(GEN["label_dim"], shape[-1]))

        def gauss(x, t, mu):
            if mu.ndim == 2:
                mu = mu[:, None, None, :]
            t = jnp.reshape(jnp.asarray(t, x.dtype), (-1, 1, 1, 1))
            return mu + (x - mu) / (1.0 + t ** 2)

        den = JBoundDenoiser(lambda x, t: gauss(x, t, jnp.float32(0.5)), 0.002, 80.0)
        kw = dict(mesh=mesh2, max_batch_size=GEN["max_batch_size"])
        rows = J.per_seed_rows(len(seeds), shape[-1])
        return dict(
            plain=JS.generate(den, seeds, shape, cfg, **kw),
            traj=JS.generate(den, seeds, shape, cfg, **kw, return_inters=True),
            labelled=JS.generate(den, seeds, shape, cfg, **kw, label_dim=GEN["label_dim"],
                                 denoise_with_labels=lambda x, t, lab: gauss(x, t, lab @ means)),
            per_seed=JS.generate(den, seeds, shape, cfg, **kw, per_seed_cond=rows,
                                 denoise_with_labels=lambda x, t, c: gauss(x, t, c)))
    finally:
        mp.undo()


@pytest.mark.parametrize("case", ["plain", "traj", "labelled", "per_seed"])
def test_generate_over_two_ranks_matches_jax_generate_on_a_two_device_mesh(generate_job, case):
    """Every process returns every seed's result, equal on both ranks, and
    equal to the JAX mesh's at f32 tolerance (10 seeds, 3 a rank: a padded
    last batch)."""
    ranks = [np.load(generate_job / f"generate.rank{r}.npz") for r in range(2)]
    want = _jax_generate()[case]
    np.testing.assert_array_equal(ranks[0][case], ranks[1][case])
    assert ranks[0][case].shape == want.shape
    np.testing.assert_allclose(ranks[0][case], want, atol=1e-5, rtol=1e-5)


def test_generate_calls_back_every_batch_in_seed_order(generate_job):
    for r in range(2):
        calls = np.load(generate_job / f"generate.rank{r}.npz")["calls"]
        assert calls.tolist() == [[0, 6], [6, 4]]


def test_collector_merges_ranks_whose_names_differ(generate_job):
    """report on both ranks, report0 on rank 0 only: both ranks' collectors
    hold the union (the JAX ``_allgather_counters``)."""
    for r in range(2):
        got = json.loads((generate_job / f"stats.rank{r}.json").read_text())["stats"]
        assert got["m"]["num"] == 2 and got["m"]["mean"] == 1.5
        assert got["only0"] == {"num": 1, "mean": 10.0, "std": 0.0}


def test_run_dir_and_stats_are_written_once(generate_job):
    dirs = [json.loads((generate_job / f"stats.rank{r}.json").read_text())["run_dir"]
            for r in range(2)]
    assert dirs[0] == dirs[1] and dirs[0].endswith("00000-mh")
    assert os.listdir(generate_job / "exps") == ["00000-mh"]
    lines = (generate_job / "exps" / "00000-mh" / "stats.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["m"]["num"] == 2


# ---------------------------------------------------------------------------
# the sampling CLI


@pytest.fixture(scope="module")
def sample_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("sample_cli")
    _launch("sample_cli", out)
    return out


def _pngs(directory) -> dict:
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(directory).glob("*.png"))}


def test_sample_cli_on_two_ranks_writes_the_pngs_of_one(sample_job, tiny, tmp_path):
    """Seeds 0-7 at --batch=2: one process samples 4 batches of 2, two
    processes 2 batches of 4 split 2 + 2, byte for byte the same PNGs."""
    cli_sample.main([*J.SAMPLE_ARGS, *J.DP_SAMPLE, f"--outdir={tmp_path}"])
    one, two = _pngs(tmp_path), _pngs(sample_job / "dp")
    assert len(one) == 8 and one == two


def test_gits_on_two_ranks_finds_the_schedule_of_one(sample_job, tiny, tmp_path):
    want = cli_sample.main([*J.SAMPLE_ARGS, *J.GITS_SAMPLE, f"--outdir={tmp_path}"])["dp_list"]
    for r in range(2):
        assert json.loads((sample_job / f"cli.rank{r}.json").read_text())["dp_list"] == \
            list(want)
    assert _pngs(tmp_path) == _pngs(sample_job / "gits")


def test_sample_cli_sp2_is_within_one_level_of_sp1(sample_job, tiny, tmp_path, monkeypatch):
    """--sp=2 on the tiny LDM (T=64 attention, the ring's gate patched down)
    rings every U-Net attention call on both ranks and decodes to PNGs
    within one uint8 level of one process's --sp=1, as the JAX
    ``test_sample_cli_sp`` holds its mesh."""
    monkeypatch.setattr(RA, "_SP_MIN_TOKENS", J.RING_MIN_TOKENS)
    cli_sample.main([*J.SAMPLE_ARGS, *J.SP_SAMPLE, f"--outdir={tmp_path}"])
    one, two = _pngs(tmp_path), _pngs(sample_job / "sp")
    assert sorted(one) == sorted(two) and len(one) == 4
    for name in one:
        a = np.asarray(PIL.Image.open(tmp_path / name), np.int16)
        b = np.asarray(PIL.Image.open(sample_job / "sp" / name), np.int16)
        assert np.abs(a - b).max() <= 1, name
    for r in range(2):
        got = json.loads((sample_job / f"cli.rank{r}.json").read_text())
        assert got["rang"] > 0 and got["skipped"] == 0


# ---------------------------------------------------------------------------
# the trainers


@pytest.fixture(scope="module")
def train_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    _launch("train", out)
    runs = [json.loads((out / f"train.rank{r}.json").read_text()) for r in range(2)]
    assert runs[0] == runs[1]  # the same run dirs, the same ring count
    return out, runs[0]


def _only_rank0_files(run_dir, expect):
    """One run directory whose log.txt holds each line once (process 0's)."""
    assert sorted(os.listdir(os.path.dirname(run_dir))) == [os.path.basename(run_dir)]
    assert expect <= set(os.listdir(run_dir))
    log = open(os.path.join(run_dir, "log.txt")).read().splitlines()
    assert log.count("Done.") == 1 and sum(line.startswith("Run dir:") for line in log) == 1


def _stats(run_dir):
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def amed_one(tmp_path_factory):
    """train_amed's run dir in one process on the tiny CIFAR-10 net."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(factory.EDM_ARCHS, "cifar10", J.TINY_EDM)
        return train_amed.main([*J.AMED_ARGS, f"--outdir={tmp_path_factory.mktemp('amed')}"])


def test_train_amed_on_two_ranks_matches_one(train_job, amed_one):
    """Two iterations at batch 512 in microbatches of 256 (128 rows a rank):
    the predictor and the loss within TRAIN_TOL of one process's."""
    out, runs = train_job
    one = amed_one
    _only_rank0_files(runs["amed"], {"log.txt", "stats.jsonl", "predictor.npz",
                                     "predictor_config.json"})
    a = ckpt.load_params(os.path.join(one, "predictor.npz"))["params"]
    b = ckpt.load_params(os.path.join(runs["amed"], "predictor.npz"))["params"]
    for path, x in ckpt.flatten_params(a).items():
        np.testing.assert_allclose(ckpt.flatten_params(b)[path], x, atol=TRAIN_TOL,
                                   rtol=TRAIN_TOL, err_msg=path)
    sa, sb = _stats(one), _stats(runs["amed"])
    assert len(sa) == len(sb) == 2
    for ta, tb in zip(sa, sb):
        np.testing.assert_allclose(tb["Loss/loss"]["mean"], ta["Loss/loss"]["mean"], rtol=1e-5)
        assert tb["Loss/loss"]["num"] == 2 * ta["Loss/loss"]["num"]  # one report a rank


def test_train_amed_sp2_matches_one(train_job, amed_one):
    """train_amed --sp=2 on the tiny CIFAR-10 net (one seq group of 2, the
    ring in the teacher's and the student's forwards and the student's
    backward): the predictor within TRAIN_TOL of one process's."""
    out, runs = train_job
    assert runs["amed_rang"] > 0
    one = amed_one
    _only_rank0_files(runs["amed_sp"], {"log.txt", "stats.jsonl", "predictor.npz",
                                        "predictor_config.json"})
    a = ckpt.flatten_params(ckpt.load_params(os.path.join(one, "predictor.npz"))["params"])
    b = ckpt.flatten_params(ckpt.load_params(os.path.join(runs["amed_sp"],
                                                          "predictor.npz"))["params"])
    assert a.keys() == b.keys()
    worst = max(np.abs(a[k] - b[k]).max() for k in a)
    assert worst <= TRAIN_TOL, worst


@pytest.mark.parametrize("run", ["sfd", "sfd_sp"])
def test_train_sfd_on_two_ranks_matches_one(train_job, tiny, tmp_path, monkeypatch, run):
    """SFD on the tiny CIFAR-10 net, data parallel, and with --sp=2 (the
    ring in the student's forward, remat's recompute and the backward): the
    last snapshot within TRAIN_TOL of one process's.  (A net with layers
    that are not zero-initialised but have rounding-noise gradients at init,
    as the tiny LDM's, is no test bed: Adam turns each such gradient into a
    step of lr of either sign.)"""
    out, runs = train_job
    if run == "sfd":
        one = train_sfd.main([*J.SFD_ARGS, f"--outdir={tmp_path}"])
    else:
        assert runs["rang"] > 0
        monkeypatch.setattr(RA, "_SP_MIN_TOKENS", J.RING_MIN_TOKENS)
        one = train_sfd.main([*J.SFD_SP_ARGS, f"--outdir={tmp_path}"])
    snaps = sorted(f for f in os.listdir(one) if f.startswith("snapshot-"))
    _only_rank0_files(runs[run], {"log.txt", "stats.jsonl", "training_options.json", *snaps})
    assert sorted(f for f in os.listdir(runs[run]) if f.startswith("snapshot-")) == snaps
    a = ckpt.flatten_params(ckpt.load_params(os.path.join(one, snaps[-1]))["params"])
    b = ckpt.flatten_params(ckpt.load_params(os.path.join(runs[run], snaps[-1]))["params"])
    assert a.keys() == b.keys()
    worst = max(np.abs(a[k] - b[k]).max() for k in a)
    assert worst <= TRAIN_TOL, worst
    for ta, tb in zip(_stats(one), _stats(runs[run])):
        np.testing.assert_allclose(tb["Loss/loss"]["mean"], ta["Loss/loss"]["mean"], rtol=1e-5)


# ---------------------------------------------------------------------------
# one process: the launcher, the environment, the layout, the refusals


def test_launcher_kills_the_other_ranks_when_one_fails():
    t0 = time.monotonic()
    results = run_local(2, ["-c", "import os, sys, time\n"
                            "if os.environ['DST_PROCESS_ID'] == '1': sys.exit(3)\n"
                            "time.sleep(60)"], timeout_s=30)
    assert [code for code, _ in results] == [-9, 3]
    assert time.monotonic() - t0 < 20


def test_launcher_kills_at_its_timeout():
    t0 = time.monotonic()
    results = run_local(1, ["-c", "import time; print('up', flush=True); time.sleep(60)"],
                        timeout_s=3)
    assert results[0][0] == -9 and "up" in results[0][1]
    assert time.monotonic() - t0 < 20


def test_environment_surface(monkeypatch):
    for k in ("DST_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE", "DST_LOCAL_DEVICE_IDS",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") is False  # one process: nothing
    assert mesh.rank_device("cuda") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.rank_device("cuda") == torch.device("cuda", 3)
    monkeypatch.setenv("DST_LOCAL_DEVICE_IDS", "1")
    assert mesh.rank_device("cuda") == torch.device("cuda", 1)
    assert mesh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("DST_LOCAL_DEVICE_IDS", "0,1")
    with pytest.raises(ValueError, match="one device a process"):
        mesh.rank_device("cuda")
    monkeypatch.setenv("DST_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="DST_NUM_PROCESSES"):
        mesh.maybe_initialize_distributed("cpu")


def test_layout_grid_and_one_process_defaults():
    lay = mesh.ParallelLayout(sp=2, rank=3, world=6)
    assert (lay.dp, lay.data_index, lay.seq_index, lay.seq_ranks) == (3, 1, 1, [2, 3])
    one = mesh.make_layout()
    assert (one.world, one.dp, one.sp, one.data_group, one.seq_group) == (1, 1, 1, None, None)
    with pytest.raises(ValueError, match="seq groups of --sp=2"):
        mesh.make_layout(2)
    assert mesh.pad_to_multiple(10, 4) == 12 and mesh.pad_to_multiple(8, 4) == 8
    x = torch.arange(12)
    assert [c.tolist() for c in mesh.data_rows(x, 4, mesh.ParallelLayout(1, 1, 2))] == \
        [[2, 3], [6, 7], [10, 11]]
    with pytest.raises(ValueError, match="microbatch of 3 rows does not split over 2"):
        mesh.data_rows(x, 3, mesh.ParallelLayout(1, 0, 2))


REFUSALS = [
    (cli_sample.main, ["--dataset_name=tiny8", "--tp=2"], ValueError, "model groups of --tp=2"),
    (cli_sample.main, ["--dataset_name=tiny8", "--tp=2", "--sp=2"], ValueError,
     "mutually exclusive"),
    (train_amed.main, ["--dataset_name=cifar10", "--fsdp"], ValueError, "ldm/sd tiers only"),
    (train_amed.main, ["--dataset_name=cifar10", "--tp=2", "--sp=2"], ValueError,
     "mutually exclusive"),
    (train_amed.main, ["--dataset_name=cifar10", "--tp=2", "--fsdp"], ValueError,
     "mutually exclusive"),
    (train_sfd.main, ["--dataset_name=cifar10", "--tp=2", "--sp=2"], ValueError,
     "mutually exclusive"),
    (train_sfd.main, ["--dataset_name=cifar10", "--fsdp", "--tp=2"], ValueError,
     "mutually exclusive"),
]


@pytest.mark.parametrize("main,argv,exc,match", REFUSALS,
                         ids=[f"{m.__module__.split('.')[-1]} {' '.join(a[1:])}"
                              for m, a, _, _ in REFUSALS])
def test_parallel_flag_refusals(tiny, tmp_path, main, argv, exc, match):
    with pytest.raises(exc, match=match):
        main([*argv, "--device=cpu", f"--outdir={tmp_path}"])
    assert not os.listdir(tmp_path)
