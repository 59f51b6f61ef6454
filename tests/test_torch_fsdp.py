"""FSDP of the port (``parallel/fsdp.py``, ``--fsdp`` in the trainers)
against the JAX package's ``parallel/fsdp.py`` on the CPU, and the SFD train
steps' refusal of a module in train mode.

In one process: ``fsdp_dim`` against the JAX ``fsdp_param_specs`` rule; the
resident bytes ``fsdp_bytes_per_device`` counts at most the JAX function's
on the same nets' trees at n = 2 and 4 (the port's layouts are OIHW and
(out, in), so its largest dimension may be another than the JAX one; the
bytes are what counts); the SFD train steps refuse a student or a teacher
in train mode, as ``bind`` does.

Over 2 gloo ranks (one launch of ``tests/torch_dist_jobs.py``'s ``tp_fsdp``
job, 120 s limit, the floor lowered to 256 elements so that the tiny nets
shard): ``train_sfd --fsdp`` and ``--fsdp --sp=2`` (a data group of one:
the two compose) on the tiny CIFAR-10 net, and ``train_amed --fsdp`` on the
tiny LDM, against one process.
"""

import copy
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import adm as JADM
from diff_sampler_tpu.parallel import fsdp as JFS
from diff_sampler_tpu_torch.cli import train_amed, train_sfd
from diff_sampler_tpu_torch.models import adm as TADM
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.models.convert import ldm_params_to_jax, params_to_jax
from diff_sampler_tpu_torch.parallel import fsdp as TFS
from diff_sampler_tpu_torch.parallel.launch import run_local
from diff_sampler_tpu_torch.training import sfd as TS
from diff_sampler_tpu_torch.utils import checkpoint as ckpt

import torch_dist_jobs as J
from test_torch_adm import TINY_ADM, TINY_CLASSIFIER

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAIN_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(256, 128), (256, 256), (3, 3, 64, 128), (128, 64, 3, 3),
                                   (32, 32), (255, 129), ()])
def test_fsdp_dim_is_the_jax_rule(shape):
    spec = tuple(JFS.fsdp_param_specs({"w": jnp.zeros(shape)}, 8)["w"])
    want = spec.index("data") if "data" in spec else None
    assert TFS.fsdp_dim(shape, 8) == want


def _trees(name):
    if name in ("song", "dhariwal", "ldm_sd"):
        net = factory.init_params(J.build_tp_net(name))
        sd = net.state_dict()
        return net, (ldm_params_to_jax(sd) if name == "ldm_sd" else params_to_jax(sd))
    cls, setting = {"adm": (TADM.ADMUNet, TINY_ADM),
                    "classifier": (TADM.ADMClassifier, TINY_CLASSIFIER)}[name]
    net = factory.init_params(cls(device="cpu", **setting))
    return net, JADM.adm_state_dict_to_params(TADM.reference_state_dict(net))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["song", "dhariwal", "adm", "classifier", "ldm_sd"])
def test_fsdp_bytes_at_most_the_jax_count(name, n, monkeypatch):
    """At the real floor (2^14 elements) and at 256, the tiny nets' resident
    bytes at most the JAX count on the same tree, and below the whole net's
    wherever anything shards."""
    net, tree = _trees(name)
    whole = sum(p.numel() * p.element_size() for p in net.parameters())
    for floor in (2 ** 14, 256):
        monkeypatch.setattr(TFS, "_MIN_SHARD_ELEMS", floor)
        specs = TFS.fsdp_specs(net, n)
        got = TFS.fsdp_bytes_per_device(net, specs, n)
        jspecs = JFS.fsdp_param_specs(tree, n, min_shard_elems=floor)
        want = JFS.fsdp_bytes_per_device(tree, jspecs, n)
        assert got <= want, (floor, got, want)
        assert (got < whole) == (TFS.count_sharded_fsdp(specs) > 0)
    assert TFS.count_sharded_fsdp(specs) > 0


def test_sfd_train_steps_refuse_a_module_in_train_mode():
    """A student or teacher in train mode (dropout on) is refused by both
    train steps, as ``bind`` refuses one; in eval mode the steps build."""
    student = factory.init_params(_tiny_edm())
    teacher = copy.deepcopy(student)
    opt = torch.optim.SGD(TS.trainable(student), lr=0.0)
    cfg = TS.SFDConfig(num_steps=3, M=1)
    TS.make_train_step(student, teacher, cfg, opt)
    for m in (student, teacher):
        m.train()
        with pytest.raises(ValueError, match="eval mode"):
            TS.make_train_step(student, teacher, cfg, opt)
        m.eval()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", J.TINY_LDM)
        pre = factory.build_ldm_model("lsun_bedroom_ldm", "random", device="cpu")
    unet = pre.latent_diffusion.unet
    teacher = copy.deepcopy(unet)
    TS.make_ldm_train_step(unet, teacher, pre, cfg, opt)
    unet.train()
    with pytest.raises(ValueError, match="eval mode"):
        TS.make_ldm_train_step(unet, teacher, pre, cfg, opt)


def _tiny_edm():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(factory.EDM_ARCHS, "cifar10", J.TINY_EDM)
        return factory.build_edm_model("cifar10", device="cpu")


# ---------------------------------------------------------------------------
# two ranks


@pytest.fixture(scope="module")
def fsdp_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp")
    (out / "spec.json").write_text(json.dumps({"out": str(out), "cases": ["fsdp"]}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    results = run_local(2, ["tests/torch_dist_jobs.py", "tp_fsdp", str(out / "spec.json")],
                        env=env, cwd=str(REPO), timeout_s=120)
    for rank, (code, text) in enumerate(results):
        assert code == 0, f"tp_fsdp: rank {rank} exited {code}:\n{text[-4000:]}"
    runs = [json.loads((out / f"runs.rank{r}.json").read_text()) for r in range(2)]
    assert runs[0] == runs[1]
    return runs[0]


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(factory.EDM_ARCHS, "cifar10", J.TINY_EDM)
    monkeypatch.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", J.TINY_LDM)


def _flat(path, tree="params"):
    return ckpt.flatten_params(ckpt.load_params(path)[tree])


def _worst(a, b):
    assert a.keys() == b.keys()
    return max(np.abs(a[k] - b[k]).max() for k in a)


@pytest.fixture(scope="module")
def sfd_one(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(factory.EDM_ARCHS, "cifar10", J.TINY_EDM)
        return train_sfd.main([*J.SFD_ARGS, f"--outdir={tmp_path_factory.mktemp('sfd')}"])


@pytest.mark.parametrize("run,line", [("sfd_fsdp", "sharded 1/2 per device"),
                                      ("sfd_fsdp_sp", "sharded 1/1 per device")])
def test_train_sfd_fsdp_matches_one(fsdp_job, sfd_one, run, line):
    """Every snapshot (the whole weights and moments, gathered by both
    ranks, written by process 0) within TRAIN_TOL of one process's."""
    snaps = sorted(f for f in os.listdir(sfd_one) if f.startswith("snapshot-"))
    assert sorted(f for f in os.listdir(fsdp_job[run]) if f.startswith("snapshot-")) == snaps
    for snap in snaps:
        a, b = _flat(os.path.join(sfd_one, snap)), _flat(os.path.join(fsdp_job[run], snap))
        assert _worst(a, b) <= TRAIN_TOL, snap
        # Adam's moments: each leaf within 1e-4 of its largest entry
        a = _flat(os.path.join(sfd_one, snap), "opt_state")
        b = _flat(os.path.join(fsdp_job[run], snap), "opt_state")
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-4 * np.abs(a[k]).max(),
                                       err_msg=f"{snap} {k}")
    log = open(os.path.join(fsdp_job[run], "log.txt")).read()
    assert "FSDP: " in log and line in log


def test_train_amed_fsdp_on_the_tiny_ldm_matches_one(fsdp_job, tiny, tmp_path):
    """AMED through the FSDP-sharded frozen tiny LDM (each weight gathered
    in its layer's forward; the predictor's gradient through the backward):
    the predictor within TRAIN_TOL of one process's."""
    one = train_amed.main([*J.AMED_LDM_ARGS, f"--outdir={tmp_path}"])
    worst = _worst(_flat(os.path.join(one, "predictor.npz")),
                   _flat(os.path.join(fsdp_job["amed_fsdp"], "predictor.npz")))
    assert worst <= TRAIN_TOL, worst
    log = open(os.path.join(fsdp_job["amed_fsdp"], "log.txt")).read()
    assert "FSDP: frozen net (" in log and "sharded 1/2" in log
