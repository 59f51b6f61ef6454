"""Tensor parallelism of the port (``parallel/tp.py``, ``--tp`` in the CLIs)
against the JAX package's ``parallel/tp.py`` on the CPU.

In one process: the port's ``tp_plan`` against the JAX ``tp_param_specs`` on
tiny SongUNet, DhariwalUNet, ADMUNet, ADMClassifier and LDMUNet (spatial
transformer, GEGLU) at tp 2 and 4, the same weights split on the mapped
dimension (HWIO out <-> OIHW 0, in <-> 1; linear (in, out) <-> (out, in));
``shard_tensor_parallel``'s cuts following the plan but for the listed
departures (a column layer's bias, the stored norm and embedding slices,
GEGLU's halves, the new-order qkv's heads), and the cuts put back together
bit for bit; the refusal of a tp that does not divide a sharded norm's
groups.

Over 2 gloo ranks (one launch of ``tests/torch_dist_jobs.py``'s ``tp_fsdp``
job, 120 s limit): the tp=2 forwards against the JAX package on its 2-device
CPU mesh (``shard_params_tp``) with the same weights, f32, at 2e-5;
``gather_state_dict`` bit for bit; the CG class-score gradient of a tiny ADM
and its classifier against the JAX one; ``sample --tp=2`` PNGs within one
uint8 level of one process's; ``train_amed --tp=2`` and ``train_sfd --tp=2``
(and its ``--resume`` from the first snapshot) against one process.
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from diff_sampler_tpu.models import adm as JADM
from diff_sampler_tpu.models import ldm as JL
from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.models import unets as JU
from diff_sampler_tpu.parallel import tp as JTP
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.cli import train_amed, train_sfd
from diff_sampler_tpu_torch.models import adm as TADM
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.models import unets as TU
from diff_sampler_tpu_torch.models.convert import ldm_params_to_jax, params_to_jax
from diff_sampler_tpu_torch.parallel import tp as TTP
from diff_sampler_tpu_torch.parallel.launch import run_local
from diff_sampler_tpu_torch.parallel.mesh import ParallelLayout, shard_spec
from diff_sampler_tpu_torch.utils import checkpoint as ckpt

import torch_dist_jobs as J
from test_torch_adm import TINY_ADM, TINY_CLASSIFIER, _as_jax_arrays, port_and_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-5
# two f32 trainings that differ in where the sums over channels and heads
# are taken (test_torch_parallel.TRAIN_TOL's reasoning)
TRAIN_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_scale(module, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) / np.sqrt(fan_in))
    return module


# ---------------------------------------------------------------------------
# one process: the plan, the cuts, the refusal

TINY_ADM_NEW = dict(TINY_ADM, use_new_attention_order=True)


def _family(name):
    """(a tiny port net, its params as the JAX package's tree)."""
    if name in ("song", "dhariwal", "ldm_sd"):
        net = factory.init_params(J.build_tp_net(name))
        sd = net.state_dict()
        return net, (ldm_params_to_jax(sd) if name == "ldm_sd" else params_to_jax(sd))
    setting = {"adm": TINY_ADM, "adm_new_order": TINY_ADM_NEW, "classifier": TINY_CLASSIFIER}[name]
    cls = TADM.ADMClassifier if name == "classifier" else TADM.ADMUNet
    net = factory.init_params(cls(device="cpu", **setting))
    return net, JADM.adm_state_dict_to_params(TADM.reference_state_dict(net))


FAMILIES = ["song", "dhariwal", "adm", "classifier", "ldm_sd"]


def _jax_plan(tree, tp):
    """{flat module name: port dimension} of the kernels the JAX specs shard."""
    specs = JTP.tp_param_specs(tree, tp)
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1] != "kernel" or "model" not in tuple(spec):
            continue
        axis, nd = tuple(spec).index("model"), len(tuple(spec))
        out["_".join(keys[:-1])] = {4: {3: 0, 2: 1}, 2: {1: 0, 0: 1}}[nd][axis]
    return out


def test_role_table_is_the_jax_one():
    """The port's copy of the JAX ``_role`` suffix tables, and the roles it
    gives the names that the proj / proj_out rules look at siblings for."""
    assert (TTP._COL_SUFFIXES, TTP._ROW_SUFFIXES) == (JTP._COL_SUFFIXES, JTP._ROW_SUFFIXES)
    names = frozenset({"a_qkv", "a_proj", "b_proj_in", "b_proj_out", "c_qkv", "c_proj_out",
                       "d_proj_out", "qkv", "proj", "net_0_proj", "out_2_qkv_proj",
                       "out_2_c_proj", "x_to_out_0", "y_in_layers_2", "z_emb_layers_1"})
    for name in sorted(names):
        assert TTP._role(name, names) == JTP._role(name, names), name


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_tp_plan_matches_jax_specs(family, tp):
    net, tree = _family(family)
    plan = TTP.tp_plan(net, tp)
    got = {name.rsplit(".", 1)[0].replace(".", "_"): dim for name, (_, dim) in plan.items()}
    want = _jax_plan(tree, tp)
    assert want and got == want
    roles = {role for role, _ in plan.values()}
    assert roles == {"col", "row"}


_SLICES = ("norm1", "out_layers.0", "affine", "affine_step", "emb_layers.1")


def _departure(name, plan):
    """A tensor the port cuts where the JAX plan replicates it: a column
    layer's bias, or a stored slice of a norm or an embedding."""
    path, leaf = name.rsplit(".", 1)
    if leaf == "bias" and plan.get(f"{path}.weight", ("",))[0] == "col":
        return True
    return any(path == s or path.endswith("." + s) for s in _SLICES)


_PARTED = ("net.0.proj", "affine", "affine_step", "emb_layers.1")
# SongUNet's 8-channel GroupNorms have 2 groups: tp 4 is the refusal below
CUT_CASES = [(f, tp) for tp in (2, 4) for f in FAMILIES + ["adm_new_order"]
             if (f, tp) != ("song", 4)]


@pytest.mark.parametrize("family,tp", CUT_CASES)
def test_cuts_follow_the_plan_and_go_back_together(family, tp):
    """Each rank's cut (no collective: a layout with no group) takes every
    planned weight on the plan's dimension, contiguously but for a rank's
    part of each half of GEGLU's [a | gate] and of an embedding's [scale |
    shift], and its heads of each of the new-order q, k and v; anything else
    it cuts is a listed departure; the ranks' cuts put back by their indices
    give the full tensors bit for bit."""
    full, _ = _family(family)
    plan = TTP.tp_plan(full, tp)
    whole = {k: v.clone() for k, v in full.state_dict().items()}
    cuts = []
    for rank in range(tp):
        net, _ = _family(family)
        net.load_state_dict(whole)
        TTP.shard_tensor_parallel(net, ParallelLayout(rank=rank, world=tp, tp=tp))
        cuts.append(dict(net.named_parameters()))
    specs = {n: shard_spec(p) for n, p in cuts[0].items() if shard_spec(p) is not None}
    assert set(plan) <= set(specs)
    for name, spec in specs.items():
        if name in plan:
            assert spec.dim == plan[name][1], name
        else:
            assert _departure(name, plan), name
        contiguous = all(torch.equal(idx, torch.arange(idx[0], idx[0] + len(idx)))
                         for idx in spec.index)
        path = name.rsplit(".", 1)[0]
        parted = any(path.endswith(s) for s in _PARTED) or (
            family == "adm_new_order" and path.endswith(".qkv"))
        assert contiguous or parted, name
        back = torch.empty_like(whole[name])
        for rank in range(tp):
            back.index_copy_(spec.dim, spec.index[rank], cuts[rank][name].detach())
        assert torch.equal(back, whole[name]), name
    if family == "song":  # one head: every attention takes the gather path
        blocks = [b for b in net.modules() if isinstance(b, TU.UNetBlock) and b.num_heads]
        assert blocks and all(b.tp_heads.gather for b in blocks)
    assert TTP.count_sharded(net) == len(specs)


def test_tp_refuses_groups_that_do_not_divide():
    """A SongUNet of 8 channels has GroupNorms of 2 groups: tp=4 cuts its
    convs (8 / 4) but would split a group, so the cut is refused, naming the
    norm."""
    net = factory.init_params(J.build_tp_net("song"))
    with pytest.raises(ValueError, match=r"--tp=4 does not divide the 2 groups of the "
                                         r"GroupNorm enc\.8x8_block0\.norm1"):
        TTP.shard_tensor_parallel(net, ParallelLayout(rank=0, world=4, tp=4))


# ---------------------------------------------------------------------------
# two ranks


def _launch(job: str, out: pathlib.Path, spec: dict):
    (out / "spec.json").write_text(json.dumps({"out": str(out), **spec}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    results = run_local(2, ["tests/torch_dist_jobs.py", job, str(out / "spec.json")],
                        env=env, cwd=str(REPO), timeout_s=120)
    for rank, (code, text) in enumerate(results):
        assert code == 0, f"{job}: rank {rank} exited {code}:\n{text[-4000:]}"


def _inputs(name, seed):
    rng = np.random.RandomState(seed)
    kind, kw = J.TP_NETS[name]
    res = kw.get("img_resolution", kw.get("image_size"))
    cin = kw["in_channels"]
    data = dict(x=rng.randn(2, res, res, cin).astype(np.float32),
                t=np.array([0.4, 3.0] if kind != "LDMUNet" else [20.0, 700.0], np.float32))
    if name == "ldm_sd":
        data["ctx"] = rng.randn(2, 5, kw["context_dim"]).astype(np.float32)
    if name == "dhariwal":
        data["labels"] = np.eye(kw["label_dim"], dtype=np.float32)[[1, 3]]
    return data


def _cg_pair():
    """The port's tiny CGPrecond (guidance 2) with the reference weights of
    ``test_torch_adm.port_and_jax`` and the JAX one over the same params."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(factory, "IMAGENET256_SETTING", TINY_ADM)
        mp.setattr(factory, "IMAGENET256_CLASSIFIER_SETTING", TINY_CLASSIFIER)
        pre, _ = factory.create_model("imagenet256", "random", guidance_rate=2.0, device="cpu")
    p_net, p_cls = port_and_jax(pre.net, seed=12)[1], port_and_jax(pre.classifier, seed=13)[1]
    for tree in (p_net, p_cls):
        _as_jax_arrays(tree)
    net, cls = JADM.ADMUNet(**TINY_ADM), JADM.ADMClassifier(**TINY_CLASSIFIER)
    pre_j = JP.CGPrecond(model_fn=lambda x, t, y: net.apply({"params": p_net}, x, t, y),
                         classifier_fn=lambda x, t: cls.apply({"params": p_cls}, x, t),
                         img_resolution=TINY_ADM["image_size"], img_channels=3, label_dim=7,
                         guidance_rate=2.0)
    return pre, pre_j, cls, p_cls


CG_X = np.random.RandomState(21).randn(2, TINY_ADM["image_size"], TINY_ADM["image_size"],
                                       3).astype(np.float32)
CG_T = np.array([40.0, 600.0], np.float32)
CG_Y = np.array([2, 5])


@pytest.fixture(scope="module")
def tp_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    for i, name in enumerate(J.TP_NETS):
        net = _unit_scale(J.build_tp_net(name), seed=40 + i)
        np.savez(out / f"weights_{name}.npz",
                 **{k: v.numpy() for k, v in net.state_dict().items()})
        np.savez(out / f"inputs_{name}.npz", **_inputs(name, seed=50 + i))
    pre, _, _, _ = _cg_pair()
    np.savez(out / "cg.npz", x=CG_X, t=CG_T, y=CG_Y,
             **{f"net.{k}": v.numpy() for k, v in pre.net.state_dict().items()},
             **{f"cls.{k}": v.numpy() for k, v in pre.classifier.state_dict().items()})
    _launch("tp_fsdp", out, {"cases": ["tp"],
                             "cg_settings": {"net": TINY_ADM, "classifier": TINY_CLASSIFIER}})
    runs = [json.loads((out / f"runs.rank{r}.json").read_text()) for r in range(2)]
    assert runs[0] == runs[1]
    return out, runs[0]


def _rank_outputs(out, name):
    got = [np.load(out / f"{name}.rank{r}.npz") for r in range(2)]
    return got


def _jax_forward(name, out):
    """The JAX net of ``TP_NETS[name]`` on the saved weights and inputs, its
    params sharded by ``tp_param_specs`` over a (1, 2) mesh of 2 CPU devices."""
    kind, kw = J.TP_NETS[name]
    sd = dict(np.load(out / f"weights_{name}.npz"))
    data = dict(np.load(out / f"inputs_{name}.npz"))
    if kind == "LDMUNet":
        net, params = JL.LDMUNet(**kw), ldm_params_to_jax(
            {k: torch.from_numpy(v) for k, v in sd.items()})
        args = (data["x"], data["t"]) + ((data["ctx"],) if "ctx" in data else ())
    else:
        net = getattr(JU, kind)(**kw)
        params = params_to_jax({k: torch.from_numpy(v) for k, v in sd.items()})
        args = (data["x"], data["t"]) + ((data["labels"],) if "labels" in data else ())
    _as_jax_arrays(params)
    mesh = JTP.get_mesh_2d(2, devices=jax.devices()[:2])
    sharded = JTP.shard_params_tp(params, mesh)
    fn = jax.jit(lambda p, *a: net.apply({"params": p}, *a),
                 out_shardings=NamedSharding(mesh, P()))
    return np.asarray(fn(sharded, *[jnp.asarray(a) for a in args]))


@pytest.mark.parametrize("name", list(J.TP_NETS))
def test_tp2_forward_matches_jax_on_a_two_device_mesh(tp_job, name):
    """Each rank's forward (the same on both) within 2e-5 of the JAX net's
    largest output; shard-then-gather returns the full state_dict bit for
    bit, and each rank holds less than the whole net."""
    out, _ = tp_job
    ranks = _rank_outputs(out, f"fwd_{name}")
    want = _jax_forward(name, out)
    full_bytes = sum(v.nbytes for v in np.load(out / f"weights_{name}.npz").values())
    for r in ranks:
        np.testing.assert_allclose(r["out"], want, rtol=0, atol=TOL * np.abs(want).max())
        assert bool(r["gathered"]) and int(r["sharded"]) > 0
        assert int(r["bytes"]) < full_bytes
    np.testing.assert_array_equal(ranks[0]["out"], ranks[1]["out"])


def test_tp2_cg_gradient_matches_jax(tp_job):
    """The class-score gradient (guidance 2) through the tp=2 classifier's
    shards, within 2e-5 of the JAX one's largest entry."""
    out, _ = tp_job
    _, pre_j, _, _ = _cg_pair()
    want = np.asarray(jax.jit(pre_j._cond_grad)(jnp.asarray(CG_X), jnp.asarray(CG_T),
                                                 jnp.asarray(CG_Y)))
    for r in _rank_outputs(out, "cg"):
        assert int(r["sharded"]) > 0
        np.testing.assert_allclose(r["grad"], want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(factory.EDM_ARCHS, "tiny8", J.TINY_EDM)
    monkeypatch.setitem(factory.EDM_ARCHS, "cifar10", J.TINY_EDM)
    monkeypatch.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", J.TINY_LDM)


def _pngs(directory) -> dict:
    return {f: np.asarray(PIL.Image.open(os.path.join(directory, f)))
            for f in sorted(os.listdir(directory)) if f.endswith(".png")}


def test_sample_cli_tp2_is_within_one_level_of_one_process(tp_job, tiny, tmp_path):
    out, _ = tp_job
    cli_sample.main([*J.SAMPLE_ARGS, *J.DP_SAMPLE, f"--outdir={tmp_path}"])
    one, two = _pngs(tmp_path), _pngs(out / "sample_tp")
    assert one.keys() == two.keys() and len(one) == 8
    for f in one:
        assert np.abs(one[f].astype(int) - two[f].astype(int)).max() <= 1, f


def _flat(path):
    return ckpt.flatten_params(ckpt.load_params(path)["params"])


def _worst(a, b):
    assert a.keys() == b.keys()
    return max(np.abs(a[k] - b[k]).max() for k in a)


def test_train_amed_tp2_matches_one(tp_job, tiny, tmp_path):
    """AMED through the tp=2 frozen tiny CIFAR-10 net (the predictor's
    gradient through the shards' backward): the predictor within TRAIN_TOL
    of one process's."""
    _, runs = tp_job
    one = train_amed.main([*J.AMED_ARGS, f"--outdir={tmp_path}"])
    worst = _worst(_flat(os.path.join(one, "predictor.npz")),
                   _flat(os.path.join(runs["amed_tp"], "predictor.npz")))
    assert worst <= TRAIN_TOL, worst
    log = open(os.path.join(runs["amed_tp"], "log.txt")).read()
    assert "Tensor parallel: frozen net sharded over mesh {'data': 1, 'model': 2}" in log


def test_train_sfd_tp2_matches_one_and_resumes(tp_job, tiny, tmp_path):
    """SFD with the student, the teacher and Adam's moments tp=2-sharded:
    every snapshot (whole weights, gathered) within TRAIN_TOL of one
    process's, and loadable in one process; a run resumed under --tp from
    the first snapshot ends on the unbroken run's last snapshot."""
    _, runs = tp_job
    one = train_sfd.main([*J.SFD_ARGS, f"--outdir={tmp_path}"])
    snaps = sorted(f for f in os.listdir(one) if f.startswith("snapshot-"))
    assert len(snaps) == 2
    assert sorted(f for f in os.listdir(runs["sfd_tp"]) if f.startswith("snapshot-")) == snaps
    for snap in snaps:
        a, b = _flat(os.path.join(one, snap)), _flat(os.path.join(runs["sfd_tp"], snap))
        assert _worst(a, b) <= TRAIN_TOL, snap
        opt_a = ckpt.load_params(os.path.join(one, snap))["opt_state"]
        opt_b = ckpt.load_params(os.path.join(runs["sfd_tp"], snap))["opt_state"]
        assert opt_a.keys() == opt_b.keys()
        assert all(opt_a[k].shape == opt_b[k].shape for k in opt_a)
    last = snaps[-1]
    resumed = _flat(os.path.join(runs["sfd_tp_resume"], last))
    assert _worst(resumed, _flat(os.path.join(runs["sfd_tp"], last))) <= TRAIN_TOL
    log = open(os.path.join(runs["sfd_tp"], "log.txt")).read()
    assert "Tensor parallel:" in log and "sharded over mesh {'data': 1, 'model': 2}" in log
