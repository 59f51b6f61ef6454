"""The port's SFD distillation against the JAX package's.

Tiny nets, built on both sides from one set of weights: the port's seeded
init with every weight redrawn at unit scale (the zero-init output convs
would otherwise hide the net from the outputs and the gradients), carried
to the JAX package by ``convert.params_to_jax``.  The EDM students are a
SongUNet (16x16, 16 channels, mult [1, 2], one block a level, attention at
8x8, as tests/test_sfd.py builds them) and a DhariwalUNet (64 channels,
2 heads of d=64 at 8x8, 5 classes), both with SFD-v's step-condition
modules; the latent student is the tiny Stable Diffusion U-Net of
tests/test_torch_sd.py (context [B, 5, 16]).  Latents, labels and contexts
are numpy draws handed to both sides.  f32 on the CPU, where attention and
GroupNorm take their plain versions.

Tolerances, and why:
  * forwards with the step condition and skip tuning: 1e-5 * max|out|
    (both sum in f32 in other orders);
  * the teacher trajectory and ``loss_per_step``: 1e-5 relative (a few
    net calls deep);
  * one SGD step: the update is linear in the gradient, so the params
    after it hold every segment's gradient: within 1e-4 * the step's
    largest move (itself checked to be large) of the JAX params;
  * one Adam step: Adam's first update is lr * g / (|g| + 1e-8), so
    rounding in a gradient near zero can swing an element by up to lr; the
    params are held in units of lr: every element within 2 * (updates) * lr,
    and 99.9% within 1e-3 * lr;
  * remat against plain: bit-equal (the recomputed forward repeats the same
    CPU arithmetic).
"""

import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sampler_tpu.cli import train_sfd as JCLI
from diff_sampler_tpu.models import ldm as JL
from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.ops import get_schedule as jax_get_schedule
from diff_sampler_tpu.solvers import get_sampler as jax_get_sampler
from diff_sampler_tpu.training import sfd as JS
from diff_sampler_tpu_torch.cli import train_sfd as TCLI
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.models.convert import (ldm_params_from_jax, ldm_params_to_jax,
                                                   load_jax_params, params_to_jax)
from diff_sampler_tpu_torch.models.factory import init_params
from diff_sampler_tpu_torch.models.precond import EDMPrecond
from diff_sampler_tpu_torch.training import sfd as TS
from test_torch_sd import TINY as SD_TINY
from test_torch_sd import _tiers as sd_tiers

RES, CH, LABELS = 16, 3, 5
NETS = {
    "SongUNet": (0, dict(model_channels=16, channel_mult=[1, 2], num_blocks=1,
                         attn_resolutions=[8], dropout=0.0)),
    "SongUNet-fourier": (0, dict(model_channels=16, channel_mult=[1, 2], num_blocks=1,
                                 attn_resolutions=[8], dropout=0.0, embedding_type="fourier",
                                 channel_mult_noise=2)),
    "DhariwalUNet": (LABELS, dict(model_channels=64, channel_mult=[1, 2], num_blocks=1,
                                  attn_resolutions=[8], dropout=0.0)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redraw_unit_scale(module, seed=0):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                    / math.sqrt(fan_in))


def _kw(name, sfdv=True, remat=False):
    label_dim, kw = NETS[name]
    kw = dict(kw, use_step_condition=sfdv)
    return label_dim, kw, dict(kw, remat=remat)


def _nets(name="SongUNet", sfdv=True, remat=False, sigma_min=0.006):
    """(the port's EDMPrecond at unit scale, the JAX module, its params)."""
    label_dim, jkw, tkw = _kw(name, sfdv, remat)
    model = "DhariwalUNet" if name == "DhariwalUNet" else "SongUNet"
    port = init_params(EDMPrecond(img_resolution=RES, img_channels=CH, label_dim=label_dim,
                                  model_type=model, model_kwargs=tkw,
                                  sigma_min=sigma_min).eval())
    _redraw_unit_scale(port)
    net = JP.EDMPrecond(img_resolution=RES, img_channels=CH, label_dim=label_dim,
                        model_type=model, model_kwargs=jkw, sigma_min=sigma_min)
    return port, net, params_to_jax(port.state_dict())


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _labels(seed, n):
    return np.eye(LABELS, dtype=np.float32)[np.random.RandomState(seed).randint(LABELS, size=n)]


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


# -- helpers of the trainer and the CLI, bit for bit ---------------------------

HELPER_CASES = (
    [("slice", (n, m)) for n, m in ((2, 0), (3, 1), (4, 3), (7, 3), (5, 2))]
    + [("accumulation", a) for a in (("ms_coco", 64, None), ("ms_coco", 128, 32),
                                     ("ms_coco", 256, None), ("ms_coco", 8, 16),
                                     ("cifar10", 128, 32), ("cifar10", 128, None),
                                     ("lsun_bedroom_ldm", 64, 128), ("imagenet64", 512, 128))]
    + [("lr_drop", a) for a in ((200, 128, 4, False, 0), (1, 128, 3, False, 0),
                                (200, 128, 4, True, 0), (7, 100, 4, True, 3),
                                (1, 2000, 4, True, 1))])


@pytest.mark.parametrize("kind,args", HELPER_CASES,
                         ids=[f"{k}-{a}" for k, a in HELPER_CASES])
def test_helpers_match_jax(kind, args):
    """``teacher_slice_indices``, ``_accumulation`` and ``_lr_drop_updates``
    give the JAX package's values exactly."""
    port, jax_fn = {"slice": (TS.teacher_slice_indices, JS.teacher_slice_indices),
                    "accumulation": (TCLI._accumulation, JCLI._accumulation),
                    "lr_drop": (TCLI._lr_drop_updates, JCLI._lr_drop_updates)}[kind]
    got, want = port(*args), jax_fn(*args)
    assert got == want and type(got) is type(want)


def test_config_fields_match_jax():
    assert dataclasses.asdict(TS.SFDConfig()) == dataclasses.asdict(JS.SFDConfig())


# -- the SFD forwards --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NETS))
def test_step_condition_and_skip_tuning_forward_match_jax(name):
    """D(x, sigma) with SFD-v's step condition, and with skip tuning,
    against the JAX module on the same weights, 1e-5 * max; each changes D
    (the comparison sees it)."""
    port, net, params = _nets(name)
    x = _rand(1, 3, RES, RES, CH) * 5
    s = np.array([10.0, 1.0, 0.3], np.float32)
    labels = _labels(2, 3) if NETS[name][0] else None
    apply = jax.jit(lambda p, x, s, lab, sc, st: net.apply({"params": p}, x, s, lab,
                                                           step_condition=sc, skip_tuning=st),
                    static_argnums=(5,))

    def port_d(sc, st):
        with torch.no_grad():
            return port(torch.from_numpy(x), torch.from_numpy(s),
                        None if labels is None else torch.from_numpy(labels),
                        step_condition=sc, skip_tuning=st)

    for sc, st in ((5.0, False), (None, True)):
        want = apply(params, jnp.asarray(x), jnp.asarray(s),
                     None if labels is None else jnp.asarray(labels), sc, st)
        got = port_d(sc, st)
        _close(got.numpy(), want, 1e-5, f"step_condition={sc} skip_tuning={st}")
        assert not torch.allclose(got, port_d(None, False))


@pytest.mark.parametrize("name", sorted(NETS))
def test_jax_sfdv_param_tree_loads_with_no_key_left_over(name):
    """A JAX SFD-v param tree of the JAX init's shapes (affine_step,
    map_step_layer0 / 1, a Fourier map_step's freqs), drawn at random, loads into the port strictly, and the
    port writes it back leaf for leaf."""
    label_dim, jkw, tkw = _kw(name)
    model = "DhariwalUNet" if name == "DhariwalUNet" else "SongUNet"
    net = JP.EDMPrecond(img_resolution=RES, img_channels=CH, label_dim=label_dim,
                        model_type=model, model_kwargs=jkw)
    shapes = jax.eval_shape(net.init, jax.random.key(3), jnp.zeros((1, RES, RES, CH)),
                            jnp.ones((1,)))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), shapes)
    port = EDMPrecond(img_resolution=RES, img_channels=CH, label_dim=label_dim,
                      model_type=model, model_kwargs=tkw)
    load_jax_params(port, params)  # raises on a missing or unexpected key
    back = params_to_jax(port.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    names = set(back["model"])
    assert {"map_step_layer0", "map_step_layer1"} <= names
    assert ("map_step" in names) == name.endswith("fourier")
    assert sum("affine_step" in blk for blk in back["model"].values()
               if isinstance(blk, dict)) > 0


@pytest.mark.parametrize("name", ["SongUNet", "DhariwalUNet"])
def test_remat_grads_equal_plain(name):
    """Block-granular recompute changes no gradient: the weight gradients
    and the input gradient of sum(D * g) with the step condition and skip
    tuning, with and without ``remat``, bit-equal on the CPU."""
    grads = []
    for remat in (False, True):
        port, _, _ = _nets(name, remat=remat)
        assert port.model.remat == remat
        x = torch.from_numpy(_rand(4, 2, RES, RES, CH) * 3).requires_grad_()
        labels = torch.from_numpy(_labels(5, 2)) if NETS[name][0] else None
        out = port(x, torch.tensor([2.0, 0.5]), labels, step_condition=4.0, skip_tuning=True)
        (out * torch.from_numpy(_rand(6, 2, RES, RES, CH))).sum().backward()
        grads.append([x.grad] + [p.grad for p in port.parameters()])
    assert all(g is not None for g in grads[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_ldm_remat_grads_equal_plain():
    """The latent U-Net (tiny SD, spatial transformers) with ``remat``: its
    weight gradients bit-equal to the plain U-Net's."""
    grads = []
    for remat in (False, True):
        unet = init_params(TL.LDMUNet(remat=remat, device="cpu", **SD_TINY["unet"]))
        _redraw_unit_scale(unet)
        x = torch.from_numpy(_rand(7, 2, RES, RES, 4))
        ctx = torch.from_numpy(_rand(8, 2, 5, 16))
        out = unet(x, torch.tensor([10.0, 500.0]), ctx)
        (out * torch.from_numpy(_rand(9, 2, RES, RES, 4))).sum().backward()
        grads.append([p.grad for p in unet.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# -- the training step --------------------------------------------------------------

def _jax_step(net, cfg, opt, params, lat, labels=None, n_acc=1):
    step = jax.jit(JS.make_train_step(net, JS.SFDConfig(**dataclasses.asdict(cfg)), opt,
                                      n_acc=n_acc))
    args = (params, opt.init(params), params, jnp.asarray(lat))
    if labels is not None:
        args += (jnp.asarray(labels),)
    new, state, metrics = step(*args)
    return jax.tree.map(np.asarray, new), state, np.asarray(metrics["loss_per_step"])


def _torch_step(port, cfg, make_opt, lat, labels=None, n_acc=1):
    teacher = copy.deepcopy(port).requires_grad_(False)
    opt = make_opt(TS.trainable(port))
    step = TS.make_train_step(port, teacher, cfg, opt, n_acc=n_acc)
    cond = () if labels is None else (torch.from_numpy(labels),)
    metrics = step(torch.from_numpy(lat), *cond)
    return params_to_jax(port.state_dict()), opt, metrics["loss_per_step"].numpy(), step


def _diffs(got, want, start):
    """(max |got - want|, the largest move of the JAX step from ``start``),
    over every leaf, and the flat |got - want|."""
    flat = [np.abs(g - w).ravel() for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want))]
    move = max(float(np.abs(w - s).max()) for w, s in zip(jax.tree.leaves(want),
                                                         jax.tree.leaves(start)))
    d = np.concatenate(flat)
    return float(d.max()), move, d


STEP_CASES = [dict(n_acc=2, afs=True), dict(n_acc=1, afs=False, is_second_stage=True)]
LR = 1e-4  # SGD: moves the params by ~0.02, where the later segments stay in range


@pytest.mark.parametrize("case", STEP_CASES, ids=[str(c) for c in STEP_CASES])
def test_train_step_matches_jax_with_sgd(case):
    """One trajectory of the pixel student (SongUNet, SFD-v off), 3 steps,
    M=1, the dpmpp teacher (euler in the second stage), SGD(1e-4):
    loss_per_step within 1e-5 relative, the params after the step within
    1e-4 of the step's largest move; with AFS the first segment's loss is
    the analytic step's and makes no update."""
    n_acc = case.pop("n_acc")
    cfg = TS.SFDConfig(num_steps=3, M=1, sigma_min=0.006, **case)
    port, net, params = _nets(sfdv=False)
    lat = _rand(10, 4, RES, RES, CH)
    want, _, loss_j = _jax_step(net, cfg, optax.sgd(LR), params, lat, n_acc=n_acc)
    got, _, loss_t, _ = _torch_step(port, cfg, lambda p: torch.optim.SGD(p, lr=LR), lat,
                                    n_acc=n_acc)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    err, move, _ = _diffs(got, want, params)
    assert move > 1e-3, move
    assert err <= 1e-4 * move, (err, move)


def test_train_step_matches_jax_with_adam():
    """The same step with Adam(1e-3), as train_sfd runs it (AFS on): params
    in units of lr (every element within 2 * updates * lr, 99.9% within
    1e-3 * lr), and the update count optax's: num_steps - 1, less the AFS
    segment, which advances neither side's count."""
    afs = True
    cfg = TS.SFDConfig(num_steps=3, M=1, sigma_min=0.006, afs=afs)
    lr = 1e-3
    port, net, params = _nets(sfdv=False)
    lat = _rand(11, 2, RES, RES, CH)
    want, state, loss_j = _jax_step(net, cfg, optax.adam(optax.constant_schedule(lr)), params,
                                    lat)
    got, opt, loss_t, _ = _torch_step(port, cfg, lambda p: torch.optim.Adam(
        p, lr=lr, betas=(0.9, 0.999), eps=1e-8), lat)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    updates = 2 - afs
    assert TS.adam_count(opt) == int(state[0].count) == int(state[1].count) == updates
    err, move, d = _diffs(got, want, params)
    assert move > 0.5 * lr
    assert err <= 2 * updates * lr and np.quantile(d, 0.999) <= 1e-3 * lr, (err, move)


def test_afs_only_segment_leaves_params_and_count_alone():
    """num_steps=2 with AFS: the one segment is the analytic step, so the
    step makes no update: params bit-equal, Adam's count 0, and its loss
    that of x + (t1 - t0) * x / sqrt(1 + t0^2) against the teacher."""
    cfg = TS.SFDConfig(num_steps=2, M=1, sigma_min=0.006, afs=True)
    port, _, params = _nets(sfdv=False)
    lat = _rand(12, 2, RES, RES, CH)
    got, opt, loss_t, step = _torch_step(port, cfg, lambda p: torch.optim.Adam(p, lr=1e-3),
                                         lat)
    assert TS.adam_count(opt) == 0 and not opt.state
    for g, s in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, s)
    t = torch.tensor(jax_get_schedule(2, 0.006, 80.0, "polynomial", 7.0), dtype=torch.float32)
    x = torch.from_numpy(lat) * t[0]
    stu = x + (t[1] - t[0]) * (x / torch.sqrt(1.0 + t[0] ** 2))
    tea = step.teacher_traj(torch.from_numpy(lat), None)[0]
    np.testing.assert_allclose(loss_t, [(stu - tea).abs().sum().item() / 2], rtol=1e-6)


def test_teacher_trajectory_matches_jax():
    """The teacher's knots: dpmpp over 2 * 3 + 1 = 7 points from the latents,
    sliced at 2, 4, 6, against the JAX sampler on the same net, 1e-5 *
    max."""
    cfg = TS.SFDConfig(num_steps=4, M=1, sigma_min=0.006)
    port, net, params = _nets(sfdv=False)
    lat = _rand(13, 2, RES, RES, CH)
    step = TS.make_train_step(port, port, cfg, torch.optim.SGD(TS.trainable(port), lr=0.0))
    got = step.teacher_traj(torch.from_numpy(lat), None).numpy()
    tea_t = jax_get_schedule(7, 0.006, 80.0, "polynomial", 7.0)
    den = JP.bind(net, params)
    out = jax.jit(lambda x: jax_get_sampler("dpmpp")(den, x, tea_t, return_inters=True,
                                                     max_order=3).xs)(jnp.asarray(lat))
    want = np.asarray(out)[JS.teacher_slice_indices(4, 1)]
    assert got.shape == (3, 2, RES, RES, CH)
    for i in range(3):
        _close(got[i], want[i], 1e-5, f"knot {i}")


def test_sfdv_step_matches_jax():
    """An SFD-v step of the conditional DhariwalUNet (use_step_condition,
    num_steps=4 given to the student as its step condition, not to the
    teacher), on one-hot labels, SGD(1e-4): params within 1e-4 of the
    largest move; the step-condition tower moved."""
    name = "DhariwalUNet"
    cfg = TS.SFDConfig(num_steps=4, M=1, sigma_min=0.006, use_step_condition=True)
    port, net, params = _nets(name)
    lat = _rand(14, 2, RES, RES, CH)
    labels = _labels(15, 2) if NETS[name][0] else None
    want, _, loss_j = _jax_step(net, cfg, optax.sgd(LR), params, lat, labels)
    got, _, loss_t, _ = _torch_step(port, cfg, lambda p: torch.optim.SGD(p, lr=LR), lat,
                                    labels)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    err, move, _ = _diffs(got, want, params)
    assert err <= 1e-4 * move, (err, move)
    moved = np.abs(got["model"]["map_step_layer0"]["kernel"]
                   - params["model"]["map_step_layer0"]["kernel"]).max()
    assert moved > 1e-3 * move


def test_ldm_train_step_matches_jax():
    """One latent step on the tiny SD U-Net, built under guidance 7.5 and
    trained at 1.0 (no doubled batch), on contexts, 2 microbatches, SGD(1e-4): its
    sigma range is the precond's (0.1 to sigma(1)), loss_per_step within 1e-5
    relative, the U-Net's params within 1e-4 of the largest move."""
    pre_t, pre_j, trees = sd_tiers(SD_TINY)
    assert pre_t.guidance_rate == 7.5
    cfg = TS.SFDConfig(num_steps=3, M=1, schedule_type="discrete", schedule_rho=1.0)
    lat = _rand(16, 4, RES, RES, 4)
    ctx = _rand(17, 4, 5, 16)
    ld_j = pre_j.latent_diffusion
    params = trees["unet"]

    def unet_apply(p, x, t, c=None):
        return ld_j.unet.apply({"params": p}, x, t, c)

    opt_j = optax.sgd(LR)
    step_j = jax.jit(JS.make_ldm_train_step(unet_apply, pre_j,
                                            JS.SFDConfig(**dataclasses.asdict(cfg)), opt_j,
                                            n_acc=2))
    want, _, m = step_j(params, opt_j.init(params), params, jnp.asarray(lat), jnp.asarray(ctx))
    want = jax.tree.map(np.asarray, want)

    unet = pre_t.latent_diffusion.unet
    assert ldm_params_to_jax(unet.state_dict()).keys() == params.keys()
    teacher = copy.deepcopy(unet).requires_grad_(False)
    step = TS.make_ldm_train_step(unet, teacher, pre_t, cfg,
                                  torch.optim.SGD(TS.trainable(unet), lr=LR), n_acc=2)
    metrics = step(torch.from_numpy(lat), torch.from_numpy(ctx))
    np.testing.assert_allclose(metrics["loss_per_step"].numpy(),
                               np.asarray(m["loss_per_step"]), rtol=1e-5)
    got = ldm_params_to_jax(unet.state_dict())
    err, move, _ = _diffs(got, want, params)
    assert move > 1e-2, move
    assert err <= 1e-4 * move, (err, move)
    # the JAX layout converts back to the port's names exactly
    back = ldm_params_from_jax(got, unet.state_dict())
    assert all(torch.equal(back[k], v) for k, v in unet.state_dict().items())
