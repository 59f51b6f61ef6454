"""The port's ADM family (``ADMUNet``, ``ADMClassifier``) and the 256 px
preconditioners (``CMPrecond``, ``CGPrecond``) against the JAX package's.

Tiny stand-ins for the 256 px settings (16x16 images, 32 channels, mult
[1, 2], one res block per level, attention at 8x8 in heads of 16; the
classifier's attention pool over T = 8 * 8 + 1 = 65 tokens) carry weights
drawn from a numpy seed at unit scale in the reference checkpoint's layout
(the attention's Conv1d weights [O, I, 1]); the JAX package's
``adm_state_dict_to_params`` turns them into its params, and the port loads
those through ``models.convert.load_adm_jax_params`` (both converters, so
the round trip is checked bit for bit).  Inputs are numpy draws handed to
both sides.  f32 on the CPU, where the port's GroupNorm and attention take
their plain versions (kernels K3, K1 and K2 run on the card) and the JAX
attention its einsum (T < 256).

Bounds: the nets, CM's D and the classifier gradient 1e-5 * max|out| (both
sides sum in f32 in other orders; the cases measured 2e-6 and below on one
CPU); CG's D 1e-5 * max|x|, since D = clamp(x - sigma * eps, -1, 1) carries
an f32 difference in eps sigma-fold; ``sigma_min`` /
``sigma_max`` bit for bit (both f32); the param conversions and a loaded
checkpoint bit for bit.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import adm as JADM
from diff_sampler_tpu.models import factory as JF
from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu_torch.models import adm as TADM
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models.convert import load_adm_jax_params
from diff_sampler_tpu_torch.models.precond import CGPrecond, CMPrecond, bind

RES = 16
TINY_UNET = dict(image_size=RES, in_channels=3, model_channels=32, out_channels=3,
                 num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                 num_heads=2, num_head_channels=16, use_scale_shift_norm=False,
                 resblock_updown=True)
TINY_CM = dict(TINY_UNET, num_classes=None, dropout=0.1)
TINY_ADM = dict(TINY_UNET, num_classes=7, out_channels=6, use_scale_shift_norm=True)
TINY_CLASSIFIER = dict(image_size=RES, in_channels=3, model_channels=32, out_channels=7,
                       num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                       num_head_channels=16, use_scale_shift_norm=True, resblock_updown=True,
                       pool="attention")
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU,
    where torch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def reference_weights(module, seed):
    """Unit-scale numpy draws in the reference checkpoint's layout for every
    key of ``module`` (weights over sqrt(fan_in), the label table N(0, 1),
    the positional embedding N(0, 1/C)), as CPU tensors."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, val in TADM.reference_state_dict(module).items():
        if key == "label_emb.weight" or val.dim() < 2:
            fan_in = 1
        elif key.endswith("positional_embedding"):
            fan_in = val.shape[0]
        else:
            fan_in = val[0].numel()
        out[key] = torch.from_numpy(
            (rng.randn(*val.shape) / math.sqrt(fan_in)).astype(np.float32))
    return out


def port_and_jax(module, seed):
    """``module`` loaded with ``reference_weights`` through the JAX package's
    ``adm_state_dict_to_params`` and the port's ``load_adm_jax_params``;
    returns (the module in eval mode, the JAX params, the reference
    state_dict)."""
    ref = reference_weights(module, seed)
    params = JADM.adm_state_dict_to_params(ref)
    load_adm_jax_params(module, params)
    got = TADM.reference_state_dict(module)
    assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    return module.eval(), params, ref


def _x(seed, n=2):
    return np.random.RandomState(seed).randn(n, RES, RES, 3).astype(np.float32)


@pytest.mark.parametrize("setting,net", [("CM_LSUN_SETTING", "ADMUNet"),
                                         ("IMAGENET256_SETTING", "ADMUNet"),
                                         ("IMAGENET256_CLASSIFIER_SETTING", "ADMClassifier")])
def test_full_width_key_sets_match_the_jax_init(setting, net):
    """The full-width 256 px nets on the meta device: the JAX package's
    converter maps the port's reference-layout keys onto exactly the JAX
    init's params, shape for shape, and the settings are the JAX package's."""
    assert getattr(TADM, setting) == getattr(JADM, setting)
    setting, jax_module = getattr(JADM, setting), getattr(JADM, net)
    port = getattr(TADM, net)(device="meta", **setting)
    args = [jax.random.key(0), jnp.zeros((1, 256, 256, 3)), jnp.ones((1,))]
    if setting.get("num_classes"):
        args.append(jnp.zeros((1,), jnp.int32))
    want = jax.eval_shape(jax_module(**setting).init, *args)["params"]
    zeros = {k: np.broadcast_to(np.float32(0), v.shape)
             for k, v in TADM.reference_state_dict(port).items()}
    # zero-stride views through the converter's transposes, without its
    # contiguous f32 copies (2.2 GB for the U-Net): the shapes are what counts
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np, "ascontiguousarray", lambda a, dtype=None: a)
        got = JADM.adm_state_dict_to_params(zeros)
    assert jax.tree.map(np.shape, got) == jax.tree.map(lambda s: s.shape, want)


UNET_CASES = {
    "plain": (dict(resblock_updown=False), {}),
    "scale_shift_updown": (dict(use_scale_shift_norm=True), {}),
    "class_conditional": (dict(num_classes=7, out_channels=6, use_scale_shift_norm=True), {}),
    "new_attention_order": (dict(use_new_attention_order=True), {}),
    "heads_from_num_heads": (dict(num_head_channels=-1, num_heads=2), {}),
    "avgpool_resample": (dict(resblock_updown=False, conv_resample=False), {}),
    "return_bottleneck": ({}, dict(return_bottleneck=True)),
}


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_adm_unet_matches_jax(case):
    change, call = UNET_CASES[case]
    kw = dict(TINY_UNET, **change)
    port, params, _ = port_and_jax(factory.init_params(TADM.ADMUNet(device="cpu", **kw)), seed=1)
    x = _x(2) * 2.0
    t = np.array([3.0, 700.0], np.float32)
    y = np.array([4, 0]) if kw.get("num_classes") else None
    net = JADM.ADMUNet(**kw)
    want = jax.jit(lambda p, x, t, y: net.apply({"params": p}, x, t, y, **call))(
        params, jnp.asarray(x), jnp.asarray(t), None if y is None else jnp.asarray(y))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   None if y is None else torch.from_numpy(y), **call)
    if call:
        got, bottleneck = got
        want, want_b = want
        assert bottleneck.shape == (2, RES // 2, RES // 2, 64)
        _close(bottleneck.numpy(), want_b, what="middle block")
    assert got.shape == (2, RES, RES, kw["out_channels"])
    _close(got.numpy(), want, what=case)


@pytest.mark.parametrize("pool", ["attention", "adaptive"])
def test_adm_classifier_matches_jax(pool):
    kw = dict(TINY_CLASSIFIER, pool=pool)
    port, params, ref = port_and_jax(
        factory.init_params(TADM.ADMClassifier(device="cpu", **kw)), seed=3)
    if pool == "attention":  # T = 8 * 8 + 1 tokens, Conv1d weights in the file
        assert ref["out.2.positional_embedding"].shape == (64, 65)
        assert ref["out.2.qkv_proj.weight"].shape == (192, 64, 1)
        assert port.out["2"].num_heads == 4
    x = _x(4) * 1.5
    t = np.array([12.0, 950.0], np.float32)
    want = jax.jit(lambda p, x, t: JADM.ADMClassifier(**kw).apply({"params": p}, x, t))(
        params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (2, 7)
    _close(got.numpy(), want, what=pool)


def test_unknown_checkpoint_key_raises_naming_it(tmp_path):
    net = factory.init_params(TADM.ADMUNet(device="cpu", **TINY_CM))
    sd = TADM.reference_state_dict(net)
    with pytest.raises(KeyError, match="input_blocks.1.0.extra.weight"):
        TADM.load_adm_checkpoint(net, {**sd, "input_blocks.1.0.extra.weight": torch.zeros(1)})
    del sd["out.2.bias"]
    with pytest.raises(KeyError, match="out.2.bias"):
        TADM.load_adm_checkpoint(net, sd)


def _patch_settings(monkeypatch):
    """Both packages' factories on the tiny settings."""
    for mod in (factory, JADM):
        monkeypatch.setattr(mod, "CM_LSUN_SETTING", TINY_CM)
        monkeypatch.setattr(mod, "IMAGENET256_SETTING", TINY_ADM)
        monkeypatch.setattr(mod, "IMAGENET256_CLASSIFIER_SETTING", TINY_CLASSIFIER)


def _write(path, module, seed):
    module, _, ref = port_and_jax(module, seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(ref, path)
    return ref


@pytest.mark.parametrize("name", ["lsun_bedroom", "lsun_cat"])
def test_cm_from_a_reference_file_matches_jax(name, monkeypatch, tmp_path):
    """A consistency-models file in the reference layout, written here:
    lsun_bedroom found as the zoo's ``edm_bedroom256_ema.pt`` in
    ./checkpoints, lsun_cat (no zoo file) from its path.  The port loads it
    strictly through ``create_model``; D and the AMED tap against the JAX
    package's ``create_model`` on the same file, at sigma 60 and 0.3."""
    _patch_settings(monkeypatch)
    monkeypatch.chdir(tmp_path)
    path = "checkpoints/edm_bedroom256_ema.pt" if name == "lsun_bedroom" else "cat.pt"
    ref = _write(path, factory.init_params(TADM.ADMUNet(device="cpu", **TINY_CM)), seed=5)
    model_path = None if name == "lsun_bedroom" else path
    pre_t, source = factory.create_model(name, model_path, device="cpu")
    pre_j, _, source_j = JF.create_model(name, model_path)
    assert (source, source_j) == ("cm", "cm") and isinstance(pre_t, CMPrecond)
    assert all(torch.equal(TADM.reference_state_dict(pre_t.net)[k], ref[k]) for k in ref)
    assert not any(p.requires_grad for p in pre_t.net.parameters())
    assert (pre_t.sigma_min, pre_t.sigma_max) == (pre_j.sigma_min, pre_j.sigma_max)
    s = np.array([60.0, 0.3], np.float32)
    x = _x(6) * s[:, None, None, None]
    want, want_b = jax.jit(pre_j.with_bottleneck)(jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        got, got_b = pre_t.with_bottleneck(torch.from_numpy(x), torch.from_numpy(s))
        plain = bind(pre_t)(torch.from_numpy(x), torch.from_numpy(s))
    _close(got.numpy(), want, what="D")
    _close(got_b.numpy(), want_b, what="middle block")
    assert torch.equal(plain, got)
    assert np.abs(got.numpy() - x * 0.25 / (s[:, None, None, None] ** 2 + 0.25)).max() > 0.1
    if name == "lsun_cat":
        with pytest.raises(ValueError, match="--model_path"):
            factory.create_model("lsun_cat", None, device="cpu")


def _as_jax_arrays(tree):
    for key, val in tree.items():
        if isinstance(val, dict):
            _as_jax_arrays(val)
        else:
            tree[key] = jnp.asarray(val)


def test_cg_from_the_zoo_files_matches_jax(monkeypatch, tmp_path):
    """ImageNet-256: the net and its classifier written as the zoo's
    ``256x256_diffusion.pt`` and ``256x256_classifier.pt`` in ./checkpoints,
    loaded by both packages' ``create_model(.., None)``; D with the
    classifier's gradient at sigma 20 and 0.4 against the JAX package's,
    with the same sigma range bit for bit.  An explicit model path finds
    the classifier beside it; a missing classifier raises naming it."""
    _patch_settings(monkeypatch)
    monkeypatch.chdir(tmp_path)
    _write("checkpoints/256x256_diffusion.pt",
           factory.init_params(TADM.ADMUNet(device="cpu", **TINY_ADM)), seed=7)
    _write("checkpoints/256x256_classifier.pt",
           factory.init_params(TADM.ADMClassifier(device="cpu", **TINY_CLASSIFIER)), seed=8)
    pre_t, source = factory.create_model("imagenet256", None, guidance_rate=2.0, device="cpu")
    pre_j, params_j, source_j = JF.create_model("imagenet256", None, guidance_rate=2.0)
    for tree in params_j.values():  # numpy leaves to jax arrays in place, where the
        _as_jax_arrays(tree)        # closures see them: a traced label indexes the table
    assert (source, source_j) == ("adm", "adm") and isinstance(pre_t, CGPrecond)
    assert (pre_t.sigma_min, pre_t.sigma_max) == (pre_j.sigma_min, pre_j.sigma_max)
    s = np.array([20.0, 0.4], np.float32)
    x = _x(9) * s[:, None, None, None]
    y = np.array([5, 2])
    want = jax.jit(pre_j.__call__)(jnp.asarray(x), jnp.asarray(s), jnp.asarray(y))
    with torch.no_grad():  # as a sampler calls it: the gradient is taken all the same
        got = bind(pre_t)(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(y))
    # D = clamp(x - sigma * eps): an f32 difference in eps shows sigma-fold,
    # so the bound is 1e-5 of max|x| rather than of the clamped max|D| = 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(x).max())
    grad = np.asarray(jax.jit(lambda x: pre_j._cond_grad(x, jnp.asarray([700.0, 80.0]),
                                                         jnp.asarray(y)))(jnp.asarray(x)))
    got_g = pre_t._cond_grad(torch.from_numpy(x), torch.tensor([700.0, 80.0]),
                             torch.from_numpy(y))
    _close(got_g.numpy(), grad, what="classifier gradient")
    assert np.abs(grad).max() > 0
    # the learned-variance channels are dropped, D is clamped
    assert got.shape == x.shape and np.abs(got.numpy()).max() <= 1.0

    pre_p, _ = factory.create_model("imagenet256", "checkpoints/256x256_diffusion.pt",
                                    guidance_rate=2.0, device="cpu")
    with torch.no_grad():
        again = bind(pre_p)(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(y))
    assert torch.equal(again, got)
    os.remove("checkpoints/256x256_classifier.pt")
    with pytest.raises(FileNotFoundError, match="256x256_classifier.pt"):
        factory.create_model("imagenet256", "checkpoints/256x256_diffusion.pt", device="cpu")


def test_cg_sigma_maps_match_jax():
    """The VP maps and the sigma range, on dataclasses over no net."""
    kw = dict(model_fn=None, classifier_fn=None, img_resolution=RES, img_channels=3,
              label_dim=7)
    pre_t, pre_j = CGPrecond(**kw), JP.CGPrecond(**kw)
    assert (pre_t.sigma_min, pre_t.sigma_max) == (pre_j.sigma_min, pre_j.sigma_max)
    t = np.array([1e-3, 0.02, 0.5, 1.0], np.float32)
    s = np.array([0.01, 0.5, 3.0, 80.0], np.float32)
    np.testing.assert_allclose(pre_t.sigma(torch.from_numpy(t)).numpy(),
                               np.asarray(pre_j.sigma(jnp.asarray(t))), rtol=2e-6)
    np.testing.assert_allclose(pre_t.sigma_inv(torch.from_numpy(s)).numpy(),
                               np.asarray(pre_j.sigma_inv(jnp.asarray(s))), rtol=2e-6)
