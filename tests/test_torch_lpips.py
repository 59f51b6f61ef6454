"""The port's LPIPS (``eval/lpips.py``) against the JAX package's.

As JAX's ``tests/test_analysis_lpips.py`` runs it: ``resize_to=32`` on 16 px
inputs, with weights drawn by numpy in the JAX param tree's shapes (the
heads at both signs, so ``|lin_i|`` shows) and carried over by
``convert.lpips_state_dict_from_jax``.  The resize alone at 32 -> 224
(bilinear up), 64 -> 224 and 256 -> 224 (antialiased down) against
``jax.image.resize``.  One SFD second-stage step with LPIPS at the last
segment, against JAX's ``make_train_step(lpips_fn=...)``, on a tiny
one-level SongUNet (16 px, 16 channels, no attention: the JAX step's trace
and XLA compile take ~11 s, most of this file's time).  f32 on the CPU.

Bounds: the distances 1e-5 relative; the premetric's zero and symmetry
exact; the resize's weights 2^-23 and its images 1e-5 * max (the sums
run in another order); the loaders exact; the SFD step's loss 1e-5
relative and its SGD params within 1e-4 of the step's largest move
(tests/test_torch_sfd.py's bound).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diff_sampler_tpu.eval.lpips import LPIPS as JLPIPS
from diff_sampler_tpu.eval.lpips import lpips_params_from_torch
from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.training import sfd as JS
from diff_sampler_tpu_torch.eval import inception as TI
from diff_sampler_tpu_torch.eval.inception import resize_nhwc
from diff_sampler_tpu_torch.eval.lpips import LPIPS, VGG_CONV_INDICES, load_lpips_weights
from diff_sampler_tpu_torch.models.convert import lpips_state_dict_from_jax, params_to_jax
from diff_sampler_tpu_torch.models.factory import init_params
from diff_sampler_tpu_torch.models.precond import EDMPrecond
from diff_sampler_tpu_torch.training import sfd as TS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed, resize_to=32):
    """The JAX LPIPS param tree's shapes (no init run), drawn by numpy: LeCun
    normal kernels, small biases, heads N(0, 1) (negative entries too)."""
    shapes = jax.eval_shape(JLPIPS(resize_to=resize_to).init, jax.random.key(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.randn(*a.shape) / math.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        return (rng.randn(*a.shape) * (0.1 if "bias" in name else 1.0)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(seed=0, resize_to=32):
    params = _jax_params(seed, resize_to)
    port = LPIPS(resize_to=resize_to, device="cpu")
    port.load_state_dict(lpips_state_dict_from_jax(params))
    return params, port.requires_grad_(False)


def _images(seed, n=3, size=16):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 2 - 1).astype(np.float32)


def test_lpips_matches_jax_and_is_a_premetric():
    params, port = _pair()
    x, y = _images(1), _images(2)
    net = JLPIPS(resize_to=32)
    want = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x), jnp.asarray(y)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = port(tx, ty).numpy()
    assert got.shape == (3,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(port(tx, tx).numpy(), np.zeros(3, np.float32))
    np.testing.assert_array_equal(port(ty, tx).numpy(), got)


@pytest.mark.parametrize("size", [32, 64, 256])
def test_resize_to_224_matches_jax_image_resize(size):
    """Bilinear with half-pixel centres growing 32 -> 224; shrinking 256 ->
    224 and the antialiased triangle widened by the scale; 64 grows.  The
    per-axis weight matrices are JAX's ``compute_weight_mat`` within 2^-23
    (at 256 -> 224, 24 of them an ulp apart: the column totals are summed
    in another order); the images agree within 1e-5 * max (JAX contracts
    both axes in one einsum, the port one axis at a time)."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    np.testing.assert_allclose(
        TI._resize_weights(size, 224, "cpu", "bilinear").numpy(),
        np.asarray(compute_weight_mat(size, 224, 224 / size, 0.0, _fill_triangle_kernel, True)),
        rtol=0, atol=2.0 ** -23)
    x = np.random.RandomState(size).rand(2, size, size, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), "bilinear"))
    got = resize_nhwc(torch.from_numpy(x), 224, 224, "bilinear").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_weights_load_from_torchvision_and_lpips_layouts():
    """A torchvision ``vgg16()`` state_dict (features and classifier) and the
    LPIPS heads load strictly by name; the JAX package's
    ``lpips_params_from_torch`` reads the same files into the tree that
    ``lpips_state_dict_from_jax`` brings back, bit for bit."""
    g = torch.Generator().manual_seed(3)
    vgg_sd = {"classifier.0.weight": torch.zeros(4, 4)}
    cin = 3
    for i, (ch, n) in zip(VGG_CONV_INDICES, [(64, 0)] * 2 + [(128, 0)] * 2 + [(256, 0)] * 3
                          + [(512, 0)] * 6):
        vgg_sd[f"features.{i}.weight"] = torch.randn(ch, cin, 3, 3, generator=g)
        vgg_sd[f"features.{i}.bias"] = torch.randn(ch, generator=g)
        cin = ch
    lin_sd = {f"lin{i}.model.1.weight": torch.randn(1, ch, 1, 1, generator=g)
              for i, ch in enumerate((64, 128, 256, 512, 512))}
    port = load_lpips_weights(LPIPS(device="cpu"), vgg_sd, lin_sd)
    via_jax = lpips_state_dict_from_jax(lpips_params_from_torch(vgg_sd, lin_sd))
    assert set(via_jax) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(v, via_jax[k]), k
    assert torch.equal(port.features["28"].weight, vgg_sd["features.28.weight"])
    del lin_sd["lin4.model.1.weight"]
    with pytest.raises(KeyError, match="lin4"):
        load_lpips_weights(LPIPS(device="cpu"), vgg_sd, lin_sd)


def test_sfd_second_stage_step_with_lpips_matches_jax():
    """One trajectory of the second stage (2 steps, M=0, the euler teacher,
    so the one segment is the last and takes lpips(student, teacher).mean()
    on every element), SGD(1e-4), against JAX's ``make_train_step`` with the
    JAX LPIPS as ``lpips_fn``.  The teacher is the student with every
    weight + 0.01 (as JAX's test), so the two differ.  The step without
    LPIPS gives another loss: the term is there."""
    kw = dict(model_channels=16, channel_mult=[1], num_blocks=1, attn_resolutions=[],
              dropout=0.0)
    port = init_params(EDMPrecond(img_resolution=16, img_channels=3, model_kwargs=kw).eval())
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for p in port.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) / math.sqrt(fan_in))
    params = params_to_jax(port.state_dict())
    lp_params, lp = _pair(seed=5)
    jlp = JLPIPS(resize_to=32)
    cfg = TS.SFDConfig(num_steps=2, M=0, sampler_tea="euler", is_second_stage=True,
                       sigma_min=0.006)
    lat = rng.randn(2, 16, 16, 3).astype(np.float32)
    lr = 1e-4
    net = JP.EDMPrecond(img_resolution=16, img_channels=3, model_kwargs=kw)
    step = jax.jit(JS.make_train_step(
        net, JS.SFDConfig(num_steps=2, M=0, sampler_tea="euler", is_second_stage=True,
                          sigma_min=0.006), optax.sgd(lr),
        lpips_fn=lambda a, b: jlp.apply({"params": lp_params}, a, b)))
    opt_j = optax.sgd(lr)
    teacher_params = jax.tree.map(lambda a: a + np.float32(0.01), params)
    want, _, m = step(params, opt_j.init(params), teacher_params, jnp.asarray(lat))
    want = jax.tree.map(np.asarray, want)

    losses = {}
    for name, fn in (("lpips", lp), ("none", None)):
        student = copy.deepcopy(port)
        teacher = copy.deepcopy(port).requires_grad_(False)
        with torch.no_grad():
            for p in teacher.parameters():
                p.add_(0.01)
        opt = torch.optim.SGD(TS.trainable(student), lr=lr)
        metrics = TS.make_train_step(student, teacher, cfg, opt, lpips_fn=fn)(
            torch.from_numpy(lat))
        losses[name] = metrics["loss_per_step"].numpy()
        if fn is not None:
            got = params_to_jax(student.state_dict())
    np.testing.assert_allclose(losses["lpips"], np.asarray(m["loss_per_step"]), rtol=1e-5)
    assert abs(losses["lpips"][0] - losses["none"][0]) > 1e-3 * abs(losses["none"][0])
    flat_g, flat_w, flat_s = (jax.tree.leaves(t) for t in (got, want, params))
    move = max(float(np.abs(w - s).max()) for w, s in zip(flat_w, flat_s))
    err = max(float(np.abs(g - w).max()) for g, w in zip(flat_g, flat_w))
    assert move > 1e-4, move
    assert err <= 1e-4 * move, (err, move)
