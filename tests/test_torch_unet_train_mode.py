"""The EDM nets' augment labels, dropout and label dropout against the JAX
package's.

Tiny nets of both kinds under ``EDMPrecond`` (a class-conditional SongUNet,
16x16, 16 channels, mult [1, 2], attention at 8x8; a class-conditional
DhariwalUNet, 64 channels, 2 heads of d=64 at 8x8), each with EDM's
``augment_dim=9``, CIFAR-10's dropout 0.13 and a label dropout of 0.3.  The
JAX init runs with augment labels (so ``map_augment`` exists) and every
param is redrawn at unit scale (DhariwalUNet's zero-init ``map_augment``
and the output convs would otherwise hide the inputs), then loaded into
the port.  Inputs, labels and augment labels are numpy draws.

Train mode is the JAX ``deterministic=False``.  The two packages draw
their Bernoulli masks from different generators, so they are held on the
same masks: the port's draws (``models.layers._keep_mask``) are patched to
numpy and recorded, and ``jax.random.bernoulli`` is patched to hand that
record back in order (label dropout first, then each block's dropout in
the order the blocks run).  f32 on the CPU.

Bounds: D 1e-4 * max|D| (PARITY.md section 2.6's bar, as
tests/test_torch_unet.py); dropout and label dropout at rates 0 and 1
exact (rate 0 is the eval-mode net bit for bit; label dropout at rate 1 is
the net on zero labels bit for bit); remat against no remat in train mode
on the default generator bit-equal.
"""

import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models.precond import EDMPrecond as JEDMPrecond
from diff_sampler_tpu_torch.models import layers as TLY
from diff_sampler_tpu_torch.models.convert import load_jax_params
from diff_sampler_tpu_torch.models.precond import EDMPrecond, bind

RES, LABELS, AUG = 16, 5, 9
NETS = {
    "SongUNet": dict(model_channels=16, channel_mult=[1, 2], num_blocks=1,
                     attn_resolutions=[8]),
    "DhariwalUNet": dict(model_channels=64, channel_mult=[1, 2], num_blocks=1,
                         attn_resolutions=[8]),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n=3):
    rng = np.random.RandomState(seed)
    sigma = np.array([40.0, 2.0, 0.3][:n], np.float32)
    x = (rng.randn(n, RES, RES, 3) * sigma[:, None, None, None]).astype(np.float32)
    labels = np.eye(LABELS, dtype=np.float32)[rng.randint(LABELS, size=n)]
    aug = (rng.randn(n, AUG) * (rng.rand(n, AUG) < 0.5)).astype(np.float32)
    return x, sigma, labels, aug


@functools.lru_cache(maxsize=None)
def _shapes(model_type):
    """The JAX param tree's shapes (no init run; the rates change none)."""
    kw = dict(NETS[model_type], augment_dim=AUG)
    net = JEDMPrecond(img_resolution=RES, img_channels=3, label_dim=LABELS,
                      model_type=model_type, model_kwargs=kw)
    x, sigma, labels, aug = _inputs(0, n=1)
    return jax.eval_shape(lambda: net.init(jax.random.key(0), x, sigma, labels,
                                           augment_labels=aug))["params"]


def _pair(model_type, dropout=0.13, label_dropout=0.3, remat=False):
    """(the JAX EDMPrecond, its unit-scale params, the port's EDMPrecond on
    the same params)."""
    kw = dict(NETS[model_type], augment_dim=AUG, dropout=dropout, label_dropout=label_dropout)
    net = JEDMPrecond(img_resolution=RES, img_channels=3, label_dim=LABELS,
                      model_type=model_type, model_kwargs=kw)
    shapes = _shapes(model_type)
    rng = np.random.RandomState(1)

    def draw(a):
        fan_in = int(np.prod(a.shape[:-1])) if len(a.shape) > 1 else 1
        return (rng.randn(*a.shape) / math.sqrt(fan_in)).astype(np.float32)

    params = jax.tree.map(draw, shapes)
    port = EDMPrecond(img_resolution=RES, img_channels=3, label_dim=LABELS,
                      model_type=model_type, model_kwargs=dict(kw, remat=remat))
    return net, params, load_jax_params(port, params)


@pytest.fixture(scope="module", params=sorted(NETS))
def pair(request):
    return request.param, _pair(request.param)


class _Masks:
    """The port's Bernoulli masks, drawn by numpy and recorded, then handed
    to ``jax.random.bernoulli`` in the same order."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.masks = []

    def patch_port(self, monkeypatch):
        def draw(shape, keep, generator, device):
            self.masks.append(self.rng.rand(*shape) < keep)
            return torch.from_numpy(self.masks[-1])

        monkeypatch.setattr(TLY, "_keep_mask", draw)

    def patch_jax(self, monkeypatch):
        replay = iter(self.masks)

        def bernoulli(key, p=0.5, shape=None, **kw):
            m = next(replay)
            assert m.shape == tuple(shape), (m.shape, shape)
            return jnp.asarray(m)

        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)


def _close(got, want, rel=1e-4, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _port_d(port, x, sigma, labels, aug, train=False, generator=None):
    port.train(train)
    with torch.no_grad():
        return port(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(labels),
                    augment_labels=None if aug is None else torch.from_numpy(aug),
                    generator=generator).numpy()


def _jax_d(net, params, x, sigma, labels, aug, train=False):
    """D of the JAX net under ``jax.jit`` (one compile costs less than the
    first eager run's per-op compiles); a patched ``bernoulli`` is traced in
    as constant masks."""
    rngs = {"dropout": jax.random.key(1), "label_dropout": jax.random.key(2)} if train else {}
    apply = jax.jit(lambda p, x, s, y, a: net.apply({"params": p}, x, s, y,
                                                    deterministic=not train, augment_labels=a,
                                                    rngs=rngs))
    return np.asarray(apply(params, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labels),
                            None if aug is None else jnp.asarray(aug)))


def test_augment_labels_through_edmprecond_match_jax(pair):
    """Eval mode: D with augment labels; without them ``map_augment`` is
    skipped, as the JAX net skips it (the path tests/test_torch_unet.py and
    tests/test_torch_dhariwal.py hold), and D moves."""
    name, (net, params, port) = pair
    x, sigma, labels, aug = _inputs(3)
    with_aug = _port_d(port, x, sigma, labels, aug)
    _close(with_aug, _jax_d(net, params, x, sigma, labels, aug), what=f"{name} with aug")
    without = _port_d(port, x, sigma, labels, None)
    assert np.abs(with_aug - without).max() > 1e-3 * np.abs(without).max()


def test_dropout_and_label_dropout_on_fixed_masks_match_jax(pair, monkeypatch):
    """Train mode at dropout 0.13 and label dropout 0.3, on the same masks:
    1 label mask [N, 1], then one mask per block; D differs from eval
    mode's."""
    name, (net, params, port) = pair
    x, sigma, labels, aug = _inputs(4)
    masks = _Masks(5)
    masks.patch_port(monkeypatch)
    got = _port_d(port, x, sigma, labels, aug, train=True)
    blocks = sum(1 for m in port.modules() if type(m).__name__ == "UNetBlock")
    assert [m.shape for m in masks.masks[:1]] == [(3, 1)] and len(masks.masks) == 1 + blocks
    masks.patch_jax(monkeypatch)
    want = _jax_d(net, params, x, sigma, labels, aug, train=True)
    _close(got, want, what=f"{name} train mode")
    assert np.abs(got - _port_d(port, x, sigma, labels, aug)).max() > 1e-3 * np.abs(got).max()


@pytest.mark.parametrize("model_type", sorted(NETS))
def test_rates_zero_and_one_are_exact(model_type, monkeypatch):
    """Rate 0: train mode draws nothing and is the eval-mode net bit for bit
    (which the test above holds to JAX).  Dropout rate 1: each block's
    residual branch is conv1(0), with no draw; label dropout rate 1: the
    net on zero labels, bit for bit; both against the JAX train-mode net."""
    x, sigma, labels, aug = _inputs(6)
    net, params, port = _pair(model_type, dropout=0.0, label_dropout=0.0)
    calls = []
    monkeypatch.setattr(TLY, "_keep_mask", lambda *a: calls.append(a))
    train = _port_d(port, x, sigma, labels, aug, train=True)
    assert not calls
    np.testing.assert_array_equal(train, _port_d(port, x, sigma, labels, aug))
    monkeypatch.undo()

    net, params, port = _pair(model_type, dropout=1.0, label_dropout=1.0)
    masks = _Masks(7)
    masks.patch_port(monkeypatch)
    got = _port_d(port, x, sigma, labels, aug, train=True)
    assert len(masks.masks) == 1 and not masks.masks[0].any()  # labels only: dropout 1 draws none
    port_zero = copy.deepcopy(port)
    for m in port_zero.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 1.0
    want_zero_labels = _port_d(port_zero, x, sigma, np.zeros_like(labels), aug, train=True)
    np.testing.assert_array_equal(got, want_zero_labels)
    masks.patch_jax(monkeypatch)
    _close(got, _jax_d(net, params, x, sigma, labels, aug, train=True), what="rate 1")


def test_remat_in_train_mode_takes_the_default_generator_and_refuses_another():
    """With ``remat`` the backward recomputes each block and draws its
    dropout mask again from the default generator, whose state
    ``checkpoint`` keeps: the gradients are the plain net's bit for bit.  An
    explicit generator is refused there."""
    x, sigma, labels, aug = _inputs(8)
    _, params, plain = _pair("SongUNet")
    _, _, remat = _pair("SongUNet", remat=True)
    remat.load_state_dict(plain.state_dict())
    out = {}
    for key, port in (("plain", plain), ("remat", remat)):
        port.train()
        torch.manual_seed(11)
        xt = torch.from_numpy(x).requires_grad_(True)
        d = port(xt, torch.from_numpy(sigma), torch.from_numpy(labels),
                 augment_labels=torch.from_numpy(aug))
        grads = torch.autograd.grad(d.square().sum(), [xt] + list(port.parameters()))
        out[key] = (d.detach(), grads)
    for a, b in zip(out["plain"][1], out["remat"][1]):
        assert torch.equal(a, b)
    assert torch.equal(out["plain"][0], out["remat"][0])
    with pytest.raises(ValueError, match="default generator"):
        remat(torch.from_numpy(x).requires_grad_(True), torch.from_numpy(sigma),
              torch.from_numpy(labels), augment_labels=torch.from_numpy(aug),
              generator=torch.Generator().manual_seed(11))


def test_train_mode_draws_from_the_generator_and_bind_refuses_it():
    x, sigma, labels, aug = _inputs(9)
    _, _, port = _pair("DhariwalUNet")
    a = _port_d(port, x, sigma, labels, aug, True, torch.Generator().manual_seed(3))
    b = _port_d(port, x, sigma, labels, aug, True, torch.Generator().manual_seed(3))
    c = _port_d(port, x, sigma, labels, aug, True, torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
    port.train()
    with pytest.raises(ValueError, match="eval"):
        bind(port)
