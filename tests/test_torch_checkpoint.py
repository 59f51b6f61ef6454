"""The port's checkpoint loading against the JAX package's: the restricted
loader (``models/torch_import.py``), the zoo's local resolver
(``models/zoo.py``) and ``create_model`` on a checkpoint file.

Every file here is synthetic, written by the test from seeded weights in the
reference's layouts: torch zip archives (``torch.save``) of state_dicts and
of module objects, plain pickles (``pickle.dump``, legacy storages, as EDM's
``.pkl``), bf16 / f16 storages, each container key, views of shared
storages.  On the same file both loaders give the same key set and
bit-equal arrays (floating tensors f32 in the port).

From a file to D: a tiny EDM (SongUNet), a tiny LSUN LDM (legacy attention,
VQ) and a tiny Stable Diffusion (spatial transformers, KL, a tiny CLIP text
tower over a synthetic BPE merges file) are written from the JAX side's
params (a JAX init redrawn at unit scale), loaded by the port's
``create_model`` and by the JAX package's loaders from the same file; D
agrees within 1e-5 * max|D| (SD: with each side's own text contexts, which
agree within 1e-5 * max).  One full-width check runs no forward: every key
of a CIFAR-10 and an SD v1.5 checkpoint is matched, and only the named
ignores are left over.
"""

import math
import os
import pickle
import socket
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import factory as JF
from diff_sampler_tpu.models import ldm as JL
from diff_sampler_tpu.models import precond as JP
from diff_sampler_tpu.models import text as JTX
from diff_sampler_tpu.models import torch_import as JI
from diff_sampler_tpu.models import zoo as JZ
from diff_sampler_tpu.models.precond import EDMPrecond as JEDMPrecond
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import ldm as TL
from diff_sampler_tpu_torch.models import text as TTX
from diff_sampler_tpu_torch.models import torch_import as TI
from diff_sampler_tpu_torch.models import zoo
from diff_sampler_tpu_torch.models.convert import load_jax_params, load_ldm_jax_params
from diff_sampler_tpu_torch.models.convert import params_from_jax
from diff_sampler_tpu_torch.models.precond import EDMPrecond, bind
from test_torch_text import _merges_file, flax_clip_params

EDM_TINY = (dict(img_resolution=16, img_channels=3, label_dim=0, model_type="SongUNet"),
            dict(model_channels=16, channel_mult=[1, 2], num_blocks=1, attn_resolutions=[8],
                 dropout=0.0, augment_dim=9))
LDM_TINY = dict(
    linear_start=0.0015, linear_end=0.0195, timesteps=1000, scale_factor=1.0,
    conditioning_key=None, first_stage="vq",
    unet=dict(image_size=8, in_channels=3, out_channels=3, model_channels=32,
              attention_resolutions=(1, 2), num_res_blocks=1, channel_mult=(1, 2),
              num_head_channels=16),
    vae=dict(z_channels=3, resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(16,)),
    n_embed=32, embed_dim=3)
SD_TINY = dict(
    linear_start=0.00085, linear_end=0.0120, timesteps=1000, scale_factor=0.18215,
    conditioning_key="crossattn", first_stage="kl",
    unet=dict(image_size=8, in_channels=4, out_channels=4, model_channels=32,
              num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2,
              use_spatial_transformer=True, transformer_depth=1, context_dim=16, legacy=False),
    vae=dict(z_channels=4, resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(), double_z=True),
    embed_dim=4)
GUIDANCE = 7.5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clip_config(width: int) -> dict:
    """A tiny CLIP text tower of ``width`` (the U-Net's context_dim) over a
    vocab that holds the synthetic merges' ids."""
    return dict(vocab_size=600, hidden_size=width, intermediate_size=2 * width,
                num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=77)


def patch_tiny_sd(mp, config, tmp_path):
    """Both packages on the tiny SD ``config``: its LDM config, a tiny CLIP
    tower of its context width, the synthetic merges file through
    $CLIP_BPE_VOCAB, and the JAX package's torch -> Flax CLIP converter
    done through an initialised model (``test_torch_text.flax_clip_params``)."""
    clip = clip_config(config["unet"]["context_dim"])
    mp.setitem(TL.LDM_CONFIGS, "ms_coco", config)
    mp.setitem(JL.LDM_CONFIGS, "ms_coco", config)
    mp.setattr(TTX, "_CLIP_TEXT_CONFIG", clip)
    mp.setattr(JTX, "_CLIP_TEXT_CONFIG", clip)
    mp.setattr(JTX, "clip_text_params_from_state_dict", flax_clip_params)
    mp.setenv("CLIP_BPE_VOCAB", _merges_file(tmp_path))


def _rescaled(params, seed):
    """A JAX params tree redrawn at unit scale (the zero-init output convs
    would hide the net)."""
    rng = np.random.RandomState(seed)

    def draw(a):
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        return (rng.randn(*a.shape) / math.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, params)


def _redraw_unit_scale(module, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                    / math.sqrt(fan_in))


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# The restricted loader
# ---------------------------------------------------------------------------


class _Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3)
        self.norm = torch.nn.GroupNorm(2, 8)
        self.register_buffer("table", torch.linspace(0, 1, 5, dtype=torch.float64))
        self.register_buffer("count", torch.tensor([7, 8], dtype=torch.int64))
        self.register_buffer("mask", torch.tensor([True, False, True]))


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.block = _Block()
        self.fc = torch.nn.Linear(8, 4)


def _net(dtype=torch.float32):
    torch.manual_seed(0)
    net = _Net()
    with torch.no_grad():
        for p in net.parameters():
            p.normal_()
    return net.to(dtype) if dtype != torch.float32 else net


def _write(path, kind):
    """A synthetic checkpoint of ``kind``; returns the state_dict it holds."""
    net = _net(torch.bfloat16 if "bf16" in kind else torch.float16 if "f16" in kind
               else torch.float32)
    sd = net.state_dict()
    if kind.startswith("zip-state_dict"):
        torch.save(sd, path)
    elif kind.startswith("zip-"):  # the module object under a container key
        torch.save({kind.split("-")[1]: net, "meta": {"note": "x"}}, path)
    elif kind.startswith("plain-"):
        with open(path, "wb") as f:
            pickle.dump({kind.split("-")[1]: net, "augment_pipe": None}, f)
    return sd


KINDS = ["zip-state_dict", "zip-state_dict-bf16", "zip-ema", "zip-model", "zip-net",
         "zip-state_dict-f16", "plain-ema", "plain-net-bf16", "plain-model-f16"]


def _both(path):
    """(the port's state_dict, the JAX package's) of one file."""
    return (TI.torch_state_dict(TI.load_torch_file(str(path))),
            JI.torch_state_dict(JI.load_torch_file(str(path))))


def _same(got, want, source=None):
    assert set(got) == set(want)
    for k, v in got.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu", k
        ref = np.asarray(want[k])
        if v.is_floating_point():
            assert v.dtype == torch.float32, k  # f16 / bf16 / f64 storages -> f32
        np.testing.assert_array_equal(v.numpy(), ref.astype(v.numpy().dtype), err_msg=k)
        if source is not None:
            np.testing.assert_array_equal(v.numpy(), source[k].to(v.dtype).numpy(), err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_loader_matches_jax_on_synthetic_files(tmp_path, kind):
    path = tmp_path / "ckpt"
    source = _write(path, kind)
    got, want = _both(path)
    _same(got, want, source)
    assert got["block.count"].dtype == torch.int64 and got["block.mask"].dtype == torch.bool


def test_loader_matches_jax_on_views_of_shared_storages(tmp_path):
    """Tensors that view one storage (slices, a transpose) come out as the
    JAX loader's copies, and writable."""
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    sd = {"whole": base, "rows": base[1:3], "cols": base[:, 2:5], "t": base.t(),
          "other": torch.randn(3, generator=torch.Generator().manual_seed(1))}
    for name, writer in (("zip", lambda p: torch.save(sd, p)),
                         ("plain", lambda p: pickle.dump(sd, open(p, "wb")))):
        path = tmp_path / name
        writer(path)
        got, want = _both(path)
        _same(got, want, sd)
        got["rows"].add_(1.0)  # writable: the loader copied the read-only bytes


def test_zero_dim_tensors_load_where_the_jax_loader_refuses(tmp_path):
    """A 0-dim tensor (LDM checkpoints' ``model_ema.decay``, a module's
    ``num_batches_tracked``) is a tensor in the port.  The JAX loader makes
    it a numpy scalar, which its state_dict search then refuses (a flat
    dict) or drops (a module walk) (ROADMAP Queue 3)."""
    base = torch.arange(6.0)
    sd = {"w": base, "view": base[4], "model_ema.decay": torch.tensor(0.9999),
          "model_ema.num_updates": torch.tensor(5, dtype=torch.int32)}
    torch.save({"state_dict": sd}, tmp_path / "a.ckpt")
    got = TI.torch_state_dict(TI.load_torch_file(str(tmp_path / "a.ckpt")))
    assert set(got) == set(sd) and got["model_ema.decay"].shape == ()
    assert got["model_ema.num_updates"].item() == 5 and got["view"].item() == 4.0
    with pytest.raises(ValueError, match="could not locate a state_dict"):
        JI.torch_state_dict(JI.load_torch_file(str(tmp_path / "a.ckpt")))
    bn = torch.nn.BatchNorm2d(3)
    with open(tmp_path / "bn.pkl", "wb") as f:
        pickle.dump({"ema": bn}, f)
    got, want = _both(tmp_path / "bn.pkl")
    assert set(got) == set(bn.state_dict()) == set(want) | {"num_batches_tracked"}


@pytest.mark.parametrize("fmt", ["zip", "plain"])
def test_a_pickle_that_would_run_code_loads_inert(tmp_path, fmt):
    """A reduce to ``exec`` becomes a stub on both sides: nothing runs."""
    marker = tmp_path / "ran"

    class Evil:
        def __reduce__(self):
            return (exec, (f"open({str(marker)!r}, 'w').write('x')",))

    obj = {"state_dict": {"w": torch.ones(2)}, "payload": Evil()}
    path = tmp_path / "evil"
    if fmt == "zip":
        torch.save(obj, path)
    else:
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    for load in (TI.load_torch_file, JI.load_torch_file):
        loaded = load(str(path))
        assert type(loaded["payload"]).__name__ == "exec"
        assert loaded["payload"].args == (f"open({str(marker)!r}, 'w').write('x')",)
    assert not marker.exists()
    got, want = _both(path)
    _same(got, want)


def dump_edm_pkl(obj, f) -> int:
    """``pickle.dump(obj, f)`` as EDM's ``.pkl`` holds its nets: every
    module class outside torch (EDM decorates each of its layer classes with
    ``persistence.persistent_class``) reduces to
    ``torch_utils.persistence._reconstruct_persistent_obj(meta)``, the
    module's __dict__ in ``meta['state']`` and no BUILD; torch's own modules
    (ModuleDict, Dropout) pickle plainly.  The reconstruct function is a
    stand-in under EDM's module name while the dump runs, and raises if
    anything calls it.  Returns the number of modules wrapped."""
    pkg, mod = types.ModuleType("torch_utils"), types.ModuleType("torch_utils.persistence")

    def _reconstruct_persistent_obj(meta):
        raise AssertionError("the loader ran the reconstruct function")

    _reconstruct_persistent_obj.__module__ = mod.__name__
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    mod._reconstruct_persistent_obj, pkg.persistence = _reconstruct_persistent_obj, mod
    wrapped = {}

    def persistent(cls):
        if cls not in wrapped:
            def __reduce__(self):  # torch_utils/persistence.py's Decorator.__reduce__
                fields = list(super(wrapped[cls], self).__reduce__())
                fields += [None] * max(3 - len(fields), 0)
                meta = dict(type="class", version=6, module_src="raise SystemExit",
                            class_name=f"training.networks.{cls.__name__}", state=fields[2])
                return (_reconstruct_persistent_obj, (meta,), None, *fields[3:])

            wrapped[cls] = type(cls.__name__, (cls,), {"__reduce__": __reduce__})
        return wrapped[cls]

    roots = obj.values() if isinstance(obj, dict) else [obj]
    mods = [m for r in roots if isinstance(r, torch.nn.Module) for m in r.modules()
            if not type(m).__module__.startswith("torch.")]
    classes = [type(m) for m in mods]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch_utils", pkg)
        mp.setitem(sys.modules, "torch_utils.persistence", mod)
        try:
            for m in mods:
                m.__class__ = persistent(type(m))
            pickle.dump(obj, f)
        finally:
            for m, cls in zip(mods, classes):
                m.__class__ = cls
    return len(mods)


def test_persistence_wrapped_module_loads_where_the_jax_loader_cannot(tmp_path, monkeypatch):
    """EDM's ``.pkl`` pickles each of its nets' modules through
    ``torch_utils.persistence`` (``dump_edm_pkl``): EDMPrecond, SongUNet,
    each UNetBlock and each Conv2d / Linear / GroupNorm below the plain
    ModuleDicts.  The port walks ``meta['state']`` at every level, loads
    every tensor bit-equal, and ``create_model`` gives the source net's D
    exactly; the JAX loader looks at the (empty) BUILD state and raises
    (ROADMAP Queue 3)."""
    monkeypatch.setitem(factory.EDM_ARCHS, "tiny16", EDM_TINY)
    src = factory.build_edm_model("tiny16", device="cpu")
    _redraw_unit_scale(src, seed=3)
    path = tmp_path / "edm.pkl"
    with open(path, "wb") as f:
        n = dump_edm_pkl({"ema": src, "loss_fn": None, "augment_pipe": None}, f)
    assert n > 20 and type(src).__name__ == "EDMPrecond"
    loaded = TI.load_torch_file(str(path))
    top = loaded["ema"]
    assert type(top).__name__ == "_reconstruct_persistent_obj" and top.state == {}
    child = top.args[0]["state"]["_modules"]["model"]  # the SongUNet: wrapped too
    assert type(child).__name__ == "_reconstruct_persistent_obj" and child.state == {}
    got = TI.torch_state_dict(loaded)
    source = src.state_dict()
    assert set(got) == set(source)
    for k, v in source.items():
        assert torch.equal(got[k], v), k
    port, kind = factory.create_model("tiny16", str(path), device="cpu")
    sigma = torch.tensor([0.02, 0.5, 5.0, 40.0])
    x = torch.from_numpy(np.random.RandomState(4).randn(4, 16, 16, 3).astype(np.float32))
    with torch.no_grad():
        assert kind == "edm" and torch.equal(port(x * sigma[:, None, None, None], sigma),
                                             src(x * sigma[:, None, None, None], sigma))
    with pytest.raises(ValueError, match="no tensors found"):
        JI.torch_state_dict(JI.load_torch_file(str(path)))


# ---------------------------------------------------------------------------
# The zoo's resolver: local files only
# ---------------------------------------------------------------------------


def test_check_file_by_key_finds_local_files_and_never_connects(tmp_path, monkeypatch):
    def no_network(*a, **k):
        raise AssertionError("a network connection was attempted")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.chdir(tmp_path)
    assert zoo.CHECKPOINT_URLS == JZ.CHECKPOINT_URLS and zoo.MODEL_SPECS == JZ.MODEL_SPECS
    assert zoo._COMPANIONS == JZ._COMPANIONS
    with pytest.raises(FileNotFoundError) as err:
        zoo.check_file_by_key("cifar10")
    for part in ("cifar10", "edm-cifar10-32x32-uncond-vp.pkl", "checkpoints",
                 zoo.CHECKPOINT_URLS["cifar10"]):
        assert part in str(err.value)
    with pytest.raises(FileNotFoundError, match="edm-cifar10"):
        factory.create_model("cifar10", None, device="cpu")
    with pytest.raises(FileNotFoundError, match="edm-cifar10"):  # the CLI's way to the zoo
        cli_sample.main(["--dataset_name=cifar10", "--model_path=None", "--device=cpu"])
    os.makedirs("models")
    open("models/edm-cifar10-32x32-uncond-vp.pkl", "wb").close()
    assert zoo.check_file_by_key("cifar10") == (
        os.path.join("models", "edm-cifar10-32x32-uncond-vp.pkl"), [])
    os.makedirs("checkpoints")
    open("checkpoints/v1-5-pruned-emaonly.ckpt", "wb").close()
    with pytest.raises(FileNotFoundError, match="MS-COCO_val2014_30k_captions.csv"):
        zoo.check_file_by_key("ms_coco")  # the captions companion is missing
    os.makedirs("src")
    open("src/MS-COCO_val2014_30k_captions.csv", "w").close()
    assert zoo.check_file_by_key("ms_coco") == (
        os.path.join("checkpoints", "v1-5-pruned-emaonly.ckpt"),
        [os.path.join("src", "MS-COCO_val2014_30k_captions.csv")])
    with pytest.raises(KeyError, match="unknown checkpoint key"):
        zoo.check_file_by_key("cifar100")


# ---------------------------------------------------------------------------
# From a checkpoint file to D
# ---------------------------------------------------------------------------


def _jax_init(module, *args):
    """The params tree of a JAX module's init, every leaf drawn at unit scale
    (``_rescaled``); the init's own values are redrawn, so only its shapes
    are computed (``jax.eval_shape``: no compile)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)["params"]
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.fixture(scope="module")
def jax_edm_params():
    net = JEDMPrecond(img_resolution=16, img_channels=3, model_kwargs=EDM_TINY[1])
    return _rescaled(_jax_init(net, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,))), seed=0)


@pytest.mark.parametrize("layout", ["pkl-module", "pt-state_dict"])
def test_edm_d_from_a_checkpoint_matches_jax(tmp_path, monkeypatch, jax_edm_params, layout):
    """EDM's ``.pkl`` layout (a plain pickle of {'ema': module}, legacy
    storages, with the resample filters and ``map_augment``) and a torch zip
    of the JAX params' state_dict (neither): both load strictly."""
    monkeypatch.setitem(factory.EDM_ARCHS, "tiny16", EDM_TINY)
    monkeypatch.setitem(JF.EDM_ARCHS, "tiny16", EDM_TINY)
    params = jax_edm_params
    path = tmp_path / "edm.ckpt"
    if layout == "pkl-module":
        src = load_jax_params(factory.init_params(factory.build_edm_model("tiny16",
                                                                          device="cpu")), params)
        with open(path, "wb") as f:
            pickle.dump({"ema": src, "loss_fn": None}, f)
    else:
        torch.save(params_from_jax(params), path)
    port, source = factory.create_model("tiny16", str(path), device="cpu")
    assert source == "edm" and not port.training
    if layout == "pt-state_dict":  # absent from the file: zeroed
        assert not port.model.map_augment.weight.any()
    net_j, params_j, _ = JF.create_model("tiny16", str(path))
    sigma = np.array([0.02, 0.5, 5.0, 40.0], np.float32)
    x = np.random.RandomState(1).randn(4, 16, 16, 3).astype(np.float32) * sigma[:, None, None, None]
    want = jax.jit(net_j.apply)({"params": params_j}, jnp.asarray(x), jnp.asarray(sigma))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(sigma)).numpy()
    _close(got, want, what="D")
    assert np.abs(got - x * 0.25 / (sigma[:, None, None, None] ** 2 + 0.25)).max() > 0.1


def test_edm_checkpoint_keys_are_strict(tmp_path):
    """An unexpected key or a missing weight raises; nothing is loaded
    loosely."""
    module = factory.init_params(EDMPrecond(16, 3, model_kwargs=EDM_TINY[1], device="cpu"))
    sd = {k: v.clone() for k, v in module.state_dict().items()}
    bad = dict(sd, **{"model.stray.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="model.stray.weight"):
        factory.load_edm_checkpoint(EDMPrecond(16, 3, model_kwargs=EDM_TINY[1]), bad)
    key = next(k for k in sd if k.endswith("conv0.weight"))
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        factory.load_edm_checkpoint(EDMPrecond(16, 3, model_kwargs=EDM_TINY[1]),
                                    {k: v for k, v in sd.items() if k != key})


def ldm_extras(config, text: bool, scalars: bool = True) -> dict:
    """The parts of a reference LDM / SD checkpoint the port leaves out: a
    few first-stage encoder weights and ``quant_conv``, the EMA weights and
    (with ``scalars``) its 0-dim counters and ``scale_factor``, the DDPM
    schedule buffers, and with a text tower its ``position_ids``.  A file
    the JAX loader reads too goes without the 0-dim tensors, which it
    cannot read (``test_zero_dim_tensors_load_where_the_jax_loader_refuses``)."""
    vae, g = config["vae"], torch.Generator().manual_seed(7)
    zc = vae["z_channels"] * (2 if vae.get("double_z") else 1)
    out = {"first_stage_model.encoder.conv_in.weight": torch.randn(vae["ch"], 3, 3, 3,
                                                                   generator=g),
           "first_stage_model.encoder.conv_in.bias": torch.zeros(vae["ch"]),
           "first_stage_model.encoder.conv_out.weight": torch.randn(
               zc, vae["ch"] * vae["ch_mult"][-1], 3, 3, generator=g),
           "model_ema.diffusion_modelout2weight": torch.zeros(3)}
    if scalars:
        out.update({"model_ema.decay": torch.tensor(0.9999),
                    "model_ema.num_updates": torch.tensor(0, dtype=torch.int32),
                    "scale_factor": torch.tensor(config["scale_factor"])})
    if config["first_stage"] == "kl":
        out["first_stage_model.quant_conv.weight"] = torch.randn(zc, zc, 1, 1, generator=g)
        out["first_stage_model.quant_conv.bias"] = torch.zeros(zc)
    alphas = torch.from_numpy(TL.linear_alphas_cumprod(config["linear_start"],
                                                       config["linear_end"], 1000)).float()
    for key in TL.CHECKPOINT_IGNORED_KEYS[1:-1]:  # the DDPM schedule buffers
        out[key] = alphas
    if text:
        out["cond_stage_model.transformer.text_model.embeddings.position_ids"] = \
            torch.arange(77)[None]
    return out


def write_ldm_checkpoint(path, ld, config, scalars: bool = True) -> None:
    """``ld`` in a reference checkpoint's layout (``v1-5-pruned-emaonly.ckpt``,
    the LDM zips' ``model.ckpt``): {'state_dict': ...} with the reference's
    names and the parts the port leaves out (``ldm_extras``)."""
    sd = TL.reference_state_dict(ld)
    sd.update(ldm_extras(config, text=ld.cond_stage_model is not None, scalars=scalars))
    torch.save({"state_dict": sd, "global_step": 470000}, path)


def _jax_ldm_trees(name, seed):
    """The JAX package's param trees of the tier (its U-Net's and decoder's
    init, the post-quant conv and a VQ codebook, as its
    ``build_latent_diffusion`` makes them), at unit scale."""
    cfg = JL.LDM_CONFIGS[name]
    unet, vae = cfg["unet"], {k: v for k, v in cfg["vae"].items() if k != "double_z"}
    res, zc, low = unet["image_size"], vae["z_channels"], vae["resolution"] // 2 ** (
        len(vae["ch_mult"]) - 1)
    ctx = (jnp.zeros((1, 77, unet["context_dim"])),) if unet.get("context_dim") else ()
    trees = dict(unet=_jax_init(JL.LDMUNet(**unet), jnp.zeros((1, res, res, unet["in_channels"])),
                                jnp.ones((1,)), *ctx),
                 decoder=_jax_init(JL.VAEDecoder(out_ch=3, **vae), jnp.zeros((1, low, low, zc))),
                 post_quant_conv={"kernel": np.zeros((1, 1, zc, zc), np.float32),
                                  "bias": np.zeros(zc, np.float32)})
    if cfg["first_stage"] == "vq":
        trees["codebook"] = np.zeros((cfg["n_embed"], zc), np.float32)
    return _rescaled(trees, seed)


def _port_from_jax(name, seed, text_seed=None):
    ld = TL.build_latent_diffusion(name, device="cpu")
    load_ldm_jax_params(ld, _jax_ldm_trees(name, seed))
    if text_seed is not None:
        ld.cond_stage_model = factory.init_params(TTX.FrozenCLIPEmbedder(device="cpu"))
        _redraw_unit_scale(ld.cond_stage_model, text_seed)
    return ld


def test_ldm_d_from_a_checkpoint_matches_jax(tmp_path, monkeypatch):
    """The LSUN LDM: the legacy attention's Conv1d weights [O, I, 1] load
    into the port's 1x1 convs; the VQ codebook from
    ``quantize.embedding.weight``."""
    monkeypatch.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", LDM_TINY)
    monkeypatch.setitem(JL.LDM_CONFIGS, "lsun_bedroom_ldm", LDM_TINY)
    src = _port_from_jax("lsun_bedroom_ldm", seed=2)
    path = tmp_path / "model.ckpt"
    write_ldm_checkpoint(path, src, LDM_TINY, scalars=False)
    assert TI.load_torch_file(str(path))["state_dict"][
        "model.diffusion_model.middle_block.1.qkv.weight"].dim() == 3
    pre_t, source = factory.create_model("lsun_bedroom_ldm", str(path), device="cpu")
    assert source == "ldm" and pre_t.latent_diffusion.cond_stage_model is None
    for k, v in src.state_dict().items():
        assert torch.equal(pre_t.latent_diffusion.state_dict()[k], v), k
    pre_j, _ = JF.build_ldm_model("lsun_bedroom_ldm", str(path))
    s = np.array([0.5, 14.0], np.float32)
    x = np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32) * s[:, None, None, None]
    want = jax.jit(JP.bind(pre_j).fn)(jnp.asarray(x), jnp.asarray(s))
    got = bind(pre_t)(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    _close(got, want, what="D")
    z = np.random.RandomState(4).randn(2, 8, 8, 3).astype(np.float32)
    _close(pre_t.latent_diffusion.decode_in_chunks(z),
           pre_j.latent_diffusion.decode_first_stage(jnp.asarray(z)), what="VQ decode")


def test_sd_d_from_a_checkpoint_matches_jax(tmp_path, monkeypatch):
    """Stable Diffusion with its text tower: each side encodes the prompts
    with the tower it loaded, then D under guidance 7.5."""
    patch_tiny_sd(monkeypatch, SD_TINY, tmp_path)
    src = _port_from_jax("ms_coco", seed=5, text_seed=6)
    path = tmp_path / "v1-5-pruned-emaonly.ckpt"
    write_ldm_checkpoint(path, src, SD_TINY, scalars=False)
    pre_t, source = factory.create_model("ms_coco", str(path), guidance_rate=GUIDANCE,
                                         device="cpu")
    ld_t = pre_t.latent_diffusion
    assert source == "sd" and isinstance(ld_t.cond_stage_model, TTX.FrozenCLIPEmbedder)
    assert not any(p.requires_grad for p in ld_t.cond_stage_model.parameters())
    for k, v in src.state_dict().items():
        assert torch.equal(ld_t.state_dict()[k], v), k
    pre_j, _ = JF.build_ldm_model("ms_coco", str(path), guidance_rate=GUIDANCE)
    ld_j = pre_j.latent_diffusion
    prompts = ["a photo of the cat", "low café", ""]  # the last: the unconditional context
    ctx_t = ld_t.get_learned_conditioning(prompts)
    ctx_j = np.asarray(ld_j.get_learned_conditioning(prompts))
    assert ctx_t.shape == (3, 77, 16)
    _close(ctx_t.numpy(), ctx_j, what="contexts")
    s = np.array([0.5, 14.0], np.float32)
    x = np.random.RandomState(7).randn(2, 8, 8, 4).astype(np.float32) * s[:, None, None, None]

    def both_d(x, s, c, u):  # conditional, then guided at 7.5
        return (JP.bind(pre_j, condition=c).fn(x, s),
                JP.bind(pre_j, condition=c, unconditional_condition=u).fn(x, s))

    want = jax.jit(both_d)(jnp.asarray(x), jnp.asarray(s), jnp.asarray(ctx_j[:2]),
                           jnp.asarray(ctx_j[2:]))
    # guidance 7.5 scales the two passes' rounding by up to 8: the guided D
    # keeps tests/test_torch_sd.py's bound for it
    for want_d, uc, rel in zip(want, (None, ctx_t[2:]), (1e-5, 2e-5)):
        got = bind(pre_t, condition=ctx_t[:2], unconditional_condition=uc)(
            torch.from_numpy(x), torch.from_numpy(s)).numpy()
        _close(got, want_d, rel=rel, what=f"D, unconditional context {uc is not None}")
        assert np.abs(got - x).max() > 0.1


def test_ldm_checkpoint_keys_are_strict(tmp_path, monkeypatch):
    """A key the stack has no place for, or a module key the file lacks,
    raises and names it."""
    monkeypatch.setitem(TL.LDM_CONFIGS, "lsun_bedroom_ldm", LDM_TINY)
    ld = TL.build_latent_diffusion("lsun_bedroom_ldm", device="cpu")
    sd = dict(TL.reference_state_dict(ld), **ldm_extras(LDM_TINY, text=False))
    TL.load_ldm_checkpoint(TL.build_latent_diffusion("lsun_bedroom_ldm", device="cpu"), sd)
    for stray in ("first_stage_model.loss.logvar", "cond_stage_model.transformer.token_emb"):
        with pytest.raises(KeyError, match=stray):
            TL.build_latent_diffusion("lsun_bedroom_ldm", state_dict=dict(sd, **{
                stray: torch.zeros(1)}), device="cpu")
    key = "model.diffusion_model.out.2.weight"
    with pytest.raises(KeyError, match=r"unet\.out\.2\.weight"):
        TL.build_latent_diffusion("lsun_bedroom_ldm", device="cpu",
                                  state_dict={k: v for k, v in sd.items() if k != key})


def test_full_width_cifar10_and_sd_checkpoint_keys_all_load():
    """No forward, the meta device.  CIFAR-10: the JAX init's params under
    the reference's names, plus the resample filters and ``map_augment`` a
    real ``.pkl`` holds.  SD v1.5: the U-Net and KL decoder under the
    reference's names, transformers' torch CLIPTextModel keys under
    ``cond_stage_model.transformer``, and the parts the port leaves out."""
    transformers = pytest.importorskip("transformers")
    shapes = jax.eval_shape(JEDMPrecond(**JF.EDM_ARCHS["cifar10"][0],
                                        model_kwargs=JF.EDM_ARCHS["cifar10"][1]).init,
                            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)))
    names = params_from_jax(jax.tree.map(lambda s: np.zeros((1,) * len(s.shape), np.float32),
                                         shapes["params"]))
    module = factory.build_edm_model("cifar10", device="meta")
    own = module.state_dict()
    ckpt = {k: torch.empty(own[k].shape, device="meta") for k in names}
    extra = sorted(k for k in own if k.endswith("resample_filter") or "map_augment" in k)
    assert extra and set(names) | set(extra) == set(own)
    ckpt.update({k: torch.empty(own[k].shape, device="meta") for k in extra})
    factory.load_edm_checkpoint(module, ckpt)

    cfg = TL.LDM_CONFIGS["ms_coco"]
    vae = {k: v for k, v in cfg["vae"].items() if k != "double_z"}
    ld = TL.LatentDiffusion(
        TL.LDMUNet(device="meta", **cfg["unet"]),
        TL.AutoencoderKL(TL.VAEDecoder(out_ch=3, device="meta", **vae), cfg["embed_dim"],
                         vae["z_channels"], device="meta"),
        TL.linear_alphas_cumprod(0.00085, 0.0120), cond_stage_model=TTX.FrozenCLIPEmbedder(
            device="meta"))
    sd = {k: v for k, v in TL.reference_state_dict(ld).items()
          if not k.startswith("cond_stage_model.")}
    with torch.device("meta"):
        clip = transformers.CLIPTextModel(transformers.CLIPTextConfig(**TTX._CLIP_TEXT_CONFIG))
    sd.update({f"cond_stage_model.transformer.{k}": v for k, v in clip.state_dict().items()})
    sd.update({k: v.to("meta") for k, v in ldm_extras(cfg, text=True).items()})
    loaded = TL.build_latent_diffusion("ms_coco", state_dict=sd, device="meta")
    assert isinstance(loaded.cond_stage_model, TTX.FrozenCLIPEmbedder)
    left = sorted(k for k in sd if TL.checkpoint_ignores(k))
    assert left == sorted(ldm_extras(cfg, text=True))
