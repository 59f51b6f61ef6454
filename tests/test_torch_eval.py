"""The port's evaluation path against the JAX package's, on the CPU: the FID
Inception-V3 detector (each BasicConv2d kind, each of InceptionA-E, both
resizes up and down, the whole net through both preprocessing paths), its
importers (torchvision names, the order / shape automap, the NVIDIA-style
pickle), FID's moments and distance, PRDC, the image dataset reader, and the
``fid`` / ``prdc`` CLIs' flags and refusals.

The detector's weights are drawn once in numpy in the JAX param tree's
layout (``jax.eval_shape`` of its init, so no Flax init runs): He-scaled
convs and BN statistics of order one, carried to the port by
``models/convert.py::inception_state_dict_from_jax``.  Tolerances: the
blocks and the whole net 1e-4 * max|JAX out| (both sides sum in f32 in other
orders); the resizes 1e-5 * max|x| with the weight matrices bit-equal to
JAX's; the FID moments 1e-6 relative.
"""

import json
import os
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
import torch.nn as nn
from jax._src.image import scale as jax_scale

from diff_sampler_tpu.cli import fid as JCF
from diff_sampler_tpu.cli import prdc as JCP
from diff_sampler_tpu.eval import dataset as JD
from diff_sampler_tpu.eval import fid as JF
from diff_sampler_tpu.eval import inception as JI
from diff_sampler_tpu.eval import prdc as JP
from diff_sampler_tpu.utils.checkpoint import save_params as jax_save_params
from diff_sampler_tpu_torch.cli import fid as TCF
from diff_sampler_tpu_torch.cli import prdc as TCP
from diff_sampler_tpu_torch.eval import dataset as TD
from diff_sampler_tpu_torch.eval import fid as TF
from diff_sampler_tpu_torch.eval import inception as TI
from diff_sampler_tpu_torch.eval import prdc as TP
from diff_sampler_tpu_torch.models.convert import inception_state_dict_from_jax

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(tree, rng):
    """Numpy leaves for a tree of shapes: He-scaled conv kernels (HWIO), BN
    scale and var in [0.5, 1.5], bias and mean ~ 0.1 N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(v.shape[:3]))
            out[k] = (rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        elif k in ("bn_scale", "bn_var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def params():
    shapes = jax.eval_shape(JI.InceptionV3FID().init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3), jnp.uint8))["params"]
    return _fill(shapes, np.random.RandomState(0))


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max abs err {err:.3g} > {tol} * {scale:.3g}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("kind", ["1x1", "3x3_s2", "1x7", "7x1"])
def test_basic_conv2d_matches_jax(kind):
    """Each conv kind of BasicConv2d (conv, inference BN with eps 1e-3, ReLU)
    at a 17x17 input."""
    kernel, stride, padding = {"1x1": ((1, 1), 1, 0), "3x3_s2": ((3, 3), 2, 0),
                               "1x7": ((1, 7), 1, (0, 3)), "7x1": ((7, 1), 1, (3, 0))}[kind]
    rng = np.random.RandomState(1)
    x = rng.randn(2, 17, 17, 24).astype(np.float32)
    jblk = JI.BasicConv2d(40, kernel, stride=stride, padding=padding)
    p = _fill(jax.eval_shape(jblk.init, jax.random.key(0), x)["params"], rng)
    want = jblk.apply({"params": p}, jnp.asarray(x))
    tblk = TI.BasicConv2d(24, 40, kernel, stride=stride, padding=padding)
    tblk.load_state_dict(inception_state_dict_from_jax(p))
    _close(_nhwc(tblk(_nchw(x))), want, what=kind)


BLOCKS = {  # name: (JAX block, port block, the full net's params of it, input H, C)
    "A": (lambda: JI.InceptionA(32), lambda: TI.InceptionA(192, 32), "Mixed_5b", 17, 192),
    "B": (lambda: JI.InceptionB(), lambda: TI.InceptionB(288), "Mixed_6a", 17, 288),
    "C": (lambda: JI.InceptionC(128), lambda: TI.InceptionC(768, 128), "Mixed_6b", 17, 768),
    "D": (lambda: JI.InceptionD(), lambda: TI.InceptionD(768), "Mixed_7a", 17, 768),
    "E_avg": (lambda: JI.InceptionE("avg"), lambda: TI.InceptionE(1280, "avg"), "Mixed_7b",
              8, 1280),
    "E_max": (lambda: JI.InceptionE("max"), lambda: TI.InceptionE(2048, "max"), "Mixed_7c",
              8, 2048),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_inception_block_matches_jax(params, name):
    """InceptionA-E (both pool modes of E) at full width with the full
    net's weights, at 17x17 (A-D) or 8x8 (E), inputs ReLU-like (>= 0)."""
    jmk, tmk, key, h, c = BLOCKS[name]
    x = np.abs(np.random.RandomState(2).randn(1, h, h, c)).astype(np.float32)
    want = jmk().apply({"params": params[key]}, jnp.asarray(x))
    blk = tmk()
    blk.load_state_dict(inception_state_dict_from_jax(params[key]))
    _close(_nhwc(blk(_nchw(x))), want, what=name)


@pytest.mark.parametrize("size_in", [32, 512])
def test_resizes_match_jax_up_and_down(size_in):
    """The default resize is jax.image.resize's bilinear: at 32 -> 299 plain
    half-pixel bilinear, at 512 -> 299 the antialiasing triangle filter
    (F.interpolate matches only the first); its weight matrices are bit-equal
    to JAX's, the resized images agree within 1e-5 * max|x|.  The TF1 resize
    agrees as closely."""
    n = 2 if size_in == 32 else 1
    x = (np.random.RandomState(3).rand(n, size_in, size_in, 3) * 255).astype(np.float32)
    want = jax_scale.compute_weight_mat(size_in, 299, 299 / size_in, 0.0,
                                        jax_scale._kernels[jax_scale.ResizeMethod.LINEAR], True)
    np.testing.assert_array_equal(TI._resize_weights(size_in, 299, "cpu").numpy(),
                                  np.asarray(want))
    _close(TI.resize_nhwc(torch.from_numpy(x), 299, 299),
           jax.image.resize(jnp.asarray(x), (n, 299, 299, 3), "bilinear"), tol=1e-5,
           what="default resize")
    _close(TI._tf1_resize_bilinear(torch.from_numpy(x), 299, 299),
           JI._tf1_resize_bilinear(jnp.asarray(x), 299, 299), tol=1e-5, what="TF1 resize")


@pytest.mark.parametrize("tf_preprocessing", [False, True], ids=["default", "tf"])
def test_whole_detector_matches_jax(params, tf_preprocessing):
    """InceptionV3FID at batch 2 from 32 px uint8 images: [2, 2048] features
    within 1e-4 * max|f| of the JAX module's (measured ~4e-7 relative)."""
    imgs = np.random.RandomState(4).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    jnet = JI.InceptionV3FID(tf_preprocessing=tf_preprocessing)
    want = jax.jit(lambda im: jnet.apply({"params": params}, im))(jnp.asarray(imgs))
    fn = TF.make_inception_feature_fn(inception_state_dict_from_jax(params), device="cpu",
                                      tf_preprocessing=tf_preprocessing)
    got = fn(imgs)
    assert got.dtype == torch.float32 and got.shape == (2, TI.FEATURE_DIM)
    _close(got, want, what="features")


def test_exact_f32_restores_the_callers_flags():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with TI.exact_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _torchvision_state_dict(params, rng):
    """The JAX tree in torchvision / pytorch-fid names, as such a file holds
    it: plus ``num_batches_tracked``, the 1008-way ``fc`` head and aux
    logits."""
    sd = {k: v.numpy() for k, v in inception_state_dict_from_jax(params).items()}
    for k in [k for k in sd if k.endswith(".bn.running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = np.array(0, np.int64)
    sd["fc.weight"] = rng.randn(1008, 2048).astype(np.float32)
    sd["fc.bias"] = rng.randn(1008).astype(np.float32)
    sd["AuxLogits.conv0.conv.weight"] = rng.randn(128, 768, 1, 1).astype(np.float32)
    return sd


def test_import_inception_state_dict_matches_jax(params):
    """A torchvision-named state_dict maps to the same weights on both
    sides; the head, the aux logits and the counters are dropped, and the
    result loads strictly into the port's module."""
    sd = _torchvision_state_dict(params, np.random.RandomState(5))
    got = TI.import_inception_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    want = inception_state_dict_from_jax(JI.import_inception_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("AuxLogits")}))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    TI.InceptionV3FID().load_state_dict(got)


def _graph_order_flat(params, rng, folded: bool):
    """The NVIDIA-style flat dict: TF-ish names, OIHW kernels in graph
    order, then the 1008-way logits head (its bias after the last conv).
    ``folded``: each unit a kernel and a beta only (BN folded in)."""
    flat = {}
    for i, path in enumerate(JI.CONV_UNITS_GRAPH_ORDER):
        node = params
        for p in path:
            node = node[p]
        base = f"layers.unit{i:03d}"
        flat[f"{base}.weight"] = node["conv"]["kernel"].transpose(3, 2, 0, 1)
        if folded:
            flat[f"{base}.beta"] = (0.01 * rng.randn(node["bn_bias"].shape[0])).astype(
                np.float32)
            continue
        flat[f"{base}.gamma"] = node["bn_scale"]
        flat[f"{base}.beta"] = node["bn_bias"]
        flat[f"{base}.running_mean"] = node["bn_mean"]
        flat[f"{base}.running_var"] = node["bn_var"]
    flat["output.weight"] = rng.randn(1008, 2048).astype(np.float32)
    flat["output.bias"] = rng.randn(1008).astype(np.float32)
    return flat


@pytest.mark.parametrize("folded", [False, True], ids=["bn", "folded_bn"])
def test_automap_matches_jax(params, folded):
    """The order / shape automap gives the JAX one's weights and report on
    the same tree: a full BN source maps back to the params exactly, a
    folded-BN source gets identity BN (var = 1 - eps), and the 1008-way head
    is left unused."""
    flat = _graph_order_flat(params, np.random.RandomState(6), folded)
    got, got_report = TI._automap_conv_bn({k: torch.from_numpy(v) for k, v in flat.items()})
    want, want_report = JI._automap_conv_bn(flat)
    assert got_report == want_report
    assert got_report["unused"] == ["output.weight", "output.bias"]
    want_sd = inception_state_dict_from_jax(want)
    assert got.keys() == want_sd.keys()
    for k in want_sd:
        assert torch.equal(got[k], want_sd[k]), k
    if not folded:
        for k, v in inception_state_dict_from_jax(params).items():
            assert torch.equal(got[k], v), k
    else:
        var = got["Mixed_7c.branch_pool.bn.running_var"]
        assert torch.equal(var, torch.full_like(var, 1.0 - 1e-3))


class _Unit(nn.Module):
    def __init__(self, w, **vectors):
        super().__init__()
        self.weight = nn.Parameter(torch.from_numpy(w))
        for name, v in vectors.items():
            self.register_buffer(name, torch.from_numpy(v))


def test_nvidia_pickle_imports_as_the_jax_package_does(tmp_path):
    """Plain pickles of module trees (the NVIDIA metric pickles' format):
    one in TF graph order (automap) and one in torchvision names; each loads
    through the port's own restricted loader to the weights the JAX
    package's importer gives.  Tiny widths: the importers read names and
    order, not the net's shapes."""
    rng = np.random.RandomState(7)
    units = nn.Sequential(*[
        _Unit(rng.randn(3, 2, 1, 1).astype(np.float32),
              **{n: rng.rand(3).astype(np.float32)
                 for n in ("gamma", "beta", "moving_mean", "moving_variance")})
        for _ in JI.CONV_UNITS_GRAPH_ORDER])
    units.add_module("output", nn.Linear(2, 1008))
    named = nn.Module()
    named.Mixed_5b = nn.Module()
    named.Mixed_5b.branch1x1 = nn.Module()
    named.Mixed_5b.branch1x1.conv = nn.Conv2d(2, 3, 1, bias=False)
    named.Mixed_5b.branch1x1.bn = nn.BatchNorm2d(3, eps=1e-3)
    named.Mixed_5b.branch1x1.bn.running_var.uniform_(0.5, 1.5)
    for kind, module in (("automap", units), ("names", named)):
        path = tmp_path / f"{kind}.pkl"
        with open(path, "wb") as f:
            pickle.dump(module, f)
        got, got_report = TI.import_nvidia_inception_pickle(str(path))
        want, want_report = JI.import_nvidia_inception_pickle(str(path))
        assert got_report["mode"] == want_report["mode"] == kind
        assert got_report["unused"] == want_report["unused"]
        want_sd = inception_state_dict_from_jax(want)
        assert got.keys() == want_sd.keys() and got
        for k in want_sd:
            assert torch.equal(got[k], want_sd[k]), k


def test_fid_moments_and_distance_match_jax():
    """FIDAccumulator over three batches and compute_fid against the JAX
    ones: mu and sigma within 1e-6 of their scale, the distance of the same
    stats equal, of each side's stats within 1e-6 relative."""
    rng = np.random.RandomState(8)
    feats = [(rng.randn(50, 64) + 0.3).astype(np.float32) for _ in range(3)]
    ref = [(rng.randn(70, 64) * 1.2).astype(np.float32)]
    stats = {}
    for side, acc_t in (("port", lambda: TF.FIDAccumulator(64, device="cpu")),
                        ("jax", lambda: JF.FIDAccumulator(64))):
        for name, batches in (("x", feats), ("ref", ref)):
            acc = acc_t()
            for f in batches:
                acc.update(torch.from_numpy(f) if side == "port" else f)
            stats[side, name] = acc.finalize()
    for name in ("x", "ref"):
        for got, want in zip(stats["port", name], stats["jax", name]):
            _close(got, want, tol=1e-6, what=f"{name} moments")
    args = (*stats["jax", "x"], *stats["jax", "ref"])
    assert TF.compute_fid(*args) == JF.compute_fid(*args)
    fid_port = TF.compute_fid(*stats["port", "x"], *stats["port", "ref"])
    assert fid_port == pytest.approx(JF.compute_fid(*args), rel=1e-6)
    assert TF.compute_fid(*stats["port", "x"], *stats["port", "x"]) == pytest.approx(0, abs=1e-6)


def test_stats_roundtrip_and_grayscale(tmp_path):
    """save / load of the .npz stats, and calculate_stats repeats a
    grayscale batch to RGB as the JAX one does."""
    rng = np.random.RandomState(9)
    imgs = [rng.randint(0, 256, (3, 4, 4, 1)).astype(np.uint8) for _ in range(2)]

    def flat(im):
        assert im.shape[-1] == 3
        return im.reshape(im.shape[0], -1).astype(np.float32)

    timings = {}
    got = TF.calculate_stats(flat, imgs, feature_dim=48, device="cpu", timings=timings)
    want = JF.calculate_stats(flat, imgs, feature_dim=48)
    for g, w in zip(got, want):
        _close(g, w, tol=1e-6)
    assert set(timings) == {"decode", "features"}
    TF.save_stats(str(tmp_path / "s.npz"), *got)
    for g, w in zip(JF.load_stats(str(tmp_path / "s.npz")), got):
        np.testing.assert_array_equal(g, w)


def test_prdc_matches_jax():
    """pairwise_distances in chunks smaller than the sets, and the four
    metrics and the realism score on the same features."""
    rng = np.random.RandomState(10)
    real = rng.randn(120, 32).astype(np.float32)
    fake = (rng.randn(90, 32) * 1.1 + 0.2).astype(np.float32)
    _close(TP.pairwise_distances(real, fake, chunk=50, device="cpu"),
           JP.pairwise_distances(real, fake, chunk=50), tol=1e-6, what="distances")
    got = TP.compute_prdc(real, fake, nearest_k=5, realism=True, device="cpu")
    want = JP.compute_prdc(real, fake, nearest_k=5, realism=True)
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == want[k], k
    _close(got["realism"], want["realism"], tol=1e-6, what="realism")


def test_prdc_distances_stay_exact_where_the_jax_formula_cancels():
    """Features whose spread (0.03) is small against their norm (~45), as a
    random detector gives on noise images: the port's centred distances
    agree with float64 within 1e-6 of max d, where the JAX package's f32
    formula misses by more than 1e-4 (a known fault of the reference)."""
    rng = np.random.RandomState(14)
    base = rng.rand(2048).astype(np.float32) * 1.7
    real = (base + 0.03 * rng.randn(300, 2048)).astype(np.float32)
    fake = (base + 0.03 * rng.randn(200, 2048)).astype(np.float32)
    r, f = real.astype(np.float64), fake.astype(np.float64)
    exact = np.sqrt(np.maximum((r * r).sum(1)[:, None] - 2 * r @ f.T + (f * f).sum(1), 0))
    _close(TP.pairwise_distances(real, fake, device="cpu"), exact, tol=1e-6, what="port")
    jax_err = np.abs(np.asarray(JP.pairwise_distances(real, fake)) - exact).max()
    assert jax_err > 1e-4 * exact.max()


def _image_tree(root, n=7, res=8, labels=True, seed=11):
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        name = f"{'sub/' if i % 2 else ''}img{i:03d}.png"
        PIL.Image.fromarray(rng.randint(0, 256, (res, res, 3)).astype(np.uint8)).save(
            os.path.join(root, name))
        names.append(name)
    if labels:
        with open(os.path.join(root, "dataset.json"), "w") as f:
            json.dump({"labels": [[nm, i % 3] for i, nm in enumerate(names)]}, f)


@pytest.mark.parametrize("kind", ["dir", "zip"])
def test_image_folder_dataset_matches_jax(tmp_path, kind):
    """Directory tree and zip: the sorted order, one-hot labels, the
    max_size subset by seed, xflip, the LANCZOS resolution and the sharded
    batches give the JAX reader's arrays."""
    root = str(tmp_path / "imgs")
    _image_tree(root)
    path = root
    if kind == "zip":
        path = str(tmp_path / "imgs.zip")
        with zipfile.ZipFile(path, "w") as zf:
            for dirpath, _, files in os.walk(root):
                for f in files:
                    full = os.path.join(dirpath, f)
                    zf.write(full, os.path.relpath(full, root))
    for kw in (dict(use_labels=True), dict(max_size=4, xflip=True, random_seed=3),
               dict(resolution=5, use_labels=True)):
        got, want = TD.ImageFolderDataset(path, **kw), JD.ImageFolderDataset(path, **kw)
        assert len(got) == len(want) and got.label_dim == want.label_dim
        for i in range(len(want)):
            for g, w in zip(got[i], want[i]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        for shard in range(2):
            pairs = zip(got.batches(3, shard_index=shard, num_shards=2),
                        want.batches(3, shard_index=shard, num_shards=2), strict=True)
            for (gi, gl), (wi, wl) in pairs:
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gl, wl)


def _options(command):
    """Every option string of a click command."""
    return {o for p in command.params for o in (*p.opts, *p.secondary_opts)}


def _argparse_options(parser, command):
    sub = next(a for a in parser._actions if a.dest == "command").choices[command]
    return {o for a in sub._actions for o in a.option_strings} - {"-h", "--help"}


@pytest.mark.parametrize("cli,command", [("fid", "calc"), ("fid", "ref"), ("prdc", "calc")])
def test_cli_flags_match_jax(cli, command):
    """The port's flags are the JAX CLI's, subcommand by subcommand, with
    the same defaults where a flag is optional."""
    jax_main, port = {"fid": (JCF.main, TCF), "prdc": (JCP.main, TCP)}[cli]
    jcmd = jax_main.commands[command]
    assert _argparse_options(port._parser(), command) == _options(jcmd)
    sub = next(a for a in port._parser()._actions if a.dest == "command").choices[command]
    defaults = {a.dest: a.default for a in sub._actions if a.option_strings}
    for p in jcmd.params:
        if not p.required:
            assert defaults[p.name] == p.default, p.name


def test_cli_refuses_a_random_detector_without_smoke(tmp_path):
    """No --inception and no --smoke: both CLIs refuse before any feature
    is computed; fid calc refuses a count other than 10k / 30k / 50k."""
    root = str(tmp_path / "imgs")
    _image_tree(root, n=4, labels=False)
    np.savez(tmp_path / "ref.npz", mu=np.zeros(2048), sigma=np.eye(2048))
    runs = [(TCF, ["ref", f"--data={root}", f"--dest={tmp_path / 'x.npz'}"], "no --inception"),
            (TCF, ["calc", f"--images={root}", f"--ref={tmp_path / 'ref.npz'}",
                   "--no-strict-count"], "no --inception"),
            (TCP, ["calc", f"--images={root}", f"--images_ref={root}", "--num=4"],
             "no --inception"),
            (TCF, ["calc", f"--images={root}", f"--ref={tmp_path / 'ref.npz'}", "--smoke"],
             "expected 10k/30k/50k")]
    for cli, argv, msg in runs:
        with pytest.raises(SystemExit, match=msg):
            cli.main(argv, device="cpu")
    assert not (tmp_path / "x.npz").exists()


def test_fid_ref_from_each_detector_source(tmp_path, params):
    """``fid ref`` with --inception as the JAX package's imported-params
    .npz (its own save_params) and as a torch state_dict in torchvision
    names gives the stats of the library path, bit for bit; the .npz the CLI
    writes loads in the JAX package."""
    root = str(tmp_path / "imgs")
    _image_tree(root, n=3, res=16, labels=False)
    npz = str(tmp_path / "inception.npz")
    jax_save_params(npz, params)
    pth = str(tmp_path / "pt_inception.pth")
    torch.save({k: torch.from_numpy(v)
                for k, v in _torchvision_state_dict(params, np.random.RandomState(12)).items()},
               pth)
    fn = TF.make_inception_feature_fn(inception_state_dict_from_jax(params), device="cpu")
    ds = TD.ImageFolderDataset(root)
    want = TF.calculate_stats(fn, (im for im, _ in ds.batches(2)), device="cpu")
    for src in (npz, pth):
        dest = str(tmp_path / f"ref-{os.path.basename(src)}.npz")
        out = TCF.main(["ref", f"--data={root}", f"--dest={dest}", "--batch=2",
                        f"--inception={src}"], device="cpu")
        assert not out["is_random"]
        for g, w, f in zip((out["mu"], out["sigma"]), want, JF.load_stats(dest)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(f, w)


def test_prdc_cli_matches_the_jax_formulas(tmp_path, monkeypatch):
    """``prdc calc`` end to end with a stand-in detector (flattened
    pixels): the subset of --num images per set, the strict count and the
    JSON line equal the JAX package's compute_prdc on the same features."""
    gen, ref = str(tmp_path / "gen"), str(tmp_path / "ref")
    _image_tree(gen, n=9, labels=False)
    _image_tree(ref, n=9, labels=False, seed=13)

    def stand_in(images):
        return torch.from_numpy(images.reshape(images.shape[0], -1).astype(np.float32))

    monkeypatch.setattr(TCP, "_feature_fn", lambda *a, **k: (stand_in, True))
    out = TCP.main(["calc", f"--images={gen}", f"--images_ref={ref}", "--num=6",
                    "--nearest_k=2", "--seed=1", "--batch=4"], device="cpu")
    feats = {}
    for name, path in (("fake", gen), ("real", ref)):
        ds = JD.ImageFolderDataset(path, max_size=6, random_seed=1)
        feats[name] = np.concatenate([stand_in(im).numpy() for im, _ in ds.batches(4)])
        np.testing.assert_array_equal(out[name], feats[name])
    want = JP.compute_prdc(feats["real"], feats["fake"], nearest_k=2)
    for k, v in want.items():
        assert out[k] == v, k
    with pytest.raises(SystemExit, match="expected 10"):
        TCP.main(["calc", f"--images={gen}", f"--images_ref={ref}", "--num=10"],
                 device="cpu")
