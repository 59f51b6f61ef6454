"""The port's dataset tool and pure-Python LMDB reader against the JAX
package's: on each source kind (an image folder with labels, an image zip,
the CIFAR-10 python tarball, ``.npz`` in NHWC and NCHW, MNIST's gz pair, an
LSUN-style LMDB of branch, leaf and overflow pages) and each transform, both
tools write the same zip: the same members in the same order, byte for byte
(PNGs and ``dataset.json``).  The LMDB files are the ones
``tests/test_dataset_tool_formats.py`` writes against liblmdb's layout.
"""

import gzip
import io
import json
import os
import pickle
import tarfile
import zipfile

import numpy as np
import PIL.Image
import pytest
from click.testing import CliRunner

from diff_sampler_tpu.cli.dataset_tool import main as jax_tool
from diff_sampler_tpu.utils.lmdb_reader import LMDBReader as JaxLMDBReader
from diff_sampler_tpu_torch.cli import dataset_tool
from diff_sampler_tpu_torch.eval.dataset import ImageFolderDataset
from diff_sampler_tpu_torch.utils.lmdb_reader import LMDBReader
from test_dataset_tool_formats import (_branch_page, _leaf_page, _overflow_pages, _png_bytes,
                                       _write_lmdb)


def _folder(root, rng):
    os.makedirs(os.path.join(root, "b"))
    names = ["a0.png", "b/b1.png", "b/b2.jpg", "c3.bmp"]
    for i, name in enumerate(names):
        h, w = [(40, 56), (56, 40), (48, 48), (36, 64)][i]
        PIL.Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(root, name))
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"labels": [[n, i % 3] for i, n in enumerate(names)]}, f)
    return root


def _image_zip(path, rng):
    with zipfile.ZipFile(path, "w") as z:
        labels = []
        for i in range(3):
            z.writestr(f"d/img{i}.png", _png_bytes(rng.randint(0, 256, (12, 12, 3)).astype(
                np.uint8)))
            labels.append([f"d/img{i}.png", 2 - i])
        z.writestr("dataset.json", json.dumps({"labels": labels}))
    return path


def _cifar10(path, rng):
    with tarfile.open(path, "w:gz") as tar:
        for i in range(1, 6):
            blob = pickle.dumps({"data": rng.randint(0, 256, (2, 3072)).astype(np.uint8),
                                 "labels": [i % 10, (3 * i) % 10]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/data_batch_{i}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return path


def _npz(path, rng, nchw):
    images = rng.randint(0, 256, (3, 3, 10, 10) if nchw else (3, 10, 10, 3)).astype(np.uint8)
    np.savez(path, images, np.array([4, 0, 2]))
    return path


def _mnist(tmp, rng):
    images = rng.randint(0, 256, (3, 28, 28)).astype(np.uint8)
    img_gz = os.path.join(tmp, "train-images-idx3-ubyte.gz")
    with gzip.open(img_gz, "wb") as f:
        f.write(b"\x00" * 16 + images.tobytes())
    with gzip.open(os.path.join(tmp, "train-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(b"\x00" * 8 + np.array([7, 1, 7], np.uint8).tobytes())
    return img_gz


def _lmdb(path, rng):
    """Two leaves under a branch; one image a 3-page overflow run."""
    pngs = [_png_bytes(rng.randint(0, 256, (s, s, 3)).astype(np.uint8)) for s in (8, 64, 8)]
    leaf1 = _leaf_page(3, [(b"k0", pngs[0]), (b"k1", ("bigdata", 5, len(pngs[1])))])
    leaf2 = _leaf_page(4, [(b"k2", pngs[2])])
    ovf = _overflow_pages(5, pngs[1])
    pages = {2: _branch_page(2, [(b"", 3), (b"k2", 4)]), 3: leaf1, 4: leaf2, 5: ovf}
    _write_lmdb(path, pages, root=2, entries=3, depth=2)
    return path


SOURCES = {
    "folder": lambda tmp, rng: _folder(os.path.join(tmp, "src"), rng),
    "zip": lambda tmp, rng: _image_zip(os.path.join(tmp, "src.zip"), rng),
    "cifar10": lambda tmp, rng: _cifar10(os.path.join(tmp, "cifar-10-python.tar.gz"), rng),
    "npz_nhwc": lambda tmp, rng: _npz(os.path.join(tmp, "x.npz"), rng, nchw=False),
    "npz_nchw": lambda tmp, rng: _npz(os.path.join(tmp, "x.npz"), rng, nchw=True),
    "mnist": _mnist,
    "lmdb": lambda tmp, rng: _lmdb(os.path.join(tmp, "imgs_lmdb"), rng),
}

CASES = [(kind, []) for kind in sorted(SOURCES)] + [
    ("folder", ["--resolution=32", "--transform=center-crop"]),
    ("folder", ["--resolution=48x32", "--transform=center-crop-wide"]),
    ("folder", ["--resolution=24x20", "--max-images=3"]),
    ("cifar10", ["--max-images=7"]),
]


def _members(path):
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


@pytest.mark.parametrize("kind,flags", CASES, ids=[f"{k}{''.join(f)}" for k, f in CASES])
def test_dataset_tool_writes_the_jax_tools_zip(tmp_path, kind, flags):
    """Same members in the same order, byte for byte; the zip reads back
    through the port's ImageFolderDataset."""
    src = SOURCES[kind](str(tmp_path), np.random.RandomState(0))
    want, got = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    res = CliRunner().invoke(jax_tool, [f"--source={src}", f"--dest={want}", *flags])
    assert res.exit_code == 0, res.output
    count = dataset_tool.main([f"--source={src}", f"--dest={got}", *flags])
    members = _members(got)
    assert members == _members(want)
    assert count == len(ImageFolderDataset(got)) == sum(n.endswith(".png") for n, _ in members)


@pytest.mark.parametrize("source,flags,msg", [
    ("src", ["--transform=center-crop"], "requires --resolution"),
    ("data.csv", [], "unsupported source"),
])
def test_dataset_tool_refusals(tmp_path, source, flags, msg):
    """A transform without a resolution and an unknown source kind raise, as
    the JAX tool's ClickExceptions do, before anything is written."""
    os.makedirs(tmp_path / "src")
    with pytest.raises(SystemExit, match=msg):
        dataset_tool.main([f"--source={tmp_path / source}", f"--dest={tmp_path / 'out.zip'}",
                           *flags])
    assert not (tmp_path / "out.zip").exists()


def test_lmdb_reader_matches_jax(tmp_path):
    """The reader's entries, order and values on a branch / leaf / overflow
    database equal the JAX reader's."""
    path = _lmdb(str(tmp_path / "db_lmdb"), np.random.RandomState(1))
    with LMDBReader(path) as got, JaxLMDBReader(path) as want:
        assert len(got) == len(want) == 3
        assert list(got.items()) == list(want.items())


def test_dataset_tool_flags_match_jax():
    """The same flags as the JAX tool, with the same defaults."""
    actions = {o: a for a in dataset_tool._parser()._actions for o in a.option_strings}
    want = {o for p in jax_tool.params for o in (*p.opts, *p.secondary_opts)}
    assert set(actions) - {"-h", "--help"} == want
    for p in jax_tool.params:
        if not p.required:
            assert actions[p.opts[0]].default == p.default, p.name
    assert actions["--transform"].choices == list(jax_tool.params[-1].type.choices)
