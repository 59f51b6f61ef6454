"""Dataset -> zip converter (EDM-style) of the port, as
``diff_sampler_tpu/cli/dataset_tool.py`` (the reference's
`amed-solver-main/dataset_tool.py:31-440`), with the same flags and the same
output: folder / zip / CIFAR-10 python archive / MNIST idx-ubyte.gz / LSUN
LMDB / npz inputs -> a zip of PNGs with an optional dataset.json label
manifest, which eval.dataset.ImageFolderDataset and ``cli.fid ref`` read.

  python -m diff_sampler_tpu_torch.cli.dataset_tool \\
      --source=cifar-10-python.tar.gz --dest=datasets/cifar10.zip
  python -m diff_sampler_tpu_torch.cli.dataset_tool \\
      --source=train-images-idx3-ubyte.gz --dest=datasets/mnist.zip
  python -m diff_sampler_tpu_torch.cli.dataset_tool --source=bedroom_train_lmdb \\
      --dest=datasets/lsun_bedroom.zip --resolution=256

LMDB ingestion uses a pure-Python reader (utils/lmdb_reader.py) -- no lmdb
C binding needed (the reference requires `pip install lmdb cv2`,
dataset_tool.py:113-115).
"""

from __future__ import annotations

import gzip
import io
import json
import os
import tarfile
import zipfile

import argparse

import numpy as np


def _iter_folder(path):
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
    fnames = sorted(
        os.path.relpath(os.path.join(r, f), path)
        for r, _d, files in os.walk(path) for f in files
        if os.path.splitext(f)[1].lower() in exts)
    labels = None
    meta = os.path.join(path, "dataset.json")
    if os.path.isfile(meta):
        with open(meta) as f:
            labels = dict(json.load(f)["labels"])
    import PIL.Image

    for fname in fnames:
        with PIL.Image.open(os.path.join(path, fname)) as im:
            arr = np.array(im.convert("RGB"))
        yield arr, (labels.get(fname.replace("\\", "/")) if labels else None)


def _iter_cifar10(path):
    """CIFAR-10 python-version tar.gz (dataset_tool.py open_cifar10)."""
    import pickle

    with tarfile.open(path) as tar:
        for batch in [f"data_batch_{i}" for i in range(1, 6)]:
            member = next(m for m in tar.getmembers() if m.name.endswith(batch))
            with tar.extractfile(member) as f:
                data = pickle.load(f, encoding="latin1")
            images = data["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            for img, label in zip(images, data["labels"]):
                yield img, int(label)


def _iter_npz(path):
    with np.load(path) as f:
        images = f[f.files[0]]
        labels = f[f.files[1]] if len(f.files) > 1 else [None] * len(images)
    if images.ndim == 4 and images.shape[1] in (1, 3):  # NCHW -> NHWC
        images = images.transpose(0, 2, 3, 1)
    for img, label in zip(images, labels):
        yield img, (int(label) if label is not None else None)


def _iter_mnist(images_gz):
    """MNIST idx-ubyte.gz pair, zero-padded 28->32
    (dataset_tool.py open_mnist :173-199)."""
    labels_gz = images_gz.replace("-images-idx3-ubyte.gz",
                                  "-labels-idx1-ubyte.gz")
    if labels_gz == images_gz:
        raise SystemExit("dataset_tool: MNIST source must be the *-images-idx3-ubyte.gz file")
    with gzip.open(images_gz, "rb") as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16)
    with gzip.open(labels_gz, "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    images = images.reshape(-1, 28, 28)
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)], "constant")
    assert len(images) == len(labels)
    for img, label in zip(images, labels):
        yield img, int(label)


def _iter_lmdb(path):
    """LSUN-style LMDB of encoded image blobs (dataset_tool.py open_lmdb
    :113-139); decodes with PIL (the reference's cv2-failure fallback)."""
    import PIL.Image

    from ..utils.lmdb_reader import LMDBReader

    with LMDBReader(path) as db:
        for _key, value in db.items():
            try:
                img = np.array(PIL.Image.open(io.BytesIO(value)).convert("RGB"))
            except Exception as e:  # mirror the reference's skip-and-print
                print(e)
                continue
            yield img, None


def _iter_zip(path):
    """Existing image zip (dataset_tool.py open_image_zip :88-109)."""
    import PIL.Image

    with zipfile.ZipFile(path) as z:
        names = [n for n in sorted(z.namelist())
                 if os.path.splitext(n)[1].lower() in
                 {".png", ".jpg", ".jpeg", ".bmp", ".webp"}]
        labels = {}
        if "dataset.json" in z.namelist():
            with z.open("dataset.json") as f:
                data = json.load(f).get("labels")
                if data:
                    labels = {x[0]: x[1] for x in data}
        for n in names:
            with z.open(n) as f:
                img = np.array(PIL.Image.open(f).convert("RGB"))
            yield img, labels.get(n)


def _make_transform(transform, res):
    """Crop/resize modes (dataset_tool.py make_transform :203-253).  Returns
    `img -> img | None`; None means "skip this image" (center-crop-wide on
    too-small inputs)."""
    import PIL.Image

    w, h = res if res is not None else (None, None)

    def to_rgb(a):
        return a[:, :, None].repeat(3, axis=2) if a.ndim == 2 else a

    def resize(a, ww, hh):
        return np.array(PIL.Image.fromarray(a).resize(
            (ww, hh), PIL.Image.Resampling.LANCZOS))

    def scale(a):
        if w is None or (a.shape[1] == w and a.shape[0] == h):
            return a
        return resize(a, w, h)

    def center_crop(a):
        crop = min(a.shape[:2])
        y0, x0 = (a.shape[0] - crop) // 2, (a.shape[1] - crop) // 2
        return resize(to_rgb(a[y0:y0 + crop, x0:x0 + crop]), w, h)

    def center_crop_wide(a):
        band = int(np.round(w * a.shape[0] / a.shape[1]))
        if a.shape[1] < w or band < h:
            return None  # too small: the reference skips it
        y0 = (a.shape[0] - band) // 2
        a = resize(to_rgb(a[y0:y0 + band]), w, h)
        canvas = np.zeros((w, w, 3), np.uint8)
        canvas[(w - h) // 2:(w + h) // 2] = a
        return canvas

    if transform is None:
        return scale
    if res is None:
        raise SystemExit(f"dataset_tool: --transform={transform} requires --resolution=WxH")
    return {"center-crop": center_crop,
            "center-crop-wide": center_crop_wide}[transform]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.dataset_tool",
                                description="Dataset -> zip of PNGs (+ dataset.json).")
    p.add_argument("--source", required=True,
                   help="folder | .zip | cifar-10-python.tar.gz | *-images-idx3-ubyte.gz "
                        "(MNIST) | *_lmdb dir (LSUN) | .npz")
    p.add_argument("--dest", required=True, help="output .zip")
    p.add_argument("--resolution", default=None, help="output size: 256 or WxH e.g. 512x384")
    p.add_argument("--max-images", dest="max_images", type=int, default=None)
    p.add_argument("--transform", choices=["center-crop", "center-crop-wide"], default=None,
                   help="input crop/resize mode")
    return p


def main(argv=None) -> int:
    """Runs the CLI; returns the number of images written."""
    args = _parser().parse_args(argv)
    source, dest, resolution = args.source, args.dest, args.resolution
    max_images, transform = args.max_images, args.transform
    import PIL.Image

    if os.path.isdir(source):
        # LSUN convention: directory names end in _lmdb (dataset_tool.py:260)
        if (source.rstrip("/").endswith("_lmdb")
                or os.path.isfile(os.path.join(source, "data.mdb"))):
            it = _iter_lmdb(source)
        else:
            it = _iter_folder(source)
    elif source.endswith("-images-idx3-ubyte.gz"):
        it = _iter_mnist(source)
    elif source.endswith((".tar.gz", ".tgz")):
        it = _iter_cifar10(source)
    elif source.endswith(".npz"):
        it = _iter_npz(source)
    elif source.endswith(".zip"):
        it = _iter_zip(source)
    else:
        raise SystemExit(f"dataset_tool: unsupported source: {source}")

    if resolution is not None:
        parts = resolution.lower().split("x")
        res = ((int(parts[0]), int(parts[1])) if len(parts) == 2
               else (int(parts[0]), int(parts[0])))
    else:
        res = None
    tfm = _make_transform(transform, res)

    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    labels = []
    with zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED) as zf:
        count = 0
        for img, label in it:
            if max_images is not None and count >= max_images:
                break
            img = tfm(img)
            if img is None:
                continue
            fname = f"{count // 1000:05d}/img{count:08d}.png"
            buf = io.BytesIO()
            PIL.Image.fromarray(img).save(buf, format="png", compress_level=0,
                                          optimize=False)
            zf.writestr(fname, buf.getvalue())
            if label is not None:
                labels.append([fname, label])
            count += 1
        if labels:
            zf.writestr("dataset.json", json.dumps({"labels": labels}))
    print(f"Wrote {count} images to {dest}" + (" (with labels)" if labels else ""))
    return count


if __name__ == "__main__":
    main()
