"""The port's CLIP score (``eval/clip_score.py``, ``cli/clip_score.py``)
against the JAX package's, and the captions reader the sampling CLI shares
with it.

Tolerances: ``clip_preprocess`` within 1e-5 * max|x| of the JAX one in both
resize directions (32 -> 224, CIFAR-10's; 512 -> 224, SD's; a non-square
input), its bicubic weight matrices within 1e-6 of JAX's; the score and
the CLI's printed score within 1e-4 (a score is in [-100, 100]) on PNGs and
a captions CSV written by the test, through a tiny open_clip checkpoint
(``tests/test_torch_openclip.py::tiny_openclip_sd``) and a synthetic BPE
merges file; ``make_hf_clip_encoders`` within 1e-5 * max|embedding| of the
JAX package's Flax encoders on one tiny transformers ``CLIPModel`` saved by
the test (the JAX side loads it with ``from_pt=True``).
"""

import csv
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
from jax._src.image import scale as jax_scale

from diff_sampler_tpu.cli import clip_score as jcli
from diff_sampler_tpu.models import openclip as JO
from diff_sampler_tpu_torch.cli import clip_score as cli
from diff_sampler_tpu_torch.cli import sample as cli_sample
from diff_sampler_tpu_torch.eval import clip_score as TC
from diff_sampler_tpu_torch.eval import inception as TI
from diff_sampler_tpu_torch.models import openclip as TO
from diff_sampler_tpu_torch.utils.bpe import SimpleBPETokenizer
from test_torch_openclip import VISION_HEADS, tiny_openclip_sd
from test_torch_text import MERGES, _merges_file

# the module: the JAX package's ``eval`` exports a function of the same name
JC = importlib.import_module("diff_sampler_tpu.eval.clip_score")

VOCAB = 2 * 256 + len(MERGES) + 2  # the BPE's: bytes, bytes + "</w>", merges, SOT, EOT
CAPTIONS = ["a photo of a cat", "the low cat and the dog", "café über 東京",
            "a cat on the mat, then \"another\"", "lower, low", "hi"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("h,w,size", [(32, 32, 224), (512, 512, 224), (64, 48, 224),
                                      (40, 32, 24)],
                         ids=["up-32-224", "down-512-224", "up-nonsquare", "down-crop"])
def test_clip_preprocess_matches_jax(h, w, size):
    images = np.random.RandomState(h + w).randint(0, 256, (2, h, w, 3), np.uint8)
    _close(TC.clip_preprocess(images, size, device="cpu").numpy(),
           JC.clip_preprocess(images, size), 1e-5, "clip_preprocess")


@pytest.mark.parametrize("size_in,size_out", [(32, 224), (512, 224), (224, 224), (7, 3)])
def test_bicubic_weights_are_jax_keys_cubic(size_in, size_out):
    """The per-axis weights: Keys' cubic (a = -0.5) on half-pixel points,
    widened where the axis shrinks, renormalised over the in-range pixels.
    ``F.interpolate``'s bicubic (a = -0.75, clamped edges) is not this."""
    want = jax_scale.compute_weight_mat(size_in, size_out, size_out / size_in, 0.0,
                                        jax_scale._kernels[jax_scale.ResizeMethod.CUBIC], True)
    got = TI._resize_weights(size_in, size_out, "cpu", "bicubic").numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_clip_score_math_matches_jax():
    """Per-batch L2 normalisation, 100 * cosine, the mean over all pairs;
    identical embeddings score 100."""
    rng = np.random.RandomState(0)
    embeds = [(rng.randn(n, 20).astype(np.float32), rng.randn(n, 20).astype(np.float32))
              for n in (3, 2)]
    batches = [(img, ["p"] * len(img)) for img, _ in embeds]

    def text_fn():
        texts = iter([txt for _, txt in embeds])
        return lambda prompts: next(texts)

    ours = TC.clip_score(torch.from_numpy, text_fn(), batches)
    assert ours == pytest.approx(JC.clip_score(lambda x: x, text_fn(), batches), abs=1e-4)
    img = embeds[0][0]
    assert TC.clip_score(torch.from_numpy, lambda p: img, [(img, ["a"] * 3)]) == pytest.approx(
        100.0, abs=1e-4)


@pytest.fixture
def score_files(tmp_path, monkeypatch):
    """Six 32 px PNGs, a five-row captions CSV (quoted, non-ASCII), a tiny
    open_clip checkpoint whose text vocab is the BPE's, and the merges file
    on $CLIP_BPE_VOCAB."""
    monkeypatch.setitem(TO._VISION_HEAD_WIDTH, 48, 48 // VISION_HEADS)
    monkeypatch.setitem(JO._VISION_HEAD_WIDTH, 48, 48 // VISION_HEADS)
    monkeypatch.setenv("CLIP_BPE_VOCAB", _merges_file(tmp_path))
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(5)
    for i in range(6):
        PIL.Image.fromarray(rng.randint(0, 256, (32, 32, 3), np.uint8)).save(
            images / f"{i:06d}.png")
    captions = tmp_path / "captions.csv"
    with open(captions, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["id", "text"])
        for i, text in enumerate(CAPTIONS[:5]):
            writer.writerow([i, text])
    sd = tiny_openclip_sd(vocab_size=VOCAB)
    ckpt = tmp_path / "open_clip_pytorch_model.bin"
    torch.save(sd, ckpt)
    # the JAX loader refuses the 0-dim logit_scale (ROADMAP, reference fault 4)
    jax_ckpt = tmp_path / "without_logit_scale.bin"
    torch.save({k: v for k, v in sd.items() if k != "logit_scale"}, jax_ckpt)
    return str(images), str(captions), str(ckpt), str(jax_ckpt)


def test_cli_score_matches_jax_cli(score_files, capsys):
    """``--checkpoint`` at batch 2: 5 pairs (5 captions, 6 images), the
    captions through the BPE, the 32 px images resized to the tiny tower's
    24 px."""
    images, captions, ckpt, jax_ckpt = score_files
    args = [f"--images={images}", f"--captions={captions}", "--batch=2"]
    ours = cli.main([*args, f"--checkpoint={ckpt}", "--device=cpu"])
    out = capsys.readouterr().out
    assert "Scoring 5 image/caption pairs..." in out
    assert f"CLIP score: {ours:.4f}" in out
    with pytest.raises(ValueError, match="could not locate a state_dict"):
        JC.make_openclip_encoders(ckpt)
    jcli.main.main(args=[*args, f"--checkpoint={jax_ckpt}"], standalone_mode=False)
    want = float(re.search(r"CLIP score: (-?[\d.]+)", capsys.readouterr().out).group(1))
    assert ours == pytest.approx(want, abs=1e-4)
    # the library call on the same pairs, as the JAX package's
    image_fn, text_fn = TC.make_openclip_encoders(ckpt, device="cpu")
    j_image_fn, j_text_fn = JC.make_openclip_encoders(jax_ckpt)
    imgs = np.stack([np.asarray(PIL.Image.open(os.path.join(images, f"{i:06d}.png")))
                     for i in range(5)])
    lib = TC.clip_score(image_fn, text_fn, [(imgs[:3], CAPTIONS[:3]), (imgs[3:], CAPTIONS[3:5])])
    jlib = JC.clip_score(j_image_fn, j_text_fn, [(imgs[:3], CAPTIONS[:3]),
                                                 (imgs[3:], CAPTIONS[3:5])])
    assert lib == pytest.approx(jlib, abs=1e-4) and lib == pytest.approx(ours, abs=1e-4)
    _close(text_fn(CAPTIONS).numpy(), j_text_fn(CAPTIONS), 1e-5, "text embeddings")


def test_missing_vocab_raises_naming_the_places(score_files, tmp_path, monkeypatch):
    ckpt = score_files[2]
    monkeypatch.delenv("CLIP_BPE_VOCAB")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    image_fn, text_fn = TC.make_openclip_encoders(ckpt, device="cpu")
    assert image_fn(np.zeros((1, 24, 24, 3), np.uint8)).shape == (1, 20)
    assert text_fn(np.ones((1, 16), np.int64)).shape == (1, 20)  # ids need no vocab
    with pytest.raises(FileNotFoundError, match="bpe_simple_vocab_16e6") as err:
        text_fn(["a cat"])
    assert str(tmp_path / "home") in str(err.value)


def _save_hf_clip(path):
    """A tiny transformers CLIPModel (exact GELU) and a CLIPTokenizer over
    the test's BPE vocab, both saved with ``save_pretrained``."""
    import json

    from transformers import (CLIPConfig, CLIPModel, CLIPTextConfig, CLIPTokenizer,
                              CLIPVisionConfig)

    # transformers' fast tokenizer wants each merge's parts in the vocab: not ("s", "</w>")
    merges = [m for m in MERGES if m != ("s", "</w>")]
    bpe = SimpleBPETokenizer(merges)
    torch.manual_seed(0)
    cfg = CLIPConfig(
        text_config=CLIPTextConfig(vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   max_position_embeddings=16, hidden_act="gelu",
                                   bos_token_id=bpe.sot_id, eos_token_id=bpe.eot_id,
                                   pad_token_id=bpe.eot_id).to_dict(),
        vision_config=CLIPVisionConfig(hidden_size=48, intermediate_size=96,
                                       num_hidden_layers=2, num_attention_heads=4,
                                       image_size=24, patch_size=8,
                                       hidden_act="gelu").to_dict(),
        projection_dim=20)
    model = CLIPModel(cfg)
    with torch.no_grad():  # unit-scale weights: the default init's 0.02 hides the towers
        rng = np.random.RandomState(1)
        for p in (p for p in model.parameters() if p.dim()):  # not the 0-dim logit_scale
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) / fan_in ** 0.5)
    model.save_pretrained(path)
    vocab = path / "vocab.json"
    vocab.write_text(json.dumps(bpe.encoder), encoding="utf-8")
    merges_path = path / "merges.txt"
    merges_path.write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
                           encoding="utf-8")
    tok = CLIPTokenizer(str(vocab), str(merges_path), model_max_length=16)
    tok.save_pretrained(path)


def test_hf_encoders_match_jax_flax_ones(tmp_path):
    model_dir = tmp_path / "tiny_clip"
    model_dir.mkdir()
    _save_hf_clip(model_dir)
    image_fn, text_fn = TC.make_hf_clip_encoders(str(model_dir), device="cpu")
    j_image_fn, j_text_fn = JC.make_hf_clip_encoders(str(model_dir))
    images = np.random.RandomState(4).randint(0, 256, (3, 32, 32, 3), np.uint8)
    _close(image_fn(images).numpy(), j_image_fn(jnp.asarray(images)), 1e-5, "HF image tower")
    _close(text_fn(CAPTIONS[:4]).numpy(), j_text_fn(CAPTIONS[:4]), 1e-5, "HF text tower")


def test_hf_encoders_missing_model_raises_naming_it(tmp_path):
    empty = tmp_path / "no_model_here"
    empty.mkdir()
    with pytest.raises(RuntimeError, match="no_model_here.*not available locally"):
        TC.make_hf_clip_encoders(str(empty), device="cpu")


def _awkward_captions_csv(path):
    rows = [("0", "café über 東京, naïve — 😀"), ("1", 'a "quoted" cat,\r\non two lines'),
            ("2", "multi\nline\n caption"), ("3", "  spaced   out  "), ("4", "")]
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["id", "text"])
        writer.writerows(rows)
    return [text for _, text in rows]


def test_caption_reader_matches_the_jax_cli_reader(tmp_path, monkeypatch):
    """UTF-8 with ``newline=""``: non-ASCII and quoted multi-line captions
    (a ``\\r\\n`` inside a quoted field kept) read as the JAX CLI reads them,
    tokenised to the same ids; with no path, the zoo's ``prompts`` file in
    ./models.  The sampling CLI takes its captions from this reader."""
    path = tmp_path / "captions.csv"
    texts = _awkward_captions_csv(path)
    ours = cli.load_captions(str(path))
    assert ours == jcli.load_captions(str(path)) == texts
    tok = SimpleBPETokenizer(MERGES)
    np.testing.assert_array_equal(tok(ours), tok(jcli.load_captions(str(path))))
    assert cli_sample.load_captions is cli.load_captions
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="MS-COCO_val2014_30k_captions.csv"):
        cli.load_captions()
    (tmp_path / "models").mkdir()
    _awkward_captions_csv(tmp_path / "models" / "MS-COCO_val2014_30k_captions.csv")
    assert cli.load_captions() == texts
