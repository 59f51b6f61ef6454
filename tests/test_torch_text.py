"""The port's text path against the JAX package's: the CLIP BPE tokenizer
(``utils/bpe.py``), the CLIP text tower, ``FrozenCLIPEmbedder`` and the LDM
BERT tower (``models/text.py``).

Tokenizers: a synthetic merges file written by the test (as
tests/test_bpe.py writes them); ids bit-equal.  Towers: tiny configs (the
JAX module's ``_CLIP_TEXT_CONFIG`` monkeypatched, never edited), every
weight redrawn at unit scale in the port and converted for the JAX side
(transformers' own torch -> Flax converter for CLIP, the JAX package's
``bert_params_from_state_dict`` for BERT); f32 on the CPU, outputs within
1e-5 * max|out|.  One full-width check: the port's CLIP state_dict names
and shapes are transformers' torch ``CLIPTextModel``'s.
"""

import gzip
import math
import types

import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import text as JT
from diff_sampler_tpu.utils import bpe as JB
from diff_sampler_tpu_torch.models import factory
from diff_sampler_tpu_torch.models import text as TT
from diff_sampler_tpu_torch.utils import bpe as TB

# a synthetic merge table: multi-level merges ("lo" + "w</w>" on "l" + "o"),
# rank conflicts, and merges of the remapped non-ASCII bytes ("Ã" "©" is
# the byte pair of "é")
MERGES = [("l", "o"), ("lo", "w</w>"), ("e", "r</w>"), ("h", "i</w>"), ("lo", "w"),
          ("low", "er</w>"), ("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>"),
          ("a", "n"), ("an", "d</w>"), ("o", "n</w>"), ("Ã", "©"), ("c", "af"), ("a", "f"),
          ("s", "</w>"), ("p", "h"), ("ph", "o"), ("pho", "t"), ("o", "f</w>")]
PROMPTS = [
    "lower low cat",
    "Hi, LOW!  cats & dogs; it's low-er. the cat and the dog",
    "a photo of a cat 123 on the mat",
    "café über low — naïve 東京 😀",
    "  leading &amp; trailing   spaces  ",
    "",
    " ".join(["the cat"] * 60),  # truncated to 77 ids, EOT last
]
TINY_CLIP = dict(vocab_size=600, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=77)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merges_file(tmp_path, gz: bool = False) -> str:
    lines = [f"{a} {b}" for a, b in MERGES]
    if gz:  # open_clip's artifact: a banner line, then the merges
        path = tmp_path / "bpe_simple_vocab_16e6.txt.gz"
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write("bpe version banner\n" + "\n".join(lines) + "\n")
    else:
        path = tmp_path / "merges.txt"
        path.write_text("#version: 0.2\n" + "\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _redraw_unit_scale(module, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 1
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                    / math.sqrt(fan_in))


@pytest.mark.parametrize("gz", [False, True], ids=["merges.txt", "gz"])
@pytest.mark.parametrize("pad", ["zero", "eot"])
def test_bpe_ids_are_bit_equal_to_jax(tmp_path, gz, pad):
    """Unicode, HTML entities, whitespace, the empty prompt, truncation at 77
    with EOT last, and both paddings."""
    path = _merges_file(tmp_path, gz)
    mine, ref = TB.SimpleBPETokenizer.from_file(path), JB.SimpleBPETokenizer.from_file(path)
    if pad == "eot":
        mine.pad_id, ref.pad_id = mine.eot_id, ref.eot_id
    got, want = mine(PROMPTS), ref(PROMPTS)
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == mine.eot_id and (got[-1, :-1] != mine.eot_id).all()  # truncated
    assert [mine.encode(p) for p in PROMPTS] == [ref.encode(p) for p in PROMPTS]
    assert mine.encoder == ref.encoder and TB.bytes_to_unicode() == JB.bytes_to_unicode()
    assert [mine.decode(mine.encode(p)) for p in PROMPTS[:4]] == \
        [ref.decode(ref.encode(p)) for p in PROMPTS[:4]]


def test_vocab_search_and_its_error(tmp_path, monkeypatch):
    """$CLIP_BPE_VOCAB first, the same candidate list as the JAX package's;
    with no file anywhere the tokenizer raises and names every place."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("CLIP_BPE_VOCAB", raising=False)
    assert TB.find_vocab_file() is None and JB.find_vocab_file() is None
    with pytest.raises(FileNotFoundError) as err:
        TB.SimpleBPETokenizer.from_default_paths()
    for place in TB.vocab_candidates():
        assert place in str(err.value)
    with pytest.raises(FileNotFoundError, match="bpe_simple_vocab_16e6"):
        TT.FrozenCLIPEmbedder(device="meta")(["a cat"])
    path = _merges_file(tmp_path)
    monkeypatch.setenv("CLIP_BPE_VOCAB", path)
    assert TB.find_vocab_file() == JB.find_vocab_file() == path
    assert TB.vocab_candidates()[0] == path


def _tower(seed=0):
    tower = factory.init_params(TT.CLIPTextTransformer(**TINY_CLIP, device="cpu"))
    _redraw_unit_scale(tower, seed)
    return tower.eval()


def flax_clip_params(state_dict):
    """``cond_stage_model.transformer.*``-style weights -> FlaxCLIPTextModel
    params at the JAX module's ``_CLIP_TEXT_CONFIG``, as the JAX package's
    ``clip_text_params_from_state_dict`` converts them (transformers' own
    converter), handing the converter the model's param shapes: that
    function reads the params of a model built with ``_do_init=False``,
    which transformers 4.57 refuses (ROADMAP Queue 3)."""
    from transformers import CLIPTextConfig, FlaxCLIPTextModel
    from transformers.modeling_flax_pytorch_utils import convert_pytorch_state_dict_to_flax

    model = FlaxCLIPTextModel(CLIPTextConfig(**JT._CLIP_TEXT_CONFIG), _do_init=False)
    shapes = types.SimpleNamespace(base_model_prefix=model.base_model_prefix,
                                   params=model.params_shape_tree)
    sd = {k[len("transformer."):]: torch.as_tensor(np.asarray(v))
          for k, v in state_dict.items() if k.startswith("transformer.")}
    return convert_pytorch_state_dict_to_flax(sd, shapes)


def _jax_embedder(tower, monkeypatch):
    monkeypatch.setattr(JT, "_CLIP_TEXT_CONFIG", TINY_CLIP)
    sd = {f"transformer.{k}": v for k, v in tower.state_dict().items()}
    with pytest.raises(ValueError, match="_do_init=False"):  # the JAX package's own converter
        JT.clip_text_params_from_state_dict(sd)
    return JT.FrozenCLIPEmbedder(flax_clip_params(sd))


def test_clip_text_tower_matches_flax(monkeypatch):
    """The tower on random ids against transformers' FlaxCLIPTextModel on the
    converted weights: a causal mask, so each position sees only its past."""
    tower = _tower()
    ids = np.random.RandomState(1).randint(0, TINY_CLIP["vocab_size"], (3, 77)).astype(np.int32)
    want = np.asarray(_jax_embedder(tower, monkeypatch).encode_ids(ids))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids)).numpy()
        # the causal mask: a change at the last position moves only that row
        ids2 = ids.copy()
        ids2[:, -1] = (ids2[:, -1] + 1) % TINY_CLIP["vocab_size"]
        moved = np.abs(tower(torch.from_numpy(ids2)).numpy() - got).max(axis=(0, 2))
    assert got.shape == (3, 77, TINY_CLIP["hidden_size"]) and got.dtype == np.float32
    _close(got, want, what="last_hidden_state")
    assert (moved[:-1] == 0).all() and moved[-1] > 0


def test_frozen_clip_embedder_matches_jax_end_to_end(tmp_path, monkeypatch):
    """Prompts -> ids (the in-repo BPE over the same merges file, EOT
    padding) -> contexts, on both sides; ``encode_ids`` of the JAX ids gives
    the same."""
    monkeypatch.setenv("CLIP_BPE_VOCAB", _merges_file(tmp_path))
    monkeypatch.setattr(TT, "_CLIP_TEXT_CONFIG", TINY_CLIP)
    emb = TT.FrozenCLIPEmbedder(device="cpu")
    emb.transformer.load_state_dict(_tower(seed=2).state_dict())
    ref = _jax_embedder(emb.transformer, monkeypatch)
    got = emb(PROMPTS)
    want = np.asarray(ref(PROMPTS))
    assert not got.requires_grad
    _close(got.numpy(), want, what="contexts")
    ids = ref._get_tokenizer()(PROMPTS)["input_ids"]
    np.testing.assert_array_equal(emb.tokenize(PROMPTS), ids)
    assert (ids[0, 5:] == TB.SimpleBPETokenizer(MERGES).eot_id).all()  # EOT padding
    torch.testing.assert_close(emb.encode_ids(ids), got, rtol=0, atol=0)


def test_bert_text_transformer_matches_jax_at_depth_2():
    """The LDM BERT tower from a reference-named state_dict (with the
    ``to_logits`` head the converter leaves out) on both sides."""
    kw = dict(n_embed=32, n_layer=2, vocab_size=100, max_seq_len=77, heads=2, dim_head=8)
    src = factory.init_params(TT.BERTTextTransformer(**kw, device="cpu"))
    _redraw_unit_scale(src, seed=3)
    sd = {f"transformer.{k}": v for k, v in src.state_dict().items()}
    sd["transformer.to_logits.weight"] = torch.zeros(100, 32)
    port = TT.BERTTextTransformer(**kw, device="cpu")
    port.load_state_dict(TT.bert_params_from_state_dict(sd, depth=2))
    ids = np.random.RandomState(4).randint(0, 100, (2, 77))
    want = JT.BERTTextTransformer(**kw)(JT.bert_params_from_state_dict(sd, depth=2), ids)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 77, 32)
    _close(got, want, what="BERT embeddings")


def test_full_width_clip_keys_are_transformers_clip_text_model():
    """The port's tower at ``_CLIP_TEXT_CONFIG`` (clip-vit-large-patch14's
    text side) on the meta device: transformers' torch CLIPTextModel's
    state_dict names and shapes, 123M parameters."""
    transformers = pytest.importorskip("transformers")
    with torch.device("meta"):
        ref = transformers.CLIPTextModel(transformers.CLIPTextConfig(**TT._CLIP_TEXT_CONFIG))
    port = TT.FrozenCLIPEmbedder(device="meta").transformer
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert 123e6 < sum(p.numel() for p in port.parameters()) < 124e6
