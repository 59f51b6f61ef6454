"""The port's OpenCLIP towers (``models/openclip.py``) against the JAX
package's (``diff_sampler_tpu/models/openclip.py``).

The state_dict is a tiny transformers ``CLIPModel`` repackaged in
open_clip's names (``tests/test_openclip.py::_to_openclip_sd``), every tensor
redrawn from a numpy seed at unit scale so that no part of the towers
hides behind small weights.  Checks: config inference, each tower within
1e-5 * max|embedding| of the JAX one (f32 on the CPU: both sum in f32 in
other orders), the loader on a ``torch.save`` file whose keys carry
``module.``, its refusal of a foreign key, and
``convert.openclip_state_dict_from_jax`` (the JAX params tree back to the
state_dict, bit for bit).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_sampler_tpu.models import openclip as JO
from diff_sampler_tpu_torch.eval.clip_score import make_openclip_encoders
from diff_sampler_tpu_torch.models import openclip as TO
from diff_sampler_tpu_torch.models.convert import openclip_state_dict_from_jax
from test_openclip import _to_openclip_sd

TOL = 1e-5  # of max|JAX embedding|
VISION_HEADS = 4  # of 12: the 48-wide vision tower is not in the head-width table
CONTEXT = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test run puts several workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_openclip_sd(vocab_size: int = 64, seed: int = 0) -> dict:
    """A tiny open_clip state_dict (vision 48 wide, 2 layers, 24 px in 8 px
    patches; text 128 wide = 2 heads of 64, 2 layers, 16 tokens; embed 20),
    every tensor drawn from ``seed``: matrices at 1 / sqrt(fan_in),
    LayerNorm scales about 1, biases and embeddings about 0.1."""
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, CLIPVisionConfig

    torch.manual_seed(seed)
    cfg = CLIPConfig(
        text_config=CLIPTextConfig(vocab_size=vocab_size, hidden_size=128,
                                   intermediate_size=256, num_hidden_layers=2,
                                   num_attention_heads=2, max_position_embeddings=CONTEXT,
                                   hidden_act="gelu").to_dict(),
        vision_config=CLIPVisionConfig(hidden_size=48, intermediate_size=96,
                                       num_hidden_layers=2, num_attention_heads=VISION_HEADS,
                                       image_size=24, patch_size=8,
                                       hidden_act="gelu").to_dict(),
        projection_dim=20)
    sd = _to_openclip_sd(CLIPModel(cfg))
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(sd.items()):
        shape = tuple(v.shape)
        if k.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight", "ln_post.weight",
                       "ln_final.weight")):
            arr = 1.0 + 0.1 * rng.randn(*shape)
        elif v.dim() >= 2 and not k.endswith(("embedding", "embedding.weight")):
            fan_in = shape[0] if k.endswith(("proj", "projection")) else int(np.prod(shape[1:]))
            arr = rng.randn(*shape) / math.sqrt(fan_in)
        else:
            arr = 0.1 * rng.randn(*shape)
        out[k] = torch.from_numpy(arr.astype(np.float32))
    out["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return out


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max(), err_msg=what)


def _ids(n, vocab_size=64, seed=1):
    ids = np.random.RandomState(seed).randint(1, vocab_size - 1, size=(n, CONTEXT))
    ids[:, CONTEXT // 2:] = 0  # zero padding after an EOT = the largest id
    ids[:, CONTEXT // 2 - 1] = vocab_size - 1
    return ids


@pytest.fixture(scope="module")
def sd():
    return tiny_openclip_sd()


@pytest.fixture(scope="module")
def jax_side(sd):
    params = JO.openclip_params_from_state_dict(sd)
    cfg = dataclasses.replace(params.pop("config"), vision_heads=VISION_HEADS)
    return JO.OpenCLIP(cfg), params


def test_config_inference_matches_jax(sd):
    ours = TO.infer_openclip_config(sd)
    want = JO.infer_openclip_config({k: v.numpy() for k, v in sd.items()})
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert (ours.embed_dim, ours.image_size, ours.patch_size, ours.vision_width,
            ours.vision_layers, ours.text_width, ours.text_heads, ours.vocab_size,
            ours.context_length) == (20, 24, 8, 48, 2, 128, 2, 64, CONTEXT)
    assert TO._VISION_HEAD_WIDTH == JO._VISION_HEAD_WIDTH
    vitg = {"visual.conv1.weight": np.zeros((1408, 3, 14, 14)),
            "visual.positional_embedding": np.zeros((257, 1408)),
            "visual.transformer.resblocks.39.attn.in_proj_weight": None,
            "visual.transformer.resblocks.0.mlp.c_fc.weight": np.zeros((6144, 1408)),
            "token_embedding.weight": np.zeros((49408, 1024)),
            "transformer.resblocks.23.ln_1.weight": None,
            "transformer.resblocks.0.mlp.c_fc.weight": np.zeros((4096, 1024)),
            "text_projection": np.zeros((1024, 1024)),
            "positional_embedding": np.zeros((77, 1024))}
    assert TO.infer_openclip_config(vitg) == TO.OpenCLIPConfig(
        embed_dim=1024, image_size=224, patch_size=14, vision_width=1408, vision_layers=40,
        vision_heads=16, vision_mlp_dim=6144, text_width=1024, text_layers=24, text_heads=16,
        text_mlp_dim=4096, vocab_size=49408, context_length=77)


def test_image_tower_matches_jax(sd, jax_side):
    jmodel, params = jax_side
    model = TO.openclip_from_state_dict(sd, vision_heads=VISION_HEADS, device="cpu")
    pixels = np.random.RandomState(0).randn(3, 24, 24, 3).astype(np.float32)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(pixels)).numpy()
    _close(got, jmodel.encode_image(params, jnp.asarray(pixels)), "image tower")


def test_text_tower_matches_jax(sd, jax_side):
    jmodel, params = jax_side
    model = TO.openclip_from_state_dict(sd, vision_heads=VISION_HEADS, device="cpu")
    ids = _ids(3)
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(ids)).numpy()
    _close(got, jmodel.encode_text(params, jnp.asarray(ids, jnp.int32)), "text tower")


def test_loader_reads_a_module_prefixed_torch_file(sd, jax_side, tmp_path):
    """``make_openclip_encoders`` on a ``torch.save`` of {"module." + key}:
    both encoders against the JAX towers on the JAX package's
    preprocessing (uint8 images at 40 x 32 px: resize and centre crop)."""
    from diff_sampler_tpu.eval.clip_score import clip_preprocess as jax_preprocess

    path = tmp_path / "open_clip_pytorch_model.bin"
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    image_fn, text_fn = make_openclip_encoders(str(path), vision_heads=VISION_HEADS,
                                               device="cpu")
    jmodel, params = jax_side
    images = np.random.RandomState(2).randint(0, 256, (2, 40, 32, 3), np.uint8)
    _close(image_fn(images).numpy(),
           jmodel.encode_image(params, jax_preprocess(images, 24)), "image encoder")
    ids = _ids(2, seed=3)
    _close(text_fn(ids).numpy(), jmodel.encode_text(params, jnp.asarray(ids, jnp.int32)),
           "text encoder")
    model = image_fn.__self__.model
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    assert model.logit_scale.item() == pytest.approx(sd["logit_scale"].item())


def test_loader_names_a_foreign_key_and_allows_no_logit_scale(sd):
    bad = dict(sd, **{"visual.extra.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="visual.extra.weight"):
        TO.openclip_from_state_dict(bad, vision_heads=VISION_HEADS, device="cpu")
    no_scale = {k: v for k, v in sd.items() if k != "logit_scale"}
    model = TO.openclip_from_state_dict(no_scale, vision_heads=VISION_HEADS, device="cpu")
    assert model.logit_scale.item() == pytest.approx(math.log(1 / 0.07))


def test_convert_from_jax_params_restores_the_state_dict(sd):
    params = JO.openclip_params_from_state_dict(sd)
    params.pop("config")
    back = openclip_state_dict_from_jax(params)
    assert set(back) == set(sd) - {"logit_scale"}
    for k, v in back.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        assert torch.equal(v, sd[k]), k
    model = TO.openclip_from_state_dict(back, vision_heads=VISION_HEADS, device="cpu")
    model.load_state_dict(dict(back, logit_scale=sd["logit_scale"]))
