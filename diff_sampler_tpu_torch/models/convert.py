"""JAX (Flax) parameters <-> the port's state_dict.

``params_from_jax`` is the inverse of
``diff_sampler_tpu/models/torch_import.py::state_dict_to_params``:

  * 4-D conv kernels: HWIO -> OIHW
  * 2-D linear kernels: (in, out) -> (out, in)
  * norm ``scale`` -> ``weight``
  * ``enc_16x16_block0`` -> ``enc.16x16_block0`` (and ``dec_*`` alike)

``params_to_jax`` is its inverse, for modules the port trains (the AMED
predictor, SFD's EDM students), whose params the JAX package then loads.
The names need no case of their own for SFD-v's modules: ``affine_step``,
``map_step_layer0`` / ``map_step_layer1`` and a Fourier ``map_step``'s
``freqs`` (a buffer here, a param there) carry over as any layer's do.

``load_ldm_jax_params`` loads the JAX package's latent-diffusion param trees
(``unet``, ``decoder``, ``post_quant_conv``, for a VQ first stage
``codebook``, and for a KL stage built with its encoder ``encoder`` and
``quant_conv``), whose modules are named by the reference's state_dict paths
with '.' -> '_' (``diff_sampler_tpu/models/ldm.py::_mechanical``): it walks
the port's own state_dict keys and looks each path up with its dots
replaced, never splitting a JAX name on '_'.  That covers Stable Diffusion's
U-Net as it is: the spatial transformers' bias-free ``to_q`` / ``to_k`` /
``to_v`` kernels, ``to_out_0``, ``ff_net_0_proj``, ``ff_net_2``, the
LayerNorms ``norm1``-``norm3`` (``scale`` / ``bias``), ``proj_in`` /
``proj_out``, and the KL stage's ``post_quant_conv``.

``ldm_params_to_jax`` / ``ldm_params_from_jax`` carry a latent U-Net's
state_dict (or any tensors under its names, such as Adam's moments) to
the JAX package's flat ``unet`` tree and back: SFD's latent students.

``load_adm_jax_params`` loads the JAX package's ADM param trees
(``ADMUNet`` / ``ADMClassifier``, named by the reference's paths with '.' ->
'_' by ``adm_state_dict_to_params``) the same way, walking the port's own
names: ``in_layers``, ``emb_layers``, ``skip_connection``, ``proj_out``,
``qkv_proj``, ``c_proj`` and ``positional_embedding`` hold '_' themselves.
``label_emb_weight`` is the table as it is, ``out_2_positional_embedding``
the transpose of the port's [C, T].

``inception_state_dict_from_jax`` carries the JAX package's FID
Inception-V3 params (``bn_scale`` / ``bn_bias`` / ``bn_mean`` / ``bn_var``
beside each conv) to the port's detector, which has torchvision's names.

``lpips_state_dict_from_jax`` carries the JAX package's LPIPS params
(``vgg.conv0``-``conv12`` HWIO kernels, the heads ``lin0``-``lin4`` as [C]
vectors) to the port's ``eval.lpips.LPIPS``, which has torchvision's
``features.{i}`` and the LPIPS heads' ``lin{i}.model.1.weight`` names.

``openclip_state_dict_from_jax`` carries the JAX package's OpenCLIP params
(``openclip_params_from_state_dict``'s tree: HWIO patch conv, linear
kernels stored [in, out]) back to open_clip's state_dict names, which the
port's ``models/openclip.py::OpenCLIP`` carries.

The JAX params are nested dicts of numpy arrays (``np.asarray`` of each leaf
of a Flax params tree), so this module needs no jax.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "load_jax_params", "load_ldm_jax_params",
           "ldm_params_to_jax", "ldm_params_from_jax", "load_adm_jax_params", "absent_from_jax",
           "inception_state_dict_from_jax", "lpips_state_dict_from_jax",
           "openclip_state_dict_from_jax"]

_SPLIT_PREFIXES = ("enc_", "dec_")
# U-Net level names after the prefix: ``16x16_block0``, ``8x8_aux_norm``...
# (the AMED predictor's ``enc_layer0`` is not split)
_LEVEL = re.compile(r"^\d+x\d+_")


def absent_from_jax(key: str) -> bool:
    """State_dict keys a JAX params tree never holds: the resample filter
    buffers, which the JAX package recomputes from the config, and
    ``map_augment``, which the JAX init creates only when augment labels are
    passed (reference checkpoints carry it; sampling passes no augment
    labels)."""
    parts = key.split(".")
    return parts[-1] == "resample_filter" or parts[-2:] == ["map_augment", "weight"]


def _name(part: str) -> str:
    for p in _SPLIT_PREFIXES:
        if part.startswith(p) and _LEVEL.match(part[len(p):]):
            return f"{p[:-1]}.{part[len(p):]}"
    return part


def params_from_jax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested JAX params dict into a torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in params.items():
        if isinstance(val, Mapping):
            out.update(params_from_jax(val, f"{prefix}{_name(key)}."))
            continue
        arr = np.array(val, dtype=np.float32)  # a writable copy
        leaf = key
        if key == "kernel":
            leaf = "weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank for {prefix}{key}: {arr.shape}")
        elif key == "scale":
            leaf = "weight"
        out[prefix + leaf] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A state_dict as the nested JAX params dict (numpy f32 leaves): conv
    weights OIHW -> HWIO ``kernel``, linear weights (out, in) -> (in, out)
    ``kernel``, 1-D (norm) weights -> ``scale``, ``enc.X`` -> ``enc_X``.
    The keys ``absent_from_jax`` names are left out."""
    out: Dict[str, Any] = {}
    for key, val in state_dict.items():
        if absent_from_jax(key):
            continue
        parts = []
        for part in key.split("."):
            if parts and parts[-1] + "_" in _SPLIT_PREFIXES:
                part = f"{parts.pop()}_{part}"
            parts.append(part)
        arr = val.detach().cpu().float().numpy()
        leaf = parts[-1]
        if leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            else:
                leaf = "scale"
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out


def load_jax_params(module: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Load JAX params into ``module`` in place.  Every key must match, apart
    from the keys ``absent_from_jax`` names, which keep their values."""
    sd = params_from_jax(params)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    bad_missing = [k for k in missing if not absent_from_jax(k)]
    if bad_missing or unexpected:
        raise KeyError(f"JAX params do not match the module: missing {bad_missing}, "
                       f"unexpected {list(unexpected)}")
    return module


def _unmechanical(node: Mapping[str, Any], leaf: str, ndim: int) -> np.ndarray:
    """The torch tensor of one state_dict leaf from its JAX module's params:
    HWIO kernels -> OIHW, (in, out) kernels -> (out, in), ``scale`` ->
    ``weight``."""
    if leaf != "weight":
        return np.asarray(node[leaf], np.float32)
    if ndim == 4:
        return np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1)
    if ndim == 2:
        return np.asarray(node["kernel"], np.float32).T
    return np.asarray(node["scale"], np.float32)


def _from_mechanical(flat: Mapping[str, Any], like: Mapping[str, torch.Tensor],
                     special: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """{state_dict key of ``like``: tensor} from JAX modules named by the
    key's path with '.' -> '_' (``special`` gives some keys' arrays as they
    are).  Every key must be found and every JAX module used."""
    special = special or {}
    sd, used, missing = {}, set(), []
    for key, ref in like.items():
        if key in special:
            sd[key] = torch.from_numpy(np.array(special[key], np.float32))
            continue
        path, leaf = key.rsplit(".", 1)
        name = path.replace(".", "_")
        if name not in flat:
            missing.append(key)
            continue
        used.add(name)
        arr = _unmechanical(flat[name], leaf, ref.dim())
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{key}: JAX {name} gives {arr.shape}, the module has "
                             f"{tuple(ref.shape)}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    unused = sorted(set(flat) - used)
    if missing or unused:
        raise KeyError(f"JAX params do not match the module: missing {missing}, "
                       f"unused {unused}")
    return sd


def load_ldm_jax_params(ld: torch.nn.Module, trees: Mapping[str, Any]) -> torch.nn.Module:
    """Load the JAX package's LatentDiffusion param trees (``unet``,
    ``decoder``, ``post_quant_conv``, a VQ stage's ``codebook`` and, where
    ``ld``'s KL stage has its encoder, ``encoder`` and ``quant_conv``, as
    ``ldm_state_dict_to_params`` splits a checkpoint) into the port's
    ``models.ldm.LatentDiffusion`` in place.  Every state_dict key must be
    found and every JAX module used."""
    flat = {**{f"unet_{k}": v for k, v in trees["unet"].items()},
            **{f"first_stage_decoder_{k}": v for k, v in trees["decoder"].items()},
            "first_stage_post_quant_conv": trees["post_quant_conv"]}
    if getattr(ld.first_stage, "encoder", None) is not None:
        flat.update({f"first_stage_encoder_{k}": v for k, v in trees["encoder"].items()})
        flat["first_stage_quant_conv"] = trees["quant_conv"]
    special = {"first_stage.codebook": trees["codebook"]} if "codebook" in trees else {}
    ld.load_state_dict(_from_mechanical(flat, ld.state_dict(), special))
    return ld


def ldm_params_from_jax(tree: Mapping[str, Any], like: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's flat latent U-Net tree (``ld.unet_params``: modules
    named by the reference's paths with '.' -> '_') as tensors under the
    keys of ``like`` (the port's ``LDMUNet.state_dict()``, or the names of
    its trainable tensors); every key found, every JAX module used."""
    return _from_mechanical(tree, like)


def ldm_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A latent U-Net's state_dict (or tensors under its names) as the JAX
    package's flat ``unet`` tree: conv weights OIHW -> HWIO ``kernel``,
    linear weights -> (in, out) ``kernel``, 1-D weights -> ``scale``."""
    out: Dict[str, Any] = {}
    for key, val in state_dict.items():
        path, leaf = key.rsplit(".", 1)
        arr = val.detach().cpu().float().numpy()
        if leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            else:
                leaf = "scale"
        out.setdefault(path.replace(".", "_"), {})[leaf] = np.ascontiguousarray(arr)
    return out


def load_adm_jax_params(module: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Load the JAX package's ``ADMUNet`` / ``ADMClassifier`` params into the
    port's module of the same settings in place.  Every state_dict key must
    be found and every JAX entry used."""
    sd, used, missing = {}, set(), []
    for key, ref in module.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        flat = key.replace(".", "_")
        if flat in ("label_emb_weight", "out_2_positional_embedding") and flat in params:
            arr = np.asarray(params[flat], np.float32)
            arr = arr.T if leaf == "positional_embedding" else arr
            used.add(flat)
        else:
            name = path.replace(".", "_")
            if name not in params:
                missing.append(key)
                continue
            used.add(name)
            arr = _unmechanical(params[name], leaf, ref.dim())
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{key}: the JAX params give {arr.shape}, the module has "
                             f"{tuple(ref.shape)}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    unused = sorted(set(params) - used)
    if missing or unused:
        raise KeyError(f"JAX params do not match the module: missing {missing}, "
                       f"unused {unused}")
    module.load_state_dict(sd)
    return module


_INCEPTION_BN = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
                 "bn_var": "running_var"}


def inception_state_dict_from_jax(params: Mapping[str, Any], prefix: str = ""
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``InceptionV3FID`` params (numpy leaves) as the
    port's ``eval.inception.InceptionV3FID`` state_dict: each unit's
    ``conv.kernel`` HWIO -> ``conv.weight`` OIHW, and ``bn_scale`` /
    ``bn_bias`` / ``bn_mean`` / ``bn_var`` -> ``bn.weight`` / ``bias`` /
    ``running_mean`` / ``running_var``."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in params.items():
        if key == "conv":
            arr = np.asarray(val["kernel"], np.float32).transpose(3, 2, 0, 1)
            out[f"{prefix}conv.weight"] = torch.from_numpy(np.ascontiguousarray(arr))
        elif key in _INCEPTION_BN:
            out[f"{prefix}bn.{_INCEPTION_BN[key]}"] = torch.from_numpy(
                np.array(val, np.float32))
        else:
            out.update(inception_state_dict_from_jax(val, f"{prefix}{key}."))
    return out


def lpips_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``LPIPS`` params (numpy leaves) as the port's
    ``eval.lpips.LPIPS`` state_dict: ``vgg.conv{j}`` HWIO -> the j-th conv
    of torchvision's ``features`` OIHW, ``lin{i}`` [C] -> ``lin{i}.model.1.weight``
    [1, C, 1, 1]."""
    from ..eval.lpips import VGG_CONV_INDICES

    out: Dict[str, torch.Tensor] = {}
    for j, tv in enumerate(VGG_CONV_INDICES):
        conv = params["vgg"][f"conv{j}"]
        out[f"features.{tv}.weight"] = _t(conv["kernel"], 3, 2, 0, 1)
        out[f"features.{tv}.bias"] = _t(conv["bias"])
    for i in range(5):
        out[f"lin{i}.model.1.weight"] = _t(params[f"lin{i}"]).reshape(1, -1, 1, 1)
    return out


def _t(val, *axes) -> torch.Tensor:
    arr = np.asarray(val, np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(*axes) if axes else arr))


def _openclip_blocks(blocks, prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for i, p in enumerate(blocks):
        d = f"{prefix}.resblocks.{i}."
        for ln in ("ln_1", "ln_2"):
            out[d + f"{ln}.weight"] = _t(p[ln]["scale"])
            out[d + f"{ln}.bias"] = _t(p[ln]["bias"])
        out[d + "attn.in_proj_weight"] = _t(p["attn"]["in_proj_w"], 1, 0)
        out[d + "attn.in_proj_bias"] = _t(p["attn"]["in_proj_b"])
        out[d + "attn.out_proj.weight"] = _t(p["attn"]["out_proj_w"], 1, 0)
        out[d + "attn.out_proj.bias"] = _t(p["attn"]["out_proj_b"])
        out[d + "mlp.c_fc.weight"] = _t(p["c_fc_w"], 1, 0)
        out[d + "mlp.c_fc.bias"] = _t(p["c_fc_b"])
        out[d + "mlp.c_proj.weight"] = _t(p["c_proj_w"], 1, 0)
        out[d + "mlp.c_proj.bias"] = _t(p["c_proj_b"])
    return out


def openclip_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's OpenCLIP params (``{"visual": ..., "text": ...}``,
    numpy leaves) as an open_clip state_dict: the patch conv HWIO -> OIHW,
    each linear kernel [in, out] -> [out, in], LayerNorm ``scale`` ->
    ``weight``; embeddings and projections as they are.  No ``logit_scale``:
    the JAX tree has none."""
    v, t = params["visual"], params["text"]
    out = {"visual.conv1.weight": _t(v["conv1_w"], 3, 2, 0, 1),
           "visual.class_embedding": _t(v["class_embedding"]),
           "visual.positional_embedding": _t(v["positional_embedding"]),
           "visual.proj": _t(v["proj"]),
           "token_embedding.weight": _t(t["token_embedding"]),
           "positional_embedding": _t(t["positional_embedding"]),
           "text_projection": _t(t["text_projection"])}
    for name, p in (("visual.ln_pre", v["ln_pre"]), ("visual.ln_post", v["ln_post"]),
                    ("ln_final", t["ln_final"])):
        out[f"{name}.weight"], out[f"{name}.bias"] = _t(p["scale"]), _t(p["bias"])
    out.update(_openclip_blocks(v["resblocks"], "visual.transformer"))
    out.update(_openclip_blocks(t["resblocks"], "transformer"))
    return out
