"""JAX (Flax) parameters <-> the port's state_dict.

``params_from_jax`` is the inverse of
``diff_sampler_tpu/models/torch_import.py::state_dict_to_params``:

  * 4-D conv kernels: HWIO -> OIHW
  * 2-D linear kernels: (in, out) -> (out, in)
  * norm ``scale`` -> ``weight``
  * ``enc_16x16_block0`` -> ``enc.16x16_block0`` (and ``dec_*`` alike)

``params_to_jax`` is its inverse, for modules the port trains (the AMED
predictor), whose params the JAX package then loads.

``load_ldm_jax_params`` loads the JAX package's latent-diffusion param trees
(``unet``, ``decoder``, ``post_quant_conv`` and, for a VQ first stage,
``codebook``), whose modules are named by the reference's state_dict paths
with '.' -> '_' (``diff_sampler_tpu/models/ldm.py::_mechanical``): it walks
the port's own state_dict keys and looks each path up with its dots
replaced, never splitting a JAX name on '_'.  That covers Stable Diffusion's
U-Net as it is: the spatial transformers' bias-free ``to_q`` / ``to_k`` /
``to_v`` kernels, ``to_out_0``, ``ff_net_0_proj``, ``ff_net_2``, the
LayerNorms ``norm1``-``norm3`` (``scale`` / ``bias``), ``proj_in`` /
``proj_out``, and the KL stage's ``post_quant_conv``.

The JAX params are nested dicts of numpy arrays (``np.asarray`` of each leaf
of a Flax params tree), so this module needs no jax.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "load_jax_params", "load_ldm_jax_params",
           "absent_from_jax"]

_SPLIT_PREFIXES = ("enc_", "dec_")
# U-Net level names after the prefix: ``16x16_block0``, ``8x8_aux_norm``...
# (the AMED predictor's ``enc_layer0`` is not split)
_LEVEL = re.compile(r"^\d+x\d+_")


def absent_from_jax(key: str) -> bool:
    """State_dict keys a JAX params tree never holds: the resample filter
    buffers, which the JAX package recomputes from the config, and
    ``map_augment``, which the JAX init creates only when augment labels are
    passed (reference checkpoints carry it; sampling never applies it)."""
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


def load_ldm_jax_params(ld: torch.nn.Module, trees: Mapping[str, Any]) -> torch.nn.Module:
    """Load the JAX package's LatentDiffusion param trees (``unet``,
    ``decoder``, ``post_quant_conv`` and a VQ stage's ``codebook``) into the
    port's ``models.ldm.LatentDiffusion`` (VQ or KL) in place.  Every
    state_dict key must be found and every JAX module used."""
    flat = {**{f"unet_{k}": v for k, v in trees["unet"].items()},
            **{f"first_stage_decoder_{k}": v for k, v in trees["decoder"].items()},
            "first_stage_post_quant_conv": trees["post_quant_conv"]}
    sd, used, missing = {}, set(), []
    for key, ref in ld.state_dict().items():
        if key == "first_stage.codebook":
            sd[key] = torch.from_numpy(np.array(trees["codebook"], np.float32))
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
    ld.load_state_dict(sd)
    return ld
