"""Model factory: dataset name -> denoiser.

Counterpart of ``diff_sampler_tpu/models/factory.py`` for the pixel EDM
tier and the latent tiers (the unconditional LSUN-Bedroom / FFHQ LDM and
Stable Diffusion v1.5, ``ms_coco``).  The architecture tables are the JAX
package's ``EDM_ARCHS`` (itself ``sfd-main/training/training_loop.py:59-77``)
and ``LDM_CONFIGS``, repeated here because the port imports nothing of the
JAX package.  ``model_path`` is ``'random'`` (weights from seed 0), a
reference checkpoint file (EDM ``.pkl``, ``.pt``, LDM / SD ``.ckpt``, read
by ``models.torch_import`` without running any of its code), or None: the
zoo's file for the dataset in the offline roots (``models.zoo``; nothing is
downloaded).  The ADM / CM tiers come with a later slice.  The JAX
package's ``jit_params`` / ``bind_params`` routing of the big frozen nets
works around its TPU compile service and has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .convert import absent_from_jax
from .ldm import LDM_CONFIGS, build_latent_diffusion
from .precond import CFGPrecond, EDMPrecond
from .zoo import find_file, load_checkpoint_params

__all__ = ["EDM_ARCHS", "build_edm_model", "build_ldm_model", "create_model", "init_params",
           "load_edm_checkpoint"]

# dataset -> (interface kwargs, SongUNet / DhariwalUNet kwargs)
EDM_ARCHS: Dict[str, Tuple[Dict[str, Any], Dict[str, Any]]] = {
    "cifar10": (
        dict(img_resolution=32, img_channels=3, label_dim=0, model_type="SongUNet"),
        dict(embedding_type="positional", encoder_type="standard",
             decoder_type="standard", channel_mult_noise=1,
             resample_filter=[1, 1], model_channels=128,
             channel_mult=[2, 2, 2], dropout=0.13, augment_dim=9),
    ),
    "ffhq": (
        dict(img_resolution=64, img_channels=3, label_dim=0, model_type="SongUNet"),
        dict(embedding_type="positional", encoder_type="standard",
             decoder_type="standard", channel_mult_noise=1,
             resample_filter=[1, 1], model_channels=128,
             channel_mult=[1, 2, 2, 2], dropout=0.05, augment_dim=9),
    ),
    "imagenet64": (
        dict(img_resolution=64, img_channels=3, label_dim=1000, model_type="DhariwalUNet"),
        dict(model_channels=192, channel_mult=[1, 2, 3, 4]),
    ),
}
EDM_ARCHS["afhqv2"] = EDM_ARCHS["ffhq"]


def build_edm_model(dataset_name: str, *, dtype: torch.dtype = torch.float32,
                    sigma_min: Optional[float] = None, sigma_max: float = 80.0,
                    device="cuda") -> EDMPrecond:
    """The EDMPrecond module of a dataset, in eval mode, with its parameters
    allocated on ``device`` but not yet initialised (``init_params`` or
    ``convert.load_jax_params`` fills them)."""
    interface, kwargs = EDM_ARCHS[dataset_name]
    return EDMPrecond(sigma_min=sigma_min if sigma_min is not None else 0.002,
                      sigma_max=sigma_max, dtype=dtype, model_kwargs=dict(kwargs),
                      device=device, **interface).eval()


@torch.no_grad()
def init_params(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Initialise every parameter and buffer of ``module`` in place from one
    CPU generator seeded with ``seed``, so the weights do not depend on the
    device.  Returns the module."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return module


@torch.no_grad()
def load_edm_checkpoint(module: EDMPrecond, state_dict) -> EDMPrecond:
    """Load a reference EDM checkpoint state_dict into ``module`` in place,
    strictly, with two exemptions: ``resample_filter`` buffers are not
    loaded (the module keeps its own, from the config, as the JAX package
    recomputes them), and the keys ``convert.absent_from_jax`` names may be
    missing (``map_augment``, which sampling never applies: it is zeroed).
    Any other missing or unexpected key raises."""
    sd = {k: v for k, v in state_dict.items() if k.split(".")[-1] != "resample_filter"}
    missing, unexpected = module.load_state_dict(sd, strict=False)
    bad = [k for k in missing if not absent_from_jax(k)]
    if bad or unexpected:
        raise KeyError(f"the checkpoint does not match the EDM module: missing {bad}, "
                       f"unexpected {list(unexpected)}")
    own = module.state_dict()
    for key in missing:
        if key.split(".")[-1] != "resample_filter":
            own[key].zero_()
    return module


def _load(model_path: Optional[str], dataset_name: str):
    """The flat state_dict of a checkpoint file, or of the zoo's file for
    the dataset where ``model_path`` is None."""
    return load_checkpoint_params(model_path or find_file(dataset_name))


def build_ldm_model(dataset_name: str, model_path: Optional[str] = "random", *,
                    guidance_rate: float = 1.0, dtype: torch.dtype = torch.float32,
                    device="cuda") -> CFGPrecond:
    """An LDM / SD checkpoint -> CFGPrecond over its LatentDiffusion stack
    (``precond.latent_diffusion``), as the JAX package's ``build_ldm_model``
    (sfd training_loop.py:86-108): ``ms_coco`` (Stable Diffusion) under
    classifier-free guidance at ``guidance_rate``, its eps model taking the
    text context as ``cond``, sigma_min 0.1 (sfd training_loop.py:105); the
    unconditional LDMs with sigma_min 0.006 (:94, 99).  ``dtype`` is the
    U-Net's compute dtype; the first stage and the text encoder (bound where
    an SD checkpoint carries it) run in f32.  ``model_path`` as in
    ``create_model``."""
    state_dict = None if model_path == "random" else _load(model_path, dataset_name)
    ld = build_latent_diffusion(dataset_name, state_dict=state_dict, dtype=dtype,
                                device=device)
    del state_dict
    common = dict(alphas_cumprod=ld.alphas_cumprod, img_resolution=ld.unet.image_size,
                  img_channels=ld.unet.in_channels, latent_diffusion=ld)
    # the AMED tap: (eps, the middle block's output), as the JAX package's
    # ``_capture_middle_lazy`` gives them
    if ld.conditioning_key == "crossattn":
        precond = CFGPrecond(
            model_fn=ld.apply_model, guidance_type="classifier-free",
            guidance_rate=guidance_rate, epsilon_t=1e-3, label_dim=1,
            model_fn_bottleneck=lambda x, t, cond: ld.unet(x, t, cond, return_bottleneck=True),
            **common)
        precond.sigma_min = 0.1
        return precond
    precond = CFGPrecond(
        model_fn=lambda x, t, cond: ld.apply_model(x, t), guidance_type="uncond",
        guidance_rate=1.0, label_dim=0,
        model_fn_bottleneck=lambda x, t, cond: ld.unet(x, t, return_bottleneck=True), **common)
    precond.sigma_min = 0.006
    return precond


def create_model(dataset_name: str, model_path: Optional[str] = None, *,
                 guidance_rate: float = 1.0, dtype: torch.dtype = torch.float32,
                 device="cuda"):
    """Returns (module, model_source): an EDMPrecond and "edm", or a
    CFGPrecond and "ldm" (the unconditional latent tiers) or "sd"
    (``ms_coco``, guided at ``guidance_rate``; with a checkpoint, its text
    encoder bound).  ``model_path``: ``'random'`` (freshly initialised
    weights from seed 0), a reference checkpoint file, or None for the
    zoo's file of the dataset (``models.zoo.find_file``), which raises
    where it is not in the offline roots."""
    if dataset_name in EDM_ARCHS:
        module = build_edm_model(dataset_name, dtype=dtype, device=device)
        if model_path == "random":
            return init_params(module), "edm"
        return load_edm_checkpoint(module, _load(model_path, dataset_name)), "edm"
    if dataset_name in LDM_CONFIGS:
        precond = build_ldm_model(dataset_name, model_path, guidance_rate=guidance_rate,
                                  dtype=dtype, device=device)
        return precond, "sd" if dataset_name == "ms_coco" else "ldm"
    raise NotImplementedError(
        f"model tier for {dataset_name!r} is not ported yet; "
        f"available: {sorted(EDM_ARCHS) + sorted(LDM_CONFIGS)}")
