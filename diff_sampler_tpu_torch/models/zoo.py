"""Pre-trained checkpoint registry and local resolver.

Counterpart of ``diff_sampler_tpu/models/zoo.py`` (itself the reference's
``torch_utils/download_util.py``): the URL table, the dataset specs, the
companion files (the ImageNet-256 classifier, the VQ-f4 first stage of the
LDMs, the MS-COCO captions of SD) and the local search of the offline roots.

One intended departure: the port never downloads.  A file that is in none
of the offline roots raises ``FileNotFoundError`` naming the key, the file
name, the places searched and the URL it comes from; fetch it there by
hand and place it in one of the roots (relative to the working directory).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import torch

from .torch_import import load_torch_file, torch_state_dict

__all__ = ["CHECKPOINT_URLS", "MODEL_SPECS", "OFFLINE_ROOTS", "check_file_by_key",
           "find_file", "load_checkpoint_params"]

# Same artifacts as download_util.py:6-19.
CHECKPOINT_URLS: Dict[str, str] = {
    "cifar10": "https://nvlabs-fi-cdn.nvidia.com/edm/pretrained/edm-cifar10-32x32-uncond-vp.pkl",
    "ffhq": "https://nvlabs-fi-cdn.nvidia.com/edm/pretrained/edm-ffhq-64x64-uncond-vp.pkl",
    "afhqv2": "https://nvlabs-fi-cdn.nvidia.com/edm/pretrained/edm-afhqv2-64x64-uncond-vp.pkl",
    "imagenet64": "https://nvlabs-fi-cdn.nvidia.com/edm/pretrained/edm-imagenet-64x64-cond-adm.pkl",
    "lsun_bedroom": "https://openaipublic.blob.core.windows.net/consistency/edm_bedroom256_ema.pt",
    "imagenet256": "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/256x256_diffusion.pt",
    "imagenet256-classifier": "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/256x256_classifier.pt",
    "lsun_bedroom_ldm": "https://ommer-lab.com/files/latent-diffusion/lsun_bedrooms.zip",
    "ffhq_ldm": "https://ommer-lab.com/files/latent-diffusion/ffhq.zip",
    "vq-f4": "https://ommer-lab.com/files/latent-diffusion/vq-f4.zip",
    "ms_coco": "https://huggingface.co/runwayml/stable-diffusion-v1-5/resolve/main/v1-5-pruned-emaonly.ckpt",
    "prompts": "https://github.com/boomb0om/text2image-benchmark/releases/download/v0.0.1/MS-COCO_val2014_30k_captions.csv",
}

# dataset key -> (model_source, resolution, channels, label_dim)
# (diff-solvers-main/sample.py:76-121)
MODEL_SPECS = {
    "cifar10": ("edm", 32, 3, 0),
    "ffhq": ("edm", 64, 3, 0),
    "afhqv2": ("edm", 64, 3, 0),
    "imagenet64": ("edm", 64, 3, 1000),
    "lsun_bedroom": ("cm", 256, 3, 0),
    "imagenet256": ("adm", 256, 3, 1000),
    "lsun_bedroom_ldm": ("ldm", 64, 3, 0),
    "ffhq_ldm": ("ldm", 64, 3, 0),
    "ms_coco": ("sd", 64, 4, 1),
}

_COMPANIONS = {
    "imagenet256": ["imagenet256-classifier"],
    "lsun_bedroom_ldm": ["vq-f4"],
    "ffhq_ldm": ["vq-f4"],
    "ms_coco": ["prompts"],
}

OFFLINE_ROOTS = ("src", "models", "checkpoints")


def find_file(key: str, offline_roots: Tuple[str, ...] = OFFLINE_ROOTS) -> str:
    """The local path of one registry key's file: the first of
    ``offline_roots`` (relative to the working directory) that holds the
    URL's file name."""
    fname = os.path.basename(CHECKPOINT_URLS[key])
    searched = [os.path.join(root, fname) for root in offline_roots]
    for path in searched:
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"checkpoint '{key}' ({fname}) is not in {searched} (relative to "
        f"{os.getcwd()}); nothing is downloaded: fetch {CHECKPOINT_URLS[key]} and place it "
        f"in one of those directories, or pass its path")


def check_file_by_key(key: str, offline_roots: Tuple[str, ...] = OFFLINE_ROOTS
                      ) -> Tuple[str, List[str]]:
    """(main path, [companion paths]) of a registry key, found in
    ``offline_roots`` relative to the working directory
    (download_util.py:24-44, 79-113, without the download)."""
    if key not in CHECKPOINT_URLS:
        raise KeyError(f"unknown checkpoint key '{key}'; known: {sorted(CHECKPOINT_URLS)}")
    main = find_file(key, offline_roots)
    return main, [find_file(c, offline_roots) for c in _COMPANIONS.get(key, [])]


def load_checkpoint_params(path: str) -> Dict[str, torch.Tensor]:
    """A reference torch checkpoint as a flat state_dict under the
    reference's names, which the port's modules carry (floating tensors in
    f32, on the CPU; no code from the file runs)."""
    return torch_state_dict(load_torch_file(path))
