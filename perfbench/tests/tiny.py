"""Tiny stand-ins of the cells for CPU tests: the system's tables and the
configuration files cut to a few channels, the traffic to a few images."""

from __future__ import annotations

import copy

from perfbench import core

CIFAR, SD = "cifar10-ipndm10-b256", "sd15-dpmpp5-cfg-b8"

TINY_EDM = dict(model_channels=16, channel_mult=[1, 2], num_blocks=4, attn_resolutions=[8],
                img_resolution=16)
TINY_UNET = dict(image_size=8, model_channels=32, channel_mult=[1, 2], num_heads=2,
                 context_dim=16)
TINY_VAE = dict(ch=32, ch_mult=[1, 1])


def tiny_cells(monkeypatch):
    """(CIFAR-10 cell, SD cell) dicts at tiny sizes, with the system's
    ``EDM_ARCHS["cifar10"]`` and ``LDM_CONFIGS["ms_coco"]`` patched to
    match."""
    from diff_sampler_tpu_torch.models import factory, ldm

    interface, kwargs = factory.EDM_ARCHS["cifar10"]
    interface = dict(interface, img_resolution=TINY_EDM["img_resolution"])
    kwargs = dict(kwargs, **{k: v for k, v in TINY_EDM.items() if k != "img_resolution"})
    monkeypatch.setitem(factory.EDM_ARCHS, "cifar10", (interface, kwargs))
    sd = copy.deepcopy(ldm.LDM_CONFIGS["ms_coco"])
    sd["unet"].update({k: tuple(v) if isinstance(v, list) else v for k, v in TINY_UNET.items()})
    sd["vae"].update({k: tuple(v) if isinstance(v, list) else v for k, v in TINY_VAE.items()})
    monkeypatch.setitem(ldm.LDM_CONFIGS, "ms_coco", sd)

    c1 = core.cell(CIFAR)
    c1["config"]["model"].update(TINY_EDM)
    c1["traffic"].update(batch=4, seed_list=40, trace_batches=2)
    c1["check"] = dict(c1["check"], images=6, reference_rows=6)
    c2 = core.cell(SD)
    m = c2["config"]["model"]
    m["unet"].update(TINY_UNET)
    m["vae"].update(TINY_VAE)
    m["context"] = {"tokens": 5, "dim": 16}
    c2["traffic"].update(batch=2, seed_list=12, trace_batches=2)
    c2["check"] = dict(c2["check"], images=3, reference_rows=2)
    return c1, c2
