"""Build a configuration with the system under test, as its CLIs do:
``models.factory.create_model(dataset_name, path, ...)`` on a checkpoint,
whose state_dict is the benchmark's drawn weights under the published
checkpoint's names.  The factory reads a checkpoint file through its
``_load``; the benchmark hands it the drawn dict in its place instead of
writing gigabytes to disk, so the system's own checkpoint loader maps and
checks every key.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

CHECKPOINT = "<perfbench weights>"


@contextlib.contextmanager
def checkpoint(config: dict, state: dict):
    """Inside, the system's factory reads the checkpoint path ``CHECKPOINT``
    of the configuration's dataset as the state_dict ``state``."""
    from diff_sampler_tpu_torch.models import factory

    name = config["program"]["dataset_name"]

    def load(path, dataset_name):
        if path != CHECKPOINT or dataset_name != name:
            raise ValueError(f"unexpected checkpoint {path!r} for {dataset_name!r}")
        return state

    with mock.patch.object(factory, "_load", load):
        yield


def build(config: dict, state: dict, *, dtype=torch.float32, device="cuda",
          guidance_rate: float = 1.0):
    """The system's preconditioner of ``config`` with the weights ``state``
    (EDMPrecond or CFGPrecond), frozen, in eval mode."""
    from diff_sampler_tpu_torch.models import factory

    with checkpoint(config, state):
        module, _ = factory.create_model(config["program"]["dataset_name"], CHECKPOINT,
                                         guidance_rate=guidance_rate, dtype=dtype,
                                         device=device)
    nets = [module] if isinstance(module, torch.nn.Module) else [module.latent_diffusion]
    for net in nets:
        net.requires_grad_(False).eval()
    return module
