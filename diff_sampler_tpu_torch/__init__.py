"""diff_sampler_tpu_torch: the PyTorch and CUDA port of diff_sampler_tpu.

It runs the CIFAR-10 EDM sampling path (SongUNet denoiser, euler / heun /
ipndm / ipndm_v samplers, per-seed generation, PNG output) on an NVIDIA
Hopper card, with hand-written kernels built from ``csrc/`` at first use.
It imports torch and never jax; the noise schedules and multistep
coefficients are the JAX package's host-side numpy code.

Subpackages mirror the JAX package's module names:
  ops      - attention (kernel K1 and its plain version), GroupNorm
  models   - layers, SongUNet, EDMPrecond, factory, JAX-params converter
  solvers  - samplers
  utils    - per-seed RNG, image IO
  cli      - sample
"""

__version__ = "0.1.0"
