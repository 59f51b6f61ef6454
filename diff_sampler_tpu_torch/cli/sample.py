"""Sampling CLI of the port: seeds -> per-seed PNGs.

Counterpart of ``diff_sampler_tpu/cli/sample.py`` for the pixel EDM tier
with random weights, on the poly-7 schedule:

  python -m diff_sampler_tpu_torch.cli.sample --dataset_name=cifar10 \\
      --model_path=random --solver=ipndm --num_steps=6 --seeds=0-255 \\
      --batch=256 --bf16=True --device=cuda --outdir=out/

PNG writes for batch i run on the host while the device samples batch i+1
(``sampling.generate``'s batch callback).
"""

from __future__ import annotations

import argparse

import torch

from ..models.factory import EDM_ARCHS, create_model
from ..models.precond import bind
from ..sampling import SolverConfig, generate, to_uint8
from ..solvers import SOLVER_REGISTRY
from ..utils.image import parse_int_list, save_images


def _bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected True or False, got {s!r}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m diff_sampler_tpu_torch.cli.sample",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_name", required=True, choices=sorted(EDM_ARCHS))
    p.add_argument("--model_path", default="random",
                   help="'random' (seeded random weights); checkpoints are not ported yet")
    p.add_argument("--batch", dest="max_batch_size", type=int, default=64)
    p.add_argument("--seeds", default="0-63")
    p.add_argument("--outdir", default=None)
    p.add_argument("--bf16", type=_bool, default=False, help="bfloat16 inner model")
    p.add_argument("--device", default="cuda")
    p.add_argument("--solver", choices=sorted(SOLVER_REGISTRY), default="ipndm")
    p.add_argument("--num_steps", type=int, default=6)
    return p


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but CUDA is not available (pass --device=cpu)")
    seeds = parse_int_list(args.seeds)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    module, source = create_model(args.dataset_name, args.model_path, dtype=dtype,
                                  device=device)
    den = bind(module)
    shape = (module.img_resolution, module.img_resolution, module.img_channels)
    cfg = SolverConfig(solver=args.solver, num_steps=args.num_steps)
    print(f"Solver: {args.solver} | NFE: {cfg.nfe()} | schedule: "
          f"{cfg.schedule_type}(rho={cfg.schedule_rho}) | source: {source} | "
          f"device: {device}")
    out_base = args.outdir or f"samples/{args.dataset_name}-{args.solver}-{args.num_steps}"

    def save_batch(start, chunk):
        save_images(to_uint8(chunk), seeds[start:start + len(chunk)], out_base)

    generate(den, seeds, shape, cfg, max_batch_size=args.max_batch_size, device=device,
             batch_callback=save_batch)
    print(f"Saved {len(seeds)} images to {out_base}")


if __name__ == "__main__":
    main()
