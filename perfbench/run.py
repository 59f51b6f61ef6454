"""Run one cell of the benchmark once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Exits with a code other than 0, printing no
result, when there is no CUDA card, when the system under test is not in the
checkout, or when anything it loaded brought in JAX or the JAX package.
Every compiler cache lives in a fixed directory inside the checkout
(``perfbench/.cache``; the system's kernels build into
``diff_sampler_tpu_torch/csrc/build``), so only the first run of a checkout
builds.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import core  # noqa: E402

core.apply_cache_env()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    chips = core.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import diff_sampler_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the system under test is not in this checkout: {e}", file=sys.stderr)
        return 4
    from perfbench.harness import run_cell

    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                    started=STARTED)
    line.pop("readings")
    bad = core.loaded_forbidden()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 5
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
