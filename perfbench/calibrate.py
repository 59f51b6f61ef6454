"""Readings of a cell's comparison over many seeds, for the program and for
its control, in one process (the limits of ``workloads/<cell>.json`` are set
from them: above the largest reading of the program, below the smallest of
the control).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 \
        --seconds 3 [--out <file.jsonl>]

The control is the system's own lower-precision path: the inner model in
bfloat16, the CLI's ``--bf16``.  Each run is a whole run of the cell at its
own sizes, with a short window, judged against the cell's committed limits
(``correct`` and ``checks`` in each record).  The benchmark's own runs never
run the control.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import core  # noqa: E402

core.apply_cache_env()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from perfbench.harness import run_cell

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    runs = [(int(s), torch.float32) for s in args.seeds.split(",") if s]
    runs += [(int(s), torch.bfloat16) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, dtype in runs:
            t = time.perf_counter()
            line = run_cell(args.workload, seed, args.seconds, False, device="cuda",
                            dtype=dtype, started=t)
            rec = {"workload": args.workload, "seed": seed, "dtype": str(dtype),
                   "correct": line["correct"], "checks": line["checks"],
                   "readings": line["readings"], "metrics": line["metrics"],
                   "attempted": line["attempted"], "failed": line["failed"],
                   "seconds": time.perf_counter() - t}
            print("CALIBRATE " + json.dumps(rec), flush=True)
            if out is not None:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
