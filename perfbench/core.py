"""What every cell shares: finding a cell's files by name, seeds, the peak
table, and the result line.

The benchmark is driven by data.  ``BENCHMARK.json`` names each cell's
configuration and traffic; this module finds

- ``configs/<config>.json``: the model as it is run (``program``: how the
  system under test builds it; ``reference``: the plain reference module
  under ``reference/``; ``model``: the sizes);
- ``traffic/<traffic>.json``: the job (``driver``: the module under
  ``drivers/`` that runs it, and its parameters);
- ``workloads/<cell>.json``: the cell's check (how many answers it compares
  and each number's limit);
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``kernels/<op>/*.json``: the kernel-name patterns of each op class;
- ``programs/<builder>.py``: how a configuration is built by the system.

A later change adds a configuration, a cell, a metric or a kernel pattern by
adding such files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diff_sampler_tpu")
OP_CLASSES = ("attention", "groupnorm", "conv_gemm")  # matched in this order


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The ``workloads`` entry of ``name`` with its files loaded: ``config``,
    ``traffic`` and ``check`` dicts."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: "
                         f"{[w['name'] for w in bench['workloads']]}")
    out = dict(entry)
    out["config"] = load_json(HERE / "configs" / f"{entry['config']}.json")
    out["traffic"] = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    out["check"] = load_json(HERE / "workloads" / f"{name}.json")
    out["end_to_end"] = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    out["per_layer"] = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return out


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module: ``perfbench.<kind>.<name>``, or, for
    a name with dots (a metric's), the file loaded by its path."""
    if name.isidentifier():
        return importlib.import_module(f"perfbench.{kind}.{name}")
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_patterns() -> Dict[str, List[re.Pattern]]:
    """{op class: compiled kernel-name patterns} from ``kernels/<op>/*.json``."""
    out = {}
    for op in OP_CLASSES:
        out[op] = [re.compile(load_json(p)["pattern"])
                   for p in sorted((HERE / "kernels" / op).glob("*.json"))]
    return out


def peaks(kind: str):
    """The published peaks of a device kind, or None where the table has
    none."""
    return load_json(HERE / "peaks.json")["devices"].get(kind)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of stream ``stream`` of a run's ``--seed``."""
    a, b = np.random.SeedSequence([int(seed), int(stream)]).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def image_seeds(seed: int, n: int) -> List[int]:
    """The per-image seeds of a run: ``n`` distinct 32-bit seeds."""
    return [int(s) for s in np.random.SeedSequence([int(seed), 7]).generate_state(n, np.uint32)]


def loaded_forbidden() -> List[str]:
    """Modules loaded in this process whose top-level name is one of
    ``FORBIDDEN``, compared whole (``diff_sampler_tpu_torch`` passes)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_env(root: Path = ROOT) -> Dict[str, str]:
    """Fixed cache directories inside the checkout for every compiler the
    program may use."""
    base = root / "perfbench" / ".cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"),
            "CUDA_CACHE_PATH": str(base / "nv"),
            "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}


def apply_cache_env() -> None:
    for k, v in cache_env().items():
        os.environ[k] = v
