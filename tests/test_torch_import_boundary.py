"""The port imports torch and nothing of jax, flax or the JAX package.

A fresh interpreter with jax, jaxlib, flax and ``diff_sampler_tpu`` blocked
by a ``sys.meta_path`` finder imports the package, every submodule, and
``chip_smoke.py``.
"""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "diff_sampler_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import diff_sampler_tpu_torch as pkg
names = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_with_jax_and_flax_blocked():
    """Also blocks the JAX package itself, even its modules that import no
    jax (the port keeps its own copies of the numpy schedules)."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 30  # package, subpackages and modules
    assert {"diff_sampler_tpu_torch.models.adm", "diff_sampler_tpu_torch.models.ldm",
            "diff_sampler_tpu_torch.ops.groupnorm", "diff_sampler_tpu_torch.ops.attention",
            "diff_sampler_tpu_torch.training.conditioning", "diff_sampler_tpu_torch.training.amed",
            "diff_sampler_tpu_torch.cli.train_amed", "diff_sampler_tpu_torch.ops.conv",
            "diff_sampler_tpu_torch.ops.geometry", "diff_sampler_tpu_torch.models.analytic",
            "diff_sampler_tpu_torch.gits", "diff_sampler_tpu_torch.gits.search",
            "diff_sampler_tpu_torch.models.torch_import", "diff_sampler_tpu_torch.models.zoo",
            "diff_sampler_tpu_torch.models.text", "diff_sampler_tpu_torch.utils.bpe",
            "diff_sampler_tpu_torch.eval", "diff_sampler_tpu_torch.eval.dataset",
            "diff_sampler_tpu_torch.eval.inception", "diff_sampler_tpu_torch.eval.fid",
            "diff_sampler_tpu_torch.eval.prdc", "diff_sampler_tpu_torch.cli.fid",
            "diff_sampler_tpu_torch.cli.prdc", "diff_sampler_tpu_torch.cli.dataset_tool",
            "diff_sampler_tpu_torch.utils.lmdb_reader"} <= names
