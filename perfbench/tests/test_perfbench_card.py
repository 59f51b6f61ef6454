"""On the card: each cell's whole run, as the benchmark's command makes it,
at a short window; each comes out correct and prints the contract's line.
Run there with ``python -m pytest -m cuda perfbench/tests``."""

import json
import subprocess
import sys

import pytest

from perfbench import core


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in core.benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, str(core.HERE / "run.py"), "--workload", cell,
                          "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
