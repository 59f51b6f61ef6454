"""Whole runs of the tiny cells on the CPU: the plain reference against the
system, the result line, the lower-precision control, and faults planted
under the timed path that the comparison must catch."""

import json

import pytest
import torch

from perfbench.harness import judge, run_cell
from perfbench.tests.tiny import tiny_cells

SEED = 2 ** 31 + 12345  # the driver's seeds run past 32 signed bits


@pytest.fixture
def cells(monkeypatch):
    return dict(zip(("cifar", "sd"), tiny_cells(monkeypatch)))


def _run(cell, trace=False, dtype=torch.float32, seconds=0.5):
    return run_cell(cell["name"], SEED, seconds, trace, device="cpu", dtype=dtype, cell=cell)


def _exact_gelu(monkeypatch):
    """The system's GEGLU on the exact GELU that SD v1.5 publishes and the
    reference computes, in place of its tanh approximation."""
    import torch.nn.functional as F

    from diff_sampler_tpu_torch.models import ldm

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)

    monkeypatch.setattr(ldm.GEGLU, "forward", forward)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("which", ["cifar", "sd"])
def test_reference_matches_the_system(cells, monkeypatch, which, trace):
    if which == "sd":
        _exact_gelu(monkeypatch)
    line = _run(cells[which], trace)
    r = line["readings"]
    # f32 against f32 on the CPU: only the order of sums differs (SD's f32
    # sigma maps against the reference's float64 ones add ~1e-6)
    assert r["worst_rel_l2"] < 2e-5 and r["worst_rel_max"] < 5e-5, r
    assert line["failed"] == 0 and line["attempted"] >= cells[which]["traffic"]["batch"]


def test_sd_system_tanh_gelu_reads_under_the_limit(cells):
    # the system's GEGLU takes the tanh GELU where SD v1.5 takes the exact
    # one: the comparison sees the gap, at this size well under the limit
    cell = cells["sd"]
    line = _run(cell)
    r = line["readings"]
    limit = _committed_limits(cell)["worst_rel_max"]
    assert 5e-5 < r["worst_rel_max"] < limit / 4, r


def test_result_line_shape(cells):
    line = _run(cells["sd"])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"images_per_s", "peak_mem_gib", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0.0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(line)
    traced = _run(cells["sd"], trace=True)
    assert "breakdown" in traced and "window_s" in traced["device"]
    assert set(traced["metrics"]) <= {"decode_share.sample"}  # no device trace on the CPU


def test_same_seed_same_inputs(cells):
    from perfbench import core, weights
    from perfbench.reference import edm

    names = edm.checkpoint_names(edm.build(cells["cifar"]["config"], device="meta"))
    a, b = weights.draw(names, SEED, "cpu"), weights.draw(names, SEED, "cpu")
    c = weights.draw(names, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in names)
    assert not all(torch.equal(a[k], c[k]) for k in names)
    assert core.image_seeds(SEED, 5) == core.image_seeds(SEED, 5) != core.image_seeds(SEED + 1, 5)


def test_judge():
    ok, checks = judge({"a": 1.0, "b": 5.0}, {"a": 2.0}, 0)
    assert ok and checks == {"a": {"value": 1.0, "limit": 2.0}}
    assert not judge({"a": 3.0}, {"a": 2.0}, 0)[0]
    assert not judge({"a": 1.0}, {"a": 2.0}, 1)[0]
    assert not judge({"a": 1.0}, {}, 0)[0]  # nothing compared is no proof


def _committed_limits(cell):
    from perfbench import core

    limits = core.load_json(core.HERE / "workloads" / f"{cell['name']}.json")["limits"]
    assert limits, "the cell's limits are set"
    return limits


@pytest.mark.parametrize("which", ["cifar", "sd"])
def test_bf16_control_comes_out_not_correct(cells, which):
    cell = cells[which]
    cell["check"] = dict(cell["check"], limits=_committed_limits(cell))
    f32 = _run(cell)
    bf16 = _run(cell, dtype=torch.bfloat16)
    assert f32["correct"] and not bf16["correct"], (f32["checks"], bf16["checks"])
    assert judge(bf16["readings"], cell["check"]["limits"], bf16["failed"]) == (
        False, bf16["checks"])
    for k in ("worst_rel_l2", "mean_rel_l2", "worst_rel_max"):
        assert bf16["readings"][k] > 10 * f32["readings"][k], (k, f32, bf16)


def _answer_altered(monkeypatch):
    from diff_sampler_tpu_torch import sampling

    real = sampling.build_sample_fn

    def altered(*a, **k):
        fn = real(*a, **k)

        def sample(latents):
            x = fn(latents).clone()
            x[:, 0, 0, 0] += 1.0  # one element of every answer
            return x

        return sample

    monkeypatch.setattr(sampling, "build_sample_fn", altered)


def _step_unchanged(monkeypatch):
    from diff_sampler_tpu_torch.solvers import samplers

    monkeypatch.setattr(samplers, "_eps_from", lambda denoise, x, t, afs: torch.zeros_like(x))


@pytest.mark.parametrize("fault", [_answer_altered, _step_unchanged])
@pytest.mark.parametrize("which", ["cifar", "sd"])
def test_planted_faults_come_out_not_correct(cells, monkeypatch, which, fault):
    cell = cells[which]
    cell["check"] = dict(cell["check"], limits=_committed_limits(cell))
    assert _run(cell)["correct"]
    fault(monkeypatch)
    line = _run(cell)
    assert not line["correct"], line["checks"]
