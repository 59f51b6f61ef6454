"""Every file the benchmark finds by name loads, and BENCHMARK.json keeps to
the shapes the harness relies on."""

import json
import re

import pytest

from perfbench import core

BENCH = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    c = core.cell(cell)
    assert c["config"]["name"] in [x["name"] for x in BENCH["configs"]]
    assert c["traffic"]["driver"]
    core.load_module("drivers", c["traffic"]["driver"])
    core.load_module("reference", c["config"]["reference"])
    core.load_module("programs", c["config"]["program"]["builder"])
    assert "limits" in c["check"]
    assert c["end_to_end"] and c["per_layer"]
    assert "setup_s" in [m["name"] for m in c["end_to_end"]]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(config):
    body = core.load_json(core.ROOT / config["file"])
    assert body["name"] == config["name"]
    assert body["reduced"] == config["reduced"] == []
    assert body["source"].startswith(config["source"].split(" ")[0])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads_and_reads_nothing_from_an_empty_trace(metric):
    from perfbench.reference.ops import Work

    reader = core.load_module("metrics", metric["name"])
    empty = {"class_s": {op: 0.0 for op in core.OP_CLASSES}, "busy_s": 0.0, "span_s": 0.0,
             "window_s": 0.0, "work": Work(), "peaks": None, "decode_s": None}
    assert reader.read(empty) is None


@pytest.mark.parametrize("op", core.OP_CLASSES)
def test_kernel_patterns_load(op):
    pats = core.kernel_patterns()[op]
    assert pats


@pytest.mark.parametrize("name,op", [
    ("flash_fwd_tf32_kernel<64, 3>", "attention"),
    ("flash_fwd_tf32_flat_kernel<48, 1>", "attention"),
    ("flash_fwd_tc_kernel<256, 3>", "attention"),
    ("flash_bwd_dkv_tf32_flat_kernel<48, 1>", "attention"),
    ("gn_slab_kernel<float>", "groupnorm"),
    ("gn_stream_apply_kernel<float>", "groupnorm"),
    ("sm90_xmma_fprop_implicit_gemm_tf32f32_tf32f32_f32_nhwckrsc_nhwc", "conv_gemm"),
    ("ampere_sgemm_128x64_tn", "conv_gemm"),
    ("conv3x3_f32_wgmma_kernel<true>", "conv_gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, silu>", None),
])
def test_kernel_names_fall_in_their_class(name, op):
    pats = core.kernel_patterns()
    got = next((o for o in core.OP_CLASSES if any(p.search(name) for p in pats[o])), None)
    assert got == op


def test_benchmark_json_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024
