"""Every configuration, workload, traffic kind and metric file is found by
name and parses, and ``BENCHMARK.json`` keeps to the benchmark's contract."""

from __future__ import annotations

import dataclasses
import json
import os
import re

import pytest

from bench_h100 import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_h100"]
    assert BENCH["command"][1].startswith("bench_h100/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("bench_h100/configs/")
    c = harness.load_json(harness.ROOT, cfg["file"])
    assert c["name"] == cfg["name"] and c["reduced"] == cfg["reduced"] == []
    # every field of the port's ModelConfig that shapes the model is stated
    from epcnet_torch.configs import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    for key in ("num_points", "knn_k", "proxyconv_channels", "lift_channels", "feature_dim",
                "vlad_clusters", "vlad_groups", "vlad_group_dim", "output_dim", "gating",
                "compute_dtype", "vlad_precision", "adjacency_format"):
        assert key in c["model"] and key in names
    assert c["model"]["name"] == cfg["name"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = harness.Cell(name)
    assert cell.entry["chips"] == 1 and NAME.match(name)
    assert 1 <= len(cell.entry["why"]) <= 200
    mod = harness.load_module("traffic", cell.workload["kind"])
    assert hasattr(mod, "Kind")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert cell.workload["limits"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_module(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert callable(harness.load_module("metrics", metric["name"]).read)
    for cell in metric["workloads"]:
        assert cell in CELLS


def test_end_to_end():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_every_file_is_named():
    """No configuration, workload or metric file lies around that no entry
    names, so the harness finds exactly what BENCHMARK.json says."""
    here = harness.HERE
    configs = {os.path.basename(c["file"]) for c in BENCH["configs"]}
    assert set(os.listdir(os.path.join(here, "configs"))) == configs
    assert {f[:-5] for f in os.listdir(os.path.join(here, "workloads"))} == set(CELLS)
    metrics = {m["name"] for m in BENCH["per_layer"]}
    assert {f[:-3] for f in os.listdir(os.path.join(here, "metrics"))
            if f.endswith(".py")} == metrics
