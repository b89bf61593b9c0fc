"""BENCHMARK.json against the contract, and every cell resolved to its files."""

import json
import os
import re

import pytest

from portbench import run as R

from .conftest import ROOT

BENCH = R.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.join(ROOT, "portbench")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check of 24 cells fits the check's time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(BENCH["workloads"]) <= 24 and 1 <= len(BENCH["configs"]) <= 24


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and cell["chips"] == 1
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert os.path.isfile(os.path.join(ROOT, config["file"]))
    traffic = R.load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    assert os.path.isfile(os.path.join(HERE, "drivers", traffic["driver"] + ".py"))
    limits = R.load_json(os.path.join(HERE, "limits", cell["name"] + ".json"))
    assert limits and all(v > 0 for v in limits.values())
    e2e = R.metrics_of(BENCH, cell["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert R.metrics_of(BENCH, cell["name"], "per_layer", names)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric["workloads"]:
        reported = {m["name"] for m in R.metrics_of(BENCH, cell, "end_to_end")}
        assert metric["moves"] in reported
    reader = R.reader_path(metric["name"])
    assert "def read(run)" in open(reader).read()
    if "roofline" in metric["name"]:
        # <kernel>_roofline, or <kernel>_roofline.<split>, read by one reader
        assert os.path.basename(reader).endswith("_roofline.py") and metric["unit"] == "%"


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    from portbench.weights import dims_of

    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    data = R.load_json(os.path.join(ROOT, config["file"]))
    assert data["_source"] == config["source"]
    dims = dims_of(data)
    from qasr_ijcnlp_tpu_torch.models.dims import dims_for

    size = "large-v3" if "large-v3" in config["name"] else "medium"
    assert dims == dims_for(size).to_dict()
