"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file. What may be named is read from the files that are there:
a model is a driver with its reference, a layer is a row of PERF.md's
table of layers."""
import json
import re

import pytest
import torch

from portbench import harness

torch.set_num_threads(1)

SPEC = harness.load_spec()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
CELLS = [w["name"] for w in SPEC["workloads"]]
MODELS = ({p.stem for p in (harness.PKG / "drivers").glob("[!_]*.py")}
          & {p.stem for p in (harness.PKG / "reference").glob("[!_]*.py")})


def _layers() -> set:
    """The first column of the table under PERF.md's heading of layers."""
    text = (harness.ROOT / "PERF.md").read_text(encoding="utf-8")
    section = re.split(r"\n## ", text.split("## 3. Layers", 1)[1])[0]
    rows = [line.split("|")[1].strip() for line in section.splitlines()
            if line.startswith("|")]
    return {r for r in rows[2:] if r}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in metrics])
    assert len(set(names)) == len(names)
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.fullmatch(name), name
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["layer"] in _layers()


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    e2e = {m["name"] for m in harness.metric_entries(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metric_entries(SPEC, cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("cell", CELLS)
def test_the_harness_finds_config_mix_and_limits_by_name(cell):
    found = harness.find_cell(SPEC, cell)
    assert found.config["model"] in MODELS
    assert found.kind in ("fit", "predict")
    assert found.limits and all(v >= 0 for v in found.limits.values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_the_harness_finds_each_metric_by_name(metric):
    assert callable(harness._load_metric(metric).read)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(SPEC, "no.such.cell")
