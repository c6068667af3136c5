"""Every cell's files are found by name, and BENCHMARK.json keeps to the
benchmark's contract."""

import json
import re

import pytest

from gpubench import cells

BENCH = cells.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
NUMBERS = {"resident_train": {"loss_gap", "grad_gap", "update_gap"},
           "open_loop_serve": {"score_gap", "clip_gap", "missing"}}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = cells.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == entry["config"]
    for module in (cells.program_module(entry["config"]), cells.reference_module(entry["config"])):
        assert module.__file__
    kind = cells.traffic_module(cell.mix["kind"])
    assert hasattr(kind, "Run")
    assert set(cell.limits) == NUMBERS[cell.mix["kind"]]
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]).read)


def test_metrics_name_known_cells_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[key]}) == len(BENCH[key])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
        assert cells.config(c["name"])["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"micro-batcher", "scorer", "train step", "transform", "model",
                      "kernels", "device"}
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["layer"] == "kernels"
            assert callable(cells.work_module(m["name"][: -len("_roofline")]).work)
