"""Whole runs on the CPU at a tiny size: the harness's look for a card is
skipped and the rest of a run is driven (set-up, window, check).  A sound
run comes out correct; with each fault the cell can have planted under it
(``faults.py``), correct comes out false."""

import json

import pytest
import torch

from gpubench import cells, faults, run

#: tiny sizes of each cell on the CPU, beside the cell's own mix
TINY = {
    "dcnn-wpt-train": ({"batch": 4, "batches": 4, "norm_batches": 2}, {}),
    "ast-stft-train": ({"batch": 2, "batches": 4, "norm_batches": 2},
                       {"model_size": "tiny224"}),
    "dcnn-wpt-serve": ({"rate_frames_per_s": 6, "batch_size": 8, "pool_frames": 64,
                        "norm_frames": 16, "sample_clips": 4, "max_s": 8}, {}),
    "ast-stft-serve": ({"rate_frames_per_s": 6, "batch_size": 8, "pool_frames": 64,
                        "norm_frames": 16, "sample_clips": 4, "max_s": 8},
                       {"model_size": "tiny224"}),
}
CASES = [(c, None) for c in TINY] + [
    (c, f) for c in TINY
    for f in (faults.SERVE if cells.load_cell(c).mix["kind"] == "open_loop_serve"
              else faults.TRAIN)]


def tiny(name):
    cell = cells.load_cell(name)
    mix, model = TINY[name]
    cell.mix = {**cell.mix, **mix}
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["model"].update(model)
    return cell


@pytest.mark.parametrize("name,fault", CASES, ids=lambda x: str(x))
def test_run_correct_unless_a_fault_is_planted(name, fault):
    torch.manual_seed(0)
    cell = tiny(name)
    serve = cell.mix["kind"] == "open_loop_serve"
    if fault is None:
        line = run.measure(cell, 2**31 + 21, 2.0, False, "cpu")
        assert line["correct"], line["checks"]
        assert line["failed"] == 0 and line["attempted"] > 0
        assert {m["name"] for m in cell.end_to_end} == set(line["metrics"])
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        with faults.planted(fault, serve):
            line = run.measure(cell, 2**31 + 21, 2.0, False, "cpu")
        assert not line["correct"], line["checks"]
