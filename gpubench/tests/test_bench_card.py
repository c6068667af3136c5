"""On the card (marked ``cuda``): each cell's control, the plain reference
computed in TF32 in the program's place, fails the cell's check at the
cell's own sizes, on three seeds.  Without a card every test skips.

    python -m pytest gpubench/tests/test_bench_card.py -q
"""

import pytest

from gpubench import cells
from gpubench.trace import Tracer

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
SEEDS = (3_400_000_001, 3_400_000_002, 3_400_000_003)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(card, name):
    cell = cells.load_cell(name)
    for seed in SEEDS:
        run = cells.traffic_module(cell.mix["kind"]).Run(cell, seed, card, 4.0)
        run.setup()
        if cell.mix["kind"] == "open_loop_serve":
            run.window(4.0, Tracer(None))
        run.free()
        out = run.check(control=True)
        assert all(v <= cell.limits[k] for k, v in out["program"].items()), out
        assert any(v > cell.limits[k] for k, v in out["control"].items()), out
