"""A cell's files, found by the names ``BENCHMARK.json`` gives.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
harness reads, by those names alone:

* ``configs/<config>.json``: the configuration as it is run;
* ``program/<config>.py``: builds the port's model for it (``build``);
* ``reference/<config>.py``: its plain PyTorch reference;
* ``traffic/<mix>.json``: the mix's parameters, whose ``kind`` names the
  generator ``traffic/<kind>.py``;
* ``workloads/<cell>.json``: the limits of the cell's correctness check;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``work/<kernel>.py``: a kernel's operations and bytes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """Import the file ``path`` (its name may hold ``-`` and ``.``) as a
    module of its own, once per process."""
    path = Path(path)
    rel = path.resolve().relative_to(BENCH_DIR).with_suffix("")
    name = "gpubench._by_name." + re.sub(r"[^0-9A-Za-z_]", "_", str(rel))
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def config(name: str) -> dict:
    return read_json(BENCH_DIR / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return read_json(BENCH_DIR / "traffic" / f"{name}.json")


def traffic_module(kind: str) -> ModuleType:
    return load_module(BENCH_DIR / "traffic" / f"{kind}.py")


def program_module(config_name: str) -> ModuleType:
    return load_module(BENCH_DIR / "program" / f"{config_name}.py")


def reference_module(config_name: str) -> ModuleType:
    return load_module(BENCH_DIR / "reference" / f"{config_name}.py")


def metric_reader(metric: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py")


def work_module(kernel: str) -> ModuleType:
    return load_module(BENCH_DIR / "work" / f"{kernel}.py")


def data(name: str) -> dict:
    """A data file of the yardstick (``peaks``, ``kernel_groups``)."""
    return read_json(BENCH_DIR / f"{name}.json")


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _lists(metric: dict, cell: str) -> Optional[bool]:
    """Whether ``metric``'s ``workloads`` key names ``cell`` (None: no key)."""
    cells = metric.get("workloads")
    return None if cells is None else cell in cells


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``) with every file
    it names read."""
    bench = benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    entry = entries[0]
    e2e = [m for m in bench["end_to_end"] if _lists(m, name) is not False]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if _lists(m, name) or (_lists(m, name) is None and m["moves"] in reported)]
    return Cell(
        name=name,
        config=config(entry["config"]),
        mix=mix(entry["traffic"]),
        chips=int(entry["chips"]),
        limits=read_json(BENCH_DIR / "workloads" / f"{name}.json")["limits"],
        end_to_end=e2e,
        per_layer=layers,
    )
