"""Readings for a cell's correctness limits, on the card, in one process.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault unchanged|half_batch|altered] [--seconds 5]

For each seed: the cell's set-up at its own sizes (a serving cell also a
short window at its own load, to have answers to check), then the check:
one JSON line a seed with the program's numbers and, on the control seeds,
the control's (the reference computed in TF32, in the program's place).
With ``--fault`` the program runs with that fault planted
(``faults.py``).  The limits in ``workloads/<cell>.json`` are set from
these readings (``PERF.md``).  The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])  # the checkout, not this folder

from gpubench import cells, faults  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)

    import torch

    from gpubench.trace import Tracer

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load_cell(args.workload)
    serve = cell.mix["kind"] == "open_loop_serve"
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds + sorted(control - set(seeds)):
        with faults.planted(args.fault, serve) if args.fault else contextlib.nullcontext():
            run = cells.traffic_module(cell.mix["kind"]).Run(cell, seed, "cuda", args.seconds)
            run.setup()
            if serve:
                run.window(args.seconds, Tracer(None))
        run.free()
        out = run.check(control=seed in control)
        print(json.dumps({"cell": cell.name, "seed": seed, "fault": args.fault, **out}),
              flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
