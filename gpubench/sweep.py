"""Find a serving cell's knee: the open loop at a list of fixed rates.

    python3 gpubench/sweep.py --workload <serve cell> --rates 2000,3000,... \\
        [--seconds 10] [--seed 1]

One set-up, then one window a rate, each with the cell's mix at that
``rate_frames_per_s``; one JSON line a rate: offered and served frames/s,
p50 / p95 latency, dispatches, how late the generator ran.  The knee is
the highest rate served in full with no backlog (p95 flat against the
rates below); a cell's mix takes four fifths of it, written into
``traffic/<mix>.json`` as a number.  The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])  # the checkout, not this folder

from gpubench import cells, inputs  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)

    import torch

    from gpubench.trace import Tracer

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load_cell(args.workload)
    run = cells.traffic_module(cell.mix["kind"]).Run(cell, args.seed, "cuda", args.seconds)
    run.setup()
    for rate in [float(r) for r in args.rates.split(",")]:
        run.mix = dict(cell.mix, rate_frames_per_s=rate)
        run.due, run.lengths, run.start = inputs.open_loop_schedule(
            run.mix, args.seed, args.seconds, int(cell.mix["pool_frames"]))
        out = run.window(args.seconds, Tracer(None))
        print(json.dumps({"cell": cell.name, "offered_frames_per_s": rate, **out["metrics"],
                          "failed": out["failed"], **out["notes"]}, default=float), flush=True)
    run.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
