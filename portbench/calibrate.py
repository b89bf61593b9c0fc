"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m portbench.calibrate --workload CELL --seeds 11,12,13 \
        [--control 11,12,13] [--fault NAME] [--seconds S]

For each seed, one run of the cell (set-up, a window of ``--seconds``, the
release and the reference's comparison) in this one process, judged against
the cell's limits, and one JSON line: ``correct``, the numbers judged
(``numbers``), the program's (``program``) and, for the seeds in
``--control``, the control's (``control``).  The control is the reference
put in the program's place with its whole compute dtype lowered to float8
e4m3 (``reference.whisper.Precision("fp8")``: the weights and activations
of every product, its output, the residual stream, LayerNorm, GELU and
softmax); on those seeds its numbers are the ones judged, so ``correct``
is the control's.  A training cell's control seeds also read the
reference's steps over half of each batch (``half_batch``).  ``--fault``
plants one of ``portbench.faults`` under the timed path for every seed.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import faults
from . import run as R
from .reference.whisper import Precision


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    bench = R.load_json("BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if args.fault:
        getattr(faults, args.fault)(setattr)
    control = {int(s) for s in args.control.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = R.Run(bench, cell, seed, args.seconds, False)
        if seed in control:
            run.control = Precision("fp8")
        t0 = time.time()
        result = R.execute(run, t_start=t0)
        if result is None:
            return 4
        line = {"workload": args.workload, "seed": seed, "fault": args.fault or None,
                "correct": result["correct"],
                "numbers": {k: c["value"] for k, c in result["checks"].items()},
                "attempted": result["attempted"], "failed": result["failed"],
                "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                "seconds": time.time() - t0}
        for key in ("program", "control", "half_batch", "checked"):
            if key in run.window:
                line[key] = run.window[key]
        print(json.dumps(line, default=str), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
