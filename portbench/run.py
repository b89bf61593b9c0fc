"""The benchmark of qasr_ijcnlp_tpu_torch on NVIDIA GPUs.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell's entry in ``BENCHMARK.json`` names
its configuration (a file under ``portbench/configs/``) and its traffic mix
(``portbench/traffic/<traffic>.json``), and the mix names its driver
(``portbench/drivers/<driver>.py``).  The driver builds the model and the
inputs from the seed on the card and warms the cell's shapes (set-up), runs
the measured window, and afterwards hands the outputs of the window to the
plain reference (``portbench/reference/``), whose comparison against the
cell's limits (``portbench/limits/<cell>.json``) decides ``correct``.  With
``--trace 1`` the window is followed by a profiled stretch and the cell's
per-layer metrics are read by their readers (``portbench/metrics/<metric>.py``).

The last line of standard output is the result as one JSON object; the
numbers compared are the last lines of standard error.  Without a card, or
with fewer than the cell asks for, it exits with 3 and prints no result; if
JAX or the JAX package was loaded, with 4.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "qasr_ijcnlp_tpu")


def process_start() -> float:
    """The process's start on the ``time.time`` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


class Run:
    """What the driver and the metric readers see of a run.  ``config``
    overrides the configuration's file (the tests' small models)."""

    def __init__(self, bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", config: dict = None, root: str = None):
        root = root or os.getcwd()
        self.bench = bench
        self.cell = cell
        self.name = cell["name"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
        self.config = config or load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "limits", self.name + ".json"))
        from .weights import dims_of

        self.dims = dims_of(self.config)
        # filled as the run goes
        self.window: dict = {}
        self.profile: dict = {}
        self.inputs = None
        self.features: dict = {}
        # the calibration's control (a reference.whisper.Precision), else None
        self.control = None
        self.marks = []  # (stage of set-up, seconds since the process started)

    def mark(self, stage: str):
        self.marks.append((stage, round(time.time() - T_START, 3)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def metrics_of(bench: dict, cell: str, section: str, reported=None):
    """The entries of ``section`` that the cell reports: those that list it,
    and those without a list (end to end: every cell; per layer: every cell
    that reports the metric it moves)."""
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m["moves"] in reported:
            out.append(m)
    return out


def reader_path(name: str) -> str:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, else
    the reader of the name less its last dotted part (``mfu.train`` is read
    by ``metrics/mfu.py``), so that one quantity split by the end-to-end
    metric it moves has one reader."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(HERE, "metrics", ".".join(parts[:n]) + ".py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for the metric {name} under {HERE}/metrics")


def read_metric(name: str, run: Run):
    """The value of per-layer metric ``name`` from its reader, or None."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def host_probe_ms() -> float:
    """Milliseconds of a fixed loop of Python on the host, read once the
    program's threads have stopped: how fast the host ran this run, beside
    the rates of host-paced cells (printed, not a metric)."""
    t0 = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i * i
    return (time.perf_counter() - t0) * 1e3


def execute(run: Run, t_start: float = None):
    """Set-up, window, traced stretch, release and check of one run; returns
    the result object, or None where JAX or the JAX package was loaded (the
    look comes after the window and the check, so it sees what both
    loaded)."""
    import torch

    from .port import sync

    driver = importlib.import_module(f"portbench.drivers.{run.traffic['driver']}")
    on_card = torch.device(run.device).type == "cuda"
    run.mark("imported")
    state = driver.setup(run)
    sync(run.device)
    run.mark("set up")
    setup_s = time.time() - (T_START if t_start is None else t_start)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    run.window = driver.window(state, run)
    if run.trace:
        run.profile = driver.profiled(state, run)
    sync(run.device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release(state)
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    run.window["host_probe_ms"] = host_probe_ms()
    checks = driver.check(run)

    bench, cell = run.bench, run.cell
    e2e = metrics_of(bench, run.name, "end_to_end")
    metrics = {}
    if run.trace:
        for m in metrics_of(bench, run.name, "per_layer", {x["name"] for x in e2e}):
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.window["e2e"], setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(run.window["failed"] == 0 and all(
                  c["value"] <= c["limit"] for c in checks.values())),
              "attempted": run.window["attempted"], "failed": run.window["failed"],
              "metrics": metrics, "device": device}
    trace = run.profile.get("trace") if run.trace else None
    if trace is not None:
        from .trace import breakdown

        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = breakdown(trace)
    elif run.trace:
        print("the profiler's trace shows no device time: trace-based metrics not measured",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return None
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(os.path.join(os.getcwd(), "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload} in BENCHMARK.json", file=sys.stderr)
        return 2
    # Every build and kernel cache inside the checkout, at fixed paths.
    cache = os.path.join(os.getcwd(), ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    run = Run(bench, cell, args.seed, args.seconds, bool(args.trace))
    result = execute(run)
    if result is None:
        return 4
    print(f"set-up stages (s since start): {run.marks}", file=sys.stderr)
    print("window: " + json.dumps({k: v for k, v in run.window.items()
                                   if isinstance(v, (int, float)) or k == "batch_ends_s"}),
          file=sys.stderr)
    if "checked" in run.window:
        print(f"checked: {json.dumps(run.window['checked'], default=str)[:2000]}",
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
