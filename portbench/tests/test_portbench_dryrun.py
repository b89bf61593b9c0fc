"""Each cell's whole run on the CPU at the small size: the harness, the
driver, the release and the reference's check, and what the process loads."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run as R

from .conftest import ROOT, small_run

# the cells of BENCHMARK.json, then those held out of it (portbench/cells/)
CELLS = [w["name"] for w in R.load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]] + \
    sorted(f[:-len(".json")] for f in os.listdir(os.path.join(ROOT, "portbench", "cells")))


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_is_correct(cell):
    run = small_run(cell)
    result = R.execute(run)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(run.limits)
    reported = {m["name"] for m in R.metrics_of(run.bench, cell, "end_to_end")}
    assert set(result["metrics"]) == reported
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"


def test_runs_load_neither_jax_nor_the_jax_package():
    """A fresh process runs every cell small and lists the top-level names of
    every module it loaded, compared whole (the port's name begins with the
    JAX package's)."""
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import run as R\n"
        "from portbench.tests.conftest import small_run\n"
        f"for cell in {CELLS!r}:\n"
        "    assert R.execute(small_run(cell)) is not None\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "qasr_ijcnlp_tpu_torch" in names and "portbench" in names
    assert not names & set(R.FORBIDDEN)


def test_without_a_card_it_exits_with_no_result(tmp_path):
    """The command itself, on this CPU-only machine: exit 3, no result."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert out.returncode == 3 and out.stdout.strip() == ""


def test_in_a_directory_of_only_the_benchmark_it_exits_with_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
