"""The control: the reference in float8 put in the program's place.  On the
card, at each cell's own size, it must come out not correct against the
cell's limits; on the CPU at the small size it must read far above the
program."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run as R
from portbench.reference.whisper import Precision

from .conftest import ROOT, small_run

CELLS = [w["name"] for w in R.load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program_small(cell):
    """The control's numbers are the ones judged; the program's, read in
    the same run, stay within the limits."""
    run = small_run(cell)
    run.control = Precision("fp8")
    checks = R.execute(run)["checks"]
    control, program = run.window["control"], run.window["program"]
    assert {k: c["value"] for k, c in checks.items()} == control
    assert all(program[k] <= v for k, v in run.limits.items()), program
    worse = [k for k in run.limits if control[k] > 3 * program[k]]
    assert worse, (control, program)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits_on_the_card(cell, card):
    """One short run of the cell at its own size with the control read
    beside the program (``portbench.calibrate``)."""
    seed = 2 ** 31 + 101
    out = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload", cell,
                          "--seconds", "3", "--seeds", str(seed), "--control", str(seed)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = R.load_json(os.path.join(ROOT, "portbench", "limits", cell + ".json"))
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert line["correct"] is False, line
