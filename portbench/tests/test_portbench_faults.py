"""The check comes out not correct when the timed path is broken underneath
(the harness's look for a card skipped, the rest of a run driven on the CPU
at the small size), once for each fault in ``portbench.faults`` that the
cell's driver can have: a step that returns its state unchanged, half of
the batch left out, a token altered where it is produced, rows or slots
mixed up, admission's frontend output displaced in time.  No cell spans chips, so
no exchange between chips can be left out."""

import pytest

from portbench import faults
from portbench import run as R

from .conftest import small_run

SIZES = {"batch": dict(feature_rows=2, check_rows=4, batch=2),
         "engine": dict(feature_clips=4), "train": dict(batch=4)}
CASES = [(cell, f) for cell, driver in (("large-v3.batch-b128", "batch"),
                                        ("large-v3.clips-b128", "batch"),
                                        ("medium.engine-c512", "engine"),
                                        ("medium.train-b16", "train"))
         for f in faults.BY_DRIVER[driver]]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    run = small_run(cell)
    run.traffic.update(SIZES[run.traffic["driver"]])
    fault(monkeypatch.setattr)
    result = R.execute(run)
    assert result["correct"] is False, result["checks"]
