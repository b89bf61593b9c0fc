"""The readers of the program's spans on a small batch on the CPU: each
new metric of a batch cell reads the recorder of a traced batch, and reads
nothing where the recorder holds no spans (as under a program without
them)."""

import pytest

from portbench import run as R
from portbench.drivers import batch
from qasr_ijcnlp_tpu_torch import profiling

from .conftest import small_run

SPAN_METRICS = ["frontend.host_ms_per_batch", "request.assemble_ms_per_batch"]


@pytest.mark.parametrize("cell", ["large-v3.batch-b128", "large-v3.clips-b128"])
def test_span_readers(cell):
    run = small_run(cell)
    names = [m["name"] for m in R.metrics_of(run.bench, cell, "per_layer")
             if m["name"].split(".clips")[0] in SPAN_METRICS]
    assert len(names) == 2
    state = batch.State(run)
    with profiling.recording() as rec:
        state.batch(0)
    spans = rec.summary()
    assert spans["frontend"]["calls"] == spans["request"]["calls"] == 1
    values = {n: R.read_metric(n, run) for n in names}
    assert all(v > 0 for v in values.values()), values
    front = next(v for n, v in values.items() if n.startswith("frontend."))
    assert front == pytest.approx(spans["frontend.pad"]["total_ms"]
                                  + spans["frontend"]["total_ms"])
    rec.clear()
    assert all(R.read_metric(n, run) is None for n in names)
