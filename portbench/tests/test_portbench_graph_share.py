"""The reader of the decode loop's graph-replay share on a small batch on the
CPU: it reads the recorder's ``decode.graph_steps`` over
``decode.token_steps`` of a traced batch, 0.0 where no step was replayed (as
on the CPU, or under a program without the graph), and nothing where no token
step was counted."""

import pytest

from portbench import run as R
from portbench.drivers import batch
from qasr_ijcnlp_tpu_torch import profiling

from .conftest import small_run


@pytest.mark.parametrize("cell", ["large-v3.batch-b128", "large-v3.clips-b128"])
def test_graph_step_share_reader(cell):
    run = small_run(cell)
    names = [m["name"] for m in R.metrics_of(run.bench, cell, "per_layer")
             if m["name"].startswith("decode.graph_step_share")]
    assert len(names) == 1
    state = batch.State(run)
    with profiling.recording() as rec:
        state.batch(0)
    assert rec.counters["decode.token_steps"] > 0
    assert R.read_metric(names[0], run) == 0.0
    rec.counters["decode.graph_steps"] = rec.counters["decode.token_steps"]
    assert R.read_metric(names[0], run) == 1.0
    rec.counters["decode.graph_steps"] //= 2
    assert 0.0 < R.read_metric(names[0], run) < 1.0
    rec.clear()
    assert R.read_metric(names[0], run) is None
