"""Test configuration of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``cuda`` marker, and small runs of the cells on the
CPU (every width cut to 64 and one layer each side, the traffic to a few
rows), through the same harness the card runs."""

from __future__ import annotations

import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the traffic's sizes cut for the CPU
SMALL_TRAFFIC = dict(batch=2, sample_len=4, check_rows=2, feature_rows=1, clients=3, slots=2,
                     admit_width=2, clips=4, warmup_requests=2, check_requests=2,
                     pool_batches=3, check_steps=2, reference_rows=1, trace_steps=1)
SMALL_MODEL = dict(d_model=64, encoder_attention_heads=2, decoder_attention_heads=2,
                   encoder_layers=1, decoder_layers=1, encoder_ffn_dim=256, decoder_ffn_dim=256)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def small_run(cell_name: str, seed: int = 2 ** 31 + 7, seconds: float = 0.5):
    """A ``portbench.run.Run`` of ``cell_name`` (in ``BENCHMARK.json`` or
    ``portbench/cells/``) on the CPU at the small size."""
    from portbench import run as R

    bench = R.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name), None)
    if cell is None:  # a cell held out of BENCHMARK.json
        cell = R.load_json(os.path.join(ROOT, "portbench", "cells", cell_name + ".json"))
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = dict(R.load_json(os.path.join(ROOT, entry["file"])), **SMALL_MODEL)
    run = R.Run(bench, cell, seed, seconds, False, device="cpu", config=config, root=ROOT)
    for k, v in SMALL_TRAFFIC.items():
        if k in run.traffic:
            run.traffic[k] = v
    return run


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
