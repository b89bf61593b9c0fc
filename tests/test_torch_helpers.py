"""The port's helpers: ``profiling`` (spans, counters, the recorder, the
trace and the device work laid under the spans), ``python -m
qasr_ijcnlp_tpu_torch`` and the native BPE merge core (``native/bpe.cpp``
through ``_native.bpe_handle``), whose ids must equal the pure-Python
merge's and the JAX tokenizer's."""

import itertools
import json
import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu.tokenizer import bpe as jbpe
from qasr_ijcnlp_tpu_torch import _native, profiling
from qasr_ijcnlp_tpu_torch.tokenizer import bpe
from tests.torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parents(rec):
    """{span name: its parent's name} of a recording (one span a name)."""
    by_id = {s.id: s for s in rec.spans}
    return {s.name: by_id[s.parent].name if s.parent else None for s in rec.spans}


def test_span_nesting_ids_and_self_time(monkeypatch):
    """Parents, roots (the request id) and self time, on a clock that
    ticks 1 ms a reading."""
    ticks = itertools.count(0, 1_000_000)
    monkeypatch.setattr(profiling.time, "time_ns", lambda: next(ticks))
    with profiling.recording() as rec:
        with profiling.span("request"):          # ms 0 .. 7
            with profiling.span("encoder"):      # 1 .. 2
                pass
            with profiling.span("decode.loop"):  # 3 .. 6
                with profiling.span("inner"):    # 4 .. 5
                    pass
        with profiling.span("request"):          # 8 .. 9
            pass
    enc, inner, loop, req, again = rec.spans
    assert [s.name for s in rec.spans] == ["encoder", "inner", "decode.loop", "request",
                                           "request"]
    assert req.parent is None and req.root == req.id
    assert enc.parent == loop.parent == req.id and inner.parent == loop.id
    assert {enc.root, loop.root, inner.root} == {req.id}
    assert again.parent is None and again.root == again.id != req.id
    assert (req.start_ns, req.end_ns, inner.start_ns, inner.end_ns) == (0, 7e6, 4e6, 5e6)
    s = rec.summary()
    assert s["request"] == {"calls": 2, "total_ms": 8.0, "self_ms": 7 - 1 - 3 + 1.0,
                            "mean_ms": 4.0}
    assert s["decode.loop"]["self_ms"] == 2 and s["inner"]["self_ms"] == 1
    assert not rec.counters


def test_parent_chain_is_per_thread():
    """A span opened on another thread while the main thread's is open
    starts a tree of its own; counts from more threads than cores, switching
    often, all land."""
    done = []
    n = (os.cpu_count() or 1) + 2

    def work():
        with profiling.span("worker"):
            with profiling.span("worker.inner"):
                for _ in range(1000):
                    profiling.count("steps")
                done.append(True)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            with profiling.span("request"):
                threads = [threading.Thread(target=work) for _ in range(n)]
                for t in threads:
                    t.start()
                for _ in range(1000):
                    profiling.count("steps")
                for t in threads:
                    t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(done) == n
    assert rec.counters == {"steps": 1000 * (n + 1)}
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        want = {"request": None, "worker": None, "worker.inner": "worker"}[s.name]
        assert (by_id[s.parent].name if s.parent else None) == want
        assert s.root == (s.id if s.parent is None else by_id[s.parent].root)


def test_recording_off_touches_no_clock_and_no_recorder(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("touched while recording is off")

    monkeypatch.setattr(profiling.time, "time_ns", boom)
    monkeypatch.setattr(profiling.torch.profiler, "record_function", boom)
    monkeypatch.setattr(profiling.torch.cuda.nvtx, "range_push", boom)
    monkeypatch.setattr(profiling.RECORDER, "add", boom)
    before = list(profiling.RECORDER.spans)
    a, b = profiling.span("request"), profiling.span("encoder")
    assert a is b  # one shared null context
    with a:
        with b:
            profiling.count("decode.token_steps", 3)
    assert profiling.RECORDER.spans == before


def test_spans_inside_a_traced_program_are_null(monkeypatch):
    """Code that ``torch.export`` or ``torch.compile`` traces records no
    span, recording or not."""
    monkeypatch.setattr(profiling.torch.compiler, "is_compiling", lambda: True)
    with profiling.recording() as rec:
        assert profiling.span("frontend") is profiling.span("encoder")
        with profiling.span("frontend"):
            pass
    assert rec.spans == []


@pytest.mark.parametrize("inside_recording", [True, False])
def test_spans_line_up_with_the_profilers_annotations(inside_recording, tmp_path):
    """Under ``torch.profiler`` each recorder span matches the trace's
    ``user_annotation`` of the same name to 1 ms, through
    ``baseTimeNanoseconds``; a running profiler alone records too."""
    from torch.profiler import ProfilerActivity, profile

    profiling.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() if inside_recording else profiling.span("outer"):
            for i in range(3):
                with profiling.span(f"region{i}"):
                    torch.ones(128, 128) @ torch.ones(128, 128)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    base_us = chrome["baseTimeNanoseconds"] / 1e3
    notes = {e["name"]: e for e in chrome["traceEvents"] if e.get("cat") == "user_annotation"}
    spans = profiling.RECORDER.spans
    assert {s.name for s in spans} >= {"region0", "region1", "region2"}
    for s in spans:
        e = notes[s.name]
        assert abs(e["ts"] + base_us - s.start_ns / 1e3) < 1e3
        assert abs(e["ts"] + e["dur"] + base_us - s.end_ns / 1e3) < 1e3


def test_attribute_by_correlation_two_threads_nested():
    """Device ops go to the innermost span holding their launch, matched by
    correlation id on any thread, and count for its ancestors; windows
    stretch to the last op; idle is the window the device leaves empty."""
    base = 10**18
    S = profiling.Span

    def span(i, name, a, b, parent=None, root=None):  # a, b in µs of the trace
        return S(i, name, base + a * 1000, base + b * 1000, parent, root or i)

    spans = [span(1, "train.step", 0, 100), span(2, "train.forward", 5, 30, 1, 1),
             span(3, "train.backward", 30, 80, 1, 1), span(4, "train.update", 80, 95, 1, 1),
             span(5, "other", 200, 210)]

    def launch(corr, ts, tid):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1, "tid": tid, "args": {"correlation": corr}}

    def op(corr, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
                "tid": 7, "args": {"correlation": corr}}

    events = [launch(1, 6, 1), op(1, 10, 10),             # forward
              launch(2, 40, 2), op(2, 40, 5),             # backward, autograd's thread
              launch(3, 50, 2), op(3, 60, 10, "gpu_memcpy"),
              launch(4, 85, 1), op(4, 120, 30),           # update, runs past the span
              launch(5, 98, 1), op(5, 150, 2),            # step's own, after update
              launch(6, 300, 1), op(6, 300, 4),           # under no span
              op(7, 0, 3),                                # no launch in the trace
              {"ph": "X", "cat": "user_annotation", "name": "train.step", "ts": 0,
               "dur": 100, "args": {}}]
    got = profiling.attribute({"traceEvents": events, "baseTimeNanoseconds": base}, spans)
    fw, bw, up, st = (got[n] for n in ("train.forward", "train.backward", "train.update",
                                       "train.step"))
    assert (fw["device_s"], fw["launches"]) == (pytest.approx(10e-6), 1)
    assert (bw["device_s"], bw["launches"]) == (pytest.approx(15e-6), 1)  # a copy is no launch
    assert (up["device_s"], up["launches"]) == (pytest.approx(30e-6), 1)
    assert (st["device_s"], st["launches"]) == (pytest.approx(57e-6), 4)
    assert got["other"]["device_s"] == 0 and got["other"]["launches"] == 0
    # windows: update to its op's end (150), the step to 152
    assert up["window_s"] == pytest.approx(70e-6) and st["window_s"] == pytest.approx(152e-6)
    # busy: 0-3, 10-20, 40-45, 60-70, 120-152 (merged), 300-304
    assert st["idle_s"] == pytest.approx((152 - (3 + 10 + 5 + 10 + 32)) * 1e-6)
    assert up["idle_s"] == pytest.approx((70 - 30) * 1e-6)
    assert fw["idle_s"] == pytest.approx(15e-6) and got["other"]["idle_s"] == pytest.approx(10e-6)
    assert st["host_s"] == pytest.approx(100e-6) and st["self_host_s"] == pytest.approx(10e-6)
    assert st["calls"] == 1


def _small_model():
    from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions
    from qasr_ijcnlp_tpu_torch.models.registry import WhisperModel
    from qasr_ijcnlp_tpu_torch.models.whisper import init_params

    dims = ModelDimensions(80, 500, 128, 2, 1, 51865, 48, 128, 2, 1)
    return WhisperModel.from_state_dict(init_params(torch.Generator().manual_seed(0), dims),
                                        dims, "cpu")


@pytest.mark.parametrize("beam_size", [None, 2])
def test_decode_records_the_span_tree(beam_size, monkeypatch):
    """A small decode on the CPU: the table's spans under one request, and
    ``decode.token_steps`` equal to the loop's step calls."""
    import qasr_ijcnlp_tpu_torch as port
    from qasr_ijcnlp_tpu_torch.models import whisper

    m = _small_model()
    calls = []
    step = whisper.decoder_step
    monkeypatch.setattr(whisper, "decoder_step",
                        lambda *a, **k: calls.append(1) or step(*a, **k))
    pcm = np.random.default_rng(0).standard_normal(8000).astype(np.float32) * 0.1
    with profiling.recording() as rec:
        mel = port.log_mel_spectrogram(port.pad_or_trim(pcm, 1000 * 160), device="cpu")
        port.decode(m, mel[None].repeat(2, 1, 1), port.DecodingOptions(
            language="en", sample_len=6, without_timestamps=True, beam_size=beam_size))
    assert _parents(rec) == {
        "frontend.pad": None, "frontend": None, "frontend.upload": "frontend",
        "encoder": "request",
        "decode.prompt": "request", "decode.loop": "request", "decode.fetch": "request",
        "request.assemble": "request", "request": None}
    assert [s.name for s in rec.spans].count("request") == 1
    assert rec.counters == {"decode.token_steps": len(calls) - 1} and len(calls) > 2


def test_frontend_upload_is_a_child_of_the_frontend():
    """``frontend.upload`` times the copy to the device named by the call."""
    import qasr_ijcnlp_tpu_torch as port

    with profiling.recording() as rec:
        port.log_mel_spectrogram(np.zeros(16000, np.float32), device="cpu")
        port.log_mel_spectrogram(torch.zeros(16000), device=None)
    assert [s.name for s in rec.spans] == ["frontend.upload", "frontend", "frontend"]
    assert rec.spans[0].parent == rec.spans[1].id


@pytest.mark.parametrize("accum", [None, 2])
def test_train_step_records_its_three_phases(accum):
    from qasr_ijcnlp_tpu_torch import train
    from qasr_ijcnlp_tpu_torch.train import step as tstep

    lin = torch.nn.Linear(4, 3)
    tx = train.make_optimizer(1e-2)
    state = train.init_state(lin, tx)
    if accum is None:
        fn = tstep.make_train_step(lambda p, x: (p(x) ** 2).mean(), tx)
    else:
        fn = tstep.make_accum_train_step(
            lambda p, x: ((p(x) ** 2).sum(), torch.tensor(float(x.numel()))), tx, accum)
    with profiling.recording() as rec:
        state, met = fn(state, torch.ones(4, 4))
        state, met = fn(state, torch.ones(4, 4))
    assert int(state.step) == 2 and torch.isfinite(met["loss"])
    by_id = {s.id: s for s in rec.spans}
    steps = [s for s in rec.spans if s.name == "train.step"]
    assert len(steps) == 2 and all(s.parent is None for s in steps)
    for st in steps:
        kids = [s.name for s in rec.spans if s.parent == st.id]
        n = accum or 1
        assert kids == ["train.forward", "train.backward"] * n + ["train.update"]
    assert all(by_id[s.parent].name == "train.step" for s in rec.spans if s.parent)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as d:
        with profiling.span("qasr-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            profiling.count("qasr-count", 2)
    files = sorted(os.listdir(d))
    assert len(files) == 2 and files[0].startswith("spans_") and files[1].startswith("trace_")
    with open(os.path.join(d, files[1])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "qasr-region" for e in events)
    with open(os.path.join(d, files[0])) as f:
        spans = json.load(f)
    assert [s["name"] for s in spans["spans"]] == ["qasr-region"]
    assert spans["counters"] == {"qasr-count": 2}
    region = spans["by_name"]["qasr-region"]
    assert region["calls"] == 1 and region["host_s"] > 0 and region["launches"] == 0


def test_module_entry_is_the_transcribe_cli():
    """``python -m qasr_ijcnlp_tpu_torch --help`` prints the transcribe
    CLI's usage, in a process that can import neither JAX nor the JAX
    package."""
    code = ("import runpy, sys\n"
            "for b in ('jax', 'optax', 'qasr_ijcnlp_tpu'):\n"
            "    sys.modules[b] = None\n"
            "sys.argv = ['qasr_ijcnlp_tpu_torch', '--help']\n"
            "runpy.run_module('qasr_ijcnlp_tpu_torch', run_name='__main__', alter_sys=True)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--model" in out.stdout and "--output_format" in out.stdout


def _texts():
    """English, numbers and punctuation, accented and non-Latin scripts,
    and a 200-character word of random CJK characters."""
    rng = random.Random(0)
    cjk = "".join(chr(rng.randrange(0x4E00, 0x9FFF)) for _ in range(200))
    return [
        "Hello world, this is a test of the byte-pair encoder!",
        " The quick brown fox jumps over the lazy dog 1234567890 times.",
        "Mr. O'Neil's café — naïve coöperation, ¿qué tal? Ça va.",
        "Привет, мир! Γειά σου Κόσμε. こんにちは世界。 안녕하세요 세계",
        "I'm    spacing\tout\n\nnewlines  and   'quotes' \"double\" ...!!!",
        "supercalifragilisticexpialidocious antidisestablishmentarianism",
        cjk,
    ]


@pytest.mark.parametrize("name", ["gpt2", "multilingual"])
def test_native_bpe_equals_python_and_jax(name):
    enc = bpe.get_encoding(name)
    assert isinstance(enc._native, _native._BPEHandle)
    jenc = jbpe.get_encoding(name)
    py = bpe.Encoding(enc.name, enc.pat_str, enc.ranks, enc.special_tokens)
    py._native = None
    for text in _texts():
        ids = enc.encode(text)
        assert ids == py.encode(text) == jenc.encode(text)
        assert enc.decode(ids) == text


def test_native_bpe_overflow_falls_back_to_python():
    """A piece with more ids than the native output buffer holds is merged
    in Python (a handle with an 8-id buffer stands in for a long piece)."""
    enc = bpe.get_encoding("multilingual")
    handle = _native.bpe_handle()
    handle.CAPACITY = 8
    piece = _texts()[-1].encode()
    assert len(bpe._bpe_merge(piece, enc.ranks)) > 8
    assert handle.merge(piece, enc.ranks) == bpe._bpe_merge(piece, enc.ranks)
    short = " hello".encode()
    assert handle.merge(short, enc.ranks) == bpe._bpe_merge(short, enc.ranks)


def test_native_bpe_without_the_library(monkeypatch):
    """No g++: no handle, and the encoding runs the pure-Python merge."""
    monkeypatch.setattr(_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        _native.bpe_handle()
    monkeypatch.setattr(bpe._NativeBPE, "_instance", "unset")
    assert bpe._NativeBPE.get() is None
