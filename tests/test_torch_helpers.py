"""The port's helpers against the JAX package's: ``profiling`` (StepTimer,
trace, annotate), ``python -m qasr_ijcnlp_tpu_torch`` and the native BPE
merge core (``native/bpe.cpp`` through ``_native.bpe_handle``), whose ids
must equal the pure-Python merge's and the JAX tokenizer's."""

import json
import os
import random
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from qasr_ijcnlp_tpu.profiling import StepTimer as JStepTimer
from qasr_ijcnlp_tpu.tokenizer import bpe as jbpe
from qasr_ijcnlp_tpu_torch import _native, profiling
from qasr_ijcnlp_tpu_torch.tokenizer import bpe
from tests.torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_step_timer():
    """As the JAX package's ``test_step_timer``, side by side."""
    for timer, x in ((profiling.StepTimer(), torch.arange(8)), (JStepTimer(), jnp.arange(8))):
        out = timer.timed("square", lambda x: x * x, x)
        assert out is not None
        s = timer.summary()
        assert s["square"]["count"] == 1 and s["square"]["total_s"] > 0
        lines = []
        timer.report(log=lines.append)
        assert lines and lines[0].split()[:3] == ["square", "1", "x"]


def test_step_timer_steps_and_holders():
    timer = profiling.StepTimer()
    for _ in range(3):
        held = []
        with timer.step("mm", held):
            held.append({"y": torch.ones(4, 4) @ torch.ones(4, 4)})
    with timer.step("empty"):
        pass
    s = timer.summary()
    assert s["mm"]["count"] == 3 and s["empty"]["count"] == 1
    assert s["mm"]["mean_ms"] == pytest.approx(1e3 * s["mm"]["total_s"] / 3)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as d:
        with profiling.annotate("qasr-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "qasr-region" for e in events)


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
