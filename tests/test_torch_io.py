"""The port's files on disk vs the JAX package's: checkpoints, audio files
and the transcribe CLI.

Checkpoints cross-load both ways between the two packages' official-format
``.pt`` files; a model name resolves only to a cached file with the
official SHA-256, and never opens a connection; WAV files at 8, 16, 44.1
and 48 kHz, mono and stereo, decode to the JAX package's samples; the
native sources are copies; the CLI writes the JAX CLI's
txt / vtt / srt / tsv bytes and its json within 1e-4 on one local
checkpoint.
"""

import base64
import gzip
import json
import os
import re
import socket
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import audio as jaudio
from qasr_ijcnlp_tpu.cli import transcribe as jcli
from qasr_ijcnlp_tpu.models import convert as jconvert
from qasr_ijcnlp_tpu_torch import _native, audio
from qasr_ijcnlp_tpu_torch.cli import resolve_device, transcribe as tcli
from qasr_ijcnlp_tpu_torch.models import convert, registry
from tests.torch_port_common import (  # noqa: F401
    LF_DIMS, lf_models, one_torch_thread, speechlike_pcm,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    return lf_models(0)


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("opened a network connection")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(socket.socket, "connect", refuse)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: np.asarray(tree)}


def test_checkpoint_jax_to_port(models, tmp_path):
    jm, tm = models
    path = str(tmp_path / "jax.pt")
    jconvert.save_torch_checkpoint(path, jm.params, LF_DIMS)
    sd, dims = convert.load_torch_checkpoint(path)
    assert dims.to_dict() == LF_DIMS.to_dict()
    want = tm.module.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), k


def test_checkpoint_port_to_jax(models, tmp_path):
    jm, tm = models
    path = str(tmp_path / "port.pt")
    registry.save_model(tm, path)
    params, dims = jconvert.load_torch_checkpoint(path)
    assert dims.to_dict() == tm.dims.to_dict()
    got, want = _flat(params), _flat(jm.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    loaded = registry.load_model(path, device="cpu")
    np.testing.assert_array_equal(loaded.alignment_heads, loaded.default_alignment_heads())
    for k, v in loaded.module.state_dict().items():
        assert torch.equal(v, tm.module.state_dict()[k]), k


def test_fp16_checkpoint_loads_as_fp32(models, tmp_path):
    _, tm = models
    sd = {k: v.half() for k, v in tm.module.state_dict().items()}
    del sd["encoder.positional_embedding"]
    path = str(tmp_path / "half.pt")
    torch.save({"dims": LF_DIMS.to_dict(), "model_state_dict": sd}, path)
    got, _ = convert.load_torch_checkpoint(path)
    with open(path, "rb") as f:
        assert set(convert.load_torch_checkpoint(f.read())[0]) == set(got)
    for k, v in got.items():
        assert v.dtype == torch.float32, k
    want = tm.module.state_dict()
    assert torch.equal(got["encoder.positional_embedding"],
                       want["encoder.positional_embedding"])
    assert torch.equal(got["decoder.ln.weight"], want["decoder.ln.weight"].half().float())


def test_name_lookup_never_downloads(models, tmp_path, monkeypatch, no_network):
    """An official name resolves only to a cached file with the official
    SHA-256: a missing or altered file raises (or, with init_if_missing,
    gives the flagged random init) and nothing opens a connection."""
    _, tm = models
    with pytest.raises(RuntimeError, match="does not download"):
        registry.load_model("tiny", download_root=str(tmp_path), device="cpu")
    cached = str(tmp_path / "tiny.pt")
    registry.save_model(tm, cached)
    with pytest.raises(RuntimeError, match="SHA-256"):
        registry.load_model("tiny", download_root=str(tmp_path), device="cpu")
    fallback = registry.load_model("tiny", download_root=str(tmp_path), device="cpu",
                                   init_if_missing=True)
    assert fallback.name == "tiny (random-init)" and fallback.dims.n_audio_state == 384
    np.testing.assert_array_equal(fallback.alignment_heads,
                                  fallback.default_alignment_heads())
    monkeypatch.setitem(registry._MODELS, "tiny", registry._file_sha256(cached))
    heads = np.array([[False, True], [True, False]])
    monkeypatch.setitem(registry._ALIGNMENT_HEADS, "tiny",
                        base64.b85encode(gzip.compress(heads.tobytes())))
    found = registry.load_model("tiny", download_root=str(tmp_path), device="cpu")
    assert found.name == "tiny" and found.dims.to_dict() == LF_DIMS.to_dict()
    np.testing.assert_array_equal(found.alignment_heads, heads)


def _write_wav(path, pcm, rate):
    data = (np.clip(pcm, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(data.shape[1] if data.ndim == 2 else 1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate", [8000, 16000, 44100, 48000])
def test_load_audio_wav_equal(tmp_path, rate, channels):
    rng = np.random.default_rng(rate + channels)
    pcm = rng.uniform(-0.5, 0.5, (rate * 2 + 7, channels)).astype(np.float32)
    path = str(tmp_path / f"a_{rate}_{channels}.wav")
    _write_wav(path, pcm if channels == 2 else pcm[:, 0], rate)
    ours, theirs = audio.load_audio(path), jaudio.load_audio(path)
    assert ours.dtype == np.float32 and abs(len(ours) - 2 * 16000) <= 16
    np.testing.assert_array_equal(ours, theirs)
    mel = audio.log_mel_spectrogram(path, device="cpu")
    np.testing.assert_array_equal(mel.numpy(), audio.log_mel_spectrogram(
        audio._load_audio_any(path), device="cpu").numpy())


def test_load_audio_stdlib_fallback_equal(tmp_path, monkeypatch):
    """Without the native library (no g++), the stdlib reader decodes as
    the JAX package's does."""
    from qasr_ijcnlp_tpu import _native as jnative

    pcm = np.random.default_rng(0).uniform(-0.5, 0.5, (44100, 2)).astype(np.float32)
    path = str(tmp_path / "st.wav")
    _write_wav(path, pcm, 44100)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(jnative, "_LIB", None)
    np.testing.assert_array_equal(audio.load_audio(path), jaudio.load_audio(path))


@pytest.mark.parametrize("name", _native.SOURCES)
def test_native_sources_are_copies(name):
    """Byte for byte the JAX package's sources, except that comments cite
    the reference implementation by its own paths (``whisper/...``), not
    by where a checkout of it lay."""
    with open(os.path.join(ROOT, "qasr_ijcnlp_tpu", "native", name), "rb") as f:
        want = re.sub(rb"/[\w/]*/reference/whisper/", b"whisper/", f.read())
    with open(os.path.join(ROOT, "qasr_ijcnlp_tpu_torch", "native", name), "rb") as f:
        assert f.read() == want


def test_resample_and_preprocess_equal():
    x = np.random.default_rng(3).uniform(-0.5, 0.5, 44100).astype(np.float32)
    for rate in (8000, 22050, 44100, 48000):
        np.testing.assert_array_equal(audio.resample_audio(x, rate, 16000),
                                      jaudio.resample_audio(x, rate, 16000))
    ours = audio.preprocess_audio_for_whisper(x[:20000], device="cpu").numpy()
    np.testing.assert_allclose(ours, np.asarray(jaudio.preprocess_audio_for_whisper(
        x[:20000])), atol=2e-4, rtol=0)
    assert ours.shape == (80, 3000)


def test_cli_device_and_draft(tmp_path, monkeypatch):
    """``--draft_model`` builds a ``Draft``, as the JAX CLI does: the named
    model on the same device, or ``lookup`` for no model, with
    ``--draft_gamma``; transcribe gets it with the other options."""
    from qasr_ijcnlp_tpu_torch.decode import Draft

    assert resolve_device("cpu") == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            resolve_device("auto")
    loaded, calls = [], []
    monkeypatch.setattr(tcli, "load_model_with_fallback",
                        lambda name, **kw: loaded.append((name, kw["device"])) or name)
    monkeypatch.setattr(tcli, "transcribe", lambda model, path, **kw: calls.append(kw) or
                        dict(text="", segments=[], language="en"))
    for draft, gamma in (("tiny", "3"), ("lookup", "2")):
        tcli.main(["x.wav", "--model", "base", "--device", "cpu", "--draft_model", draft,
                   "--draft_gamma", gamma, "--beam_size", "None", "-o", str(tmp_path),
                   "-f", "txt"])
        d = calls[-1]["draft"]
        assert isinstance(d, Draft) and d.gamma == int(gamma)
        assert d.model == (None if draft == "lookup" else "tiny")
    assert loaded == [("base", "cpu"), ("tiny", "cpu"), ("base", "cpu")]


def test_cli_all_outputs_equal(models, tmp_path, no_network):
    jm, _ = models
    ckpt = str(tmp_path / "lf.pt")
    jconvert.save_torch_checkpoint(ckpt, jm.params, LF_DIMS)
    wav = str(tmp_path / "talk.wav")
    _write_wav(wav, speechlike_pcm(15.0, seed=2), 16000)
    flags = [wav, "--model", ckpt, "--device", "cpu", "--language", "en",
             "--temperature_increment_on_fallback", "None", "--beam_size", "None",
             "--best_of", "None", "--fp16", "False", "--no_speech_threshold", "None",
             "--verbose", "False"]
    tcli.main(flags + ["-o", str(tmp_path / "ours")])
    jcli.main(flags + ["-o", str(tmp_path / "theirs")])
    assert jax.default_backend() == "cpu"
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == [f"talk.{e}" for e in ("json", "srt", "tsv", "txt", "vtt")]
    for name in names[1:]:
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes(), name
    ours = json.loads((tmp_path / "ours" / "talk.json").read_text())
    theirs = json.loads((tmp_path / "theirs" / "talk.json").read_text())
    assert ours["text"] == theirs["text"] and len(ours["segments"]) >= 2
    for a, b in zip(ours["segments"], theirs["segments"]):
        assert (a["seek"], a["tokens"], a["text"]) == (b["seek"], b["tokens"], b["text"])
        for key in ("start", "end", "avg_logprob", "compression_ratio", "no_speech_prob"):
            assert a[key] == pytest.approx(b[key], abs=1e-4), key
