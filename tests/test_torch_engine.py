"""Port continuous-batching engine (qasr_ijcnlp_tpu_torch/decode/engine.py)
vs the JAX package's decode of each request.

Five requests go into a pool of three slots from staggered threads, so
later requests are admitted while earlier ones are mid-decode.  Each
request's tokens must equal JAX's ``decode`` of it alone, avg_logprob
within 1e-4 (1e-3 over the int8 cross cache, as the greedy int8 test) and
no_speech_prob within 1e-5: greedy (with and without timestamps), the int8
cross cache, prompt-lookup rounds, beam search, and per-request language
detection.  Also: one slot reused by requests in turn, the refusals JAX
raises, an admission that fails its request and leaves the pool serving,
the audio front end (int16 wire audio, the mel computed at admission) and
``transcribe(engine=...)``, whose transcript must equal the one without an
engine.  One JAX decode compile per option set.
"""

import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qasr_ijcnlp_tpu import audio as jaudio
from qasr_ijcnlp_tpu.decode import DecodingOptions as JOptions, decode as jdecode
from qasr_ijcnlp_tpu.models.registry import WhisperModel as JModel
import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine
from tests.torch_port_common import (  # noqa: F401
    DIMS, jax_params, lf_models, one_torch_thread, speechlike_pcm, torch_model,
)

NO_TS = dict(language="en", without_timestamps=True, sample_len=12)
TS = dict(language="en", sample_len=10)


@pytest.fixture(scope="module")
def models():
    params = jax_params(0)
    return JModel(jax.tree.map(jnp.asarray, params), DIMS), torch_model(params)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(21).standard_normal((5, 80, 1000)).astype(np.float32)


def _submit_all(engine, items, stagger=0.05):
    """Submit each item from its own thread, ``stagger`` s apart."""
    out, errors = [None] * len(items), []

    def go(i):
        try:
            out[i] = engine.submit(items[i], timeout=300)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(items))]
    for t in threads:
        t.start()
        time.sleep(stagger)
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return out


def _assert_equal_jax(out, ref, lp_tol=1e-4):
    assert [o["tokens"] for o in out] == [r.tokens for r in ref]
    assert [o["text"] for o in out] == [r.text for r in ref]
    assert [o["language"] for o in out] == [r.language for r in ref]
    for o, r in zip(out, ref):
        assert o["avg_logprob"] == pytest.approx(r.avg_logprob, abs=lp_tol)
        assert o["no_speech_prob"] == pytest.approx(r.no_speech_prob, abs=1e-5)


@pytest.mark.parametrize("opts,engine_kw,lp_tol", [
    (NO_TS, {}, 1e-4),
    (TS, {}, 1e-4),
    ({**NO_TS, "kv_int8": True}, {}, 1e-3),
    (NO_TS, {"lookup_gamma": 3}, 1e-4),
    ({**TS, "beam_size": 3}, {}, 1e-4),
    ({**TS, "language": None}, {}, 1e-4),
], ids=["greedy", "greedy_timestamps", "int8", "lookup", "beam", "detect_language"])
def test_pool_equals_jax_decode_per_request(models, mel, opts, engine_kw, lp_tol):
    jm, tm = models
    ref = jdecode(jm, jnp.asarray(mel), JOptions(fp16=False, **opts))
    engine = DecodeEngine(tm, port.DecodingOptions(fp16=False, **opts), slots=3, unroll=2,
                          **engine_kw)
    try:
        out = _submit_all(engine, list(mel))
        assert engine.admit_calls >= 2  # later requests joined a running pool
    finally:
        engine.close()
    _assert_equal_jax(out, ref, lp_tol)


def test_slot_reuse_one_slot(models, mel):
    """One slot serves three requests in turn; each equals its own decode."""
    jm, tm = models
    ref = jdecode(jm, jnp.asarray(mel[:3]), JOptions(fp16=False, **NO_TS))
    engine = DecodeEngine(tm, port.DecodingOptions(fp16=False, **NO_TS), slots=1, unroll=3)
    try:
        out = [engine.submit(m) for m in mel[:3]]
        assert engine.admit_calls == 3
    finally:
        engine.close()
    _assert_equal_jax(out, ref)


def test_stage_seconds_split_the_worker(models, mel):
    """``stage_seconds`` splits the worker's time into admission, steps and
    retirement (the host clock on the CPU, CUDA events on the card); the
    engine has no timing option."""
    _, tm = models
    engine = DecodeEngine(tm, port.DecodingOptions(fp16=False, **NO_TS), slots=2, unroll=2)
    try:
        _submit_all(engine, list(mel[:2]))
    finally:
        engine.close()
    stages = engine.stage_seconds
    assert set(stages) == {"admit", "step", "retire"}
    assert stages["admit"] > 0 and stages["step"] > 0 and stages["retire"] >= 0
    with pytest.raises(TypeError):
        DecodeEngine(tm, port.DecodingOptions(fp16=False, **NO_TS), profile=True)


def test_refusals_as_jax(models):
    _, tm = models
    O = port.DecodingOptions  # noqa: N806
    with pytest.raises(ValueError, match="temperature 0"):
        DecodeEngine(tm, O(temperature=0.5, **NO_TS))
    with pytest.raises(ValueError, match="temperature 0"):
        DecodeEngine(tm, O(best_of=2, temperature=0.5, **NO_TS))
    with pytest.raises(ValueError, match="greedy-only"):
        DecodeEngine(tm, O(beam_size=2, **NO_TS), lookup_gamma=2)
    with pytest.raises(ValueError, match="kv_int8 beam"):
        DecodeEngine(tm, O(beam_size=2, kv_int8=True, **NO_TS))
    mesh2 = SimpleNamespace(size=2, shape={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="beam engine pools do not shard"):
        DecodeEngine(tm, O(beam_size=2, **NO_TS), mesh=mesh2)
    with pytest.raises(ValueError, match="multiple of the mesh's data axis"):
        DecodeEngine(tm, O(**NO_TS), slots=3, mesh=mesh2)


def test_admission_failure_fails_request_and_keeps_serving(models, mel):
    """A malformed request fails at admission with an error (no hang); the
    pool then serves the next request; after close, submit raises."""
    jm, tm = models
    engine = DecodeEngine(tm, port.DecodingOptions(fp16=False, **NO_TS), slots=2)
    try:
        with pytest.raises(RuntimeError, match="mel frames"):
            engine.submit(np.zeros((80, 7), np.float32), timeout=60)
        out = engine.submit(mel[0], timeout=120)
    finally:
        engine.close()
    _assert_equal_jax([out], jdecode(jm, jnp.asarray(mel[:1]), JOptions(fp16=False, **NO_TS)))
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(mel[0])


@pytest.fixture(scope="module")
def lf():
    return lf_models(0)


def test_audio_frontend_equals_jax_on_the_wire_audio(lf):
    """``audio_frontend``: 30-s int16 wire audio, the mel at admission; the
    tokens of JAX's decode of the same dequantized audio's mel."""
    jm, tm = lf
    pcm = [speechlike_pcm(s, seed=i) for i, s in enumerate((4.0, 7.5, 2.0))]
    opts = dict(fp16=False, **NO_TS)
    engine = DecodeEngine(tm, port.DecodingOptions(**opts), slots=2, audio_frontend=True)
    try:
        out = _submit_all(engine, pcm)
    finally:
        engine.close()
    wire = []
    for a in pcm:
        a = port.pad_or_trim(a)
        peak = float(max(np.max(np.abs(a)), 1e-9))
        q = (a * (32767.0 / peak)).astype(np.int16)
        wire.append(q.astype(np.float32) * np.float32(peak / 32767.0))
    ref = jdecode(jm, jaudio.log_mel_spectrogram(np.stack(wire)), JOptions(**opts))
    _assert_equal_jax(out, ref)


def _assert_same_transcript(ours, plain):
    """Equal but for the floats the engine computes in its own batch
    (avg_logprob, no_speech_prob), within 1e-5."""
    assert (ours["text"], ours["language"]) == (plain["text"], plain["language"])
    assert len(ours["segments"]) == len(plain["segments"])
    for a, b in zip(ours["segments"], plain["segments"]):
        assert a.keys() == b.keys()
        for k in a:
            if k in ("avg_logprob", "no_speech_prob"):
                assert a[k] == pytest.approx(b[k], abs=1e-5)
            else:
                assert a[k] == b[k], k


def test_transcribe_with_engine_equals_without(lf):
    """Promptless windows of ``transcribe`` through a shared pool give the
    transcript of the plain path; a pool with other options is not used
    (a warning) and changes nothing."""
    _, tm = lf
    pcm = speechlike_pcm(35.0, seed=3)
    kw = dict(language="en", temperature=0.0, compression_ratio_threshold=None,
              logprob_threshold=None, no_speech_threshold=None, fp16=False, sample_len=8,
              condition_on_previous_text=False)
    plain = tm.transcribe(pcm, **kw)
    engine = DecodeEngine(tm, port.DecodingOptions(language="en", fp16=False, sample_len=8),
                          slots=2)
    try:
        ours = tm.transcribe(pcm, engine=engine, **kw)
        assert engine.admit_calls == 2  # both windows went through the pool
    finally:
        engine.close()
    _assert_same_transcript(ours, plain)
    other = DecodeEngine(tm, port.DecodingOptions(language="en", fp16=False, sample_len=6),
                         slots=1)
    try:
        with pytest.warns(UserWarning, match="ignored"):
            assert tm.transcribe(pcm, engine=other, **kw) == plain
        assert other.admit_calls == 0
    finally:
        other.close()
