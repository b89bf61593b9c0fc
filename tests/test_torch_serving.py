"""Port serving (qasr_ijcnlp_tpu_torch/serving.py) and online sessions
(qasr_ijcnlp_tpu_torch/streaming.py) over loopback HTTP.

Two servers at the long-form test geometry (30-s windows): one with the
micro-batcher alone, one with ``engine_slots`` (the engine route, a session
pool and a long-form pool).  Every route's answer must equal the direct
call on the same audio: the micro-batch and engine routes the port's
``decode`` of the int16 wire audio's mel, the long-form and chunked routes
``transcribe`` with the server's options, a session the port's
``StreamingTranscriber`` fed the same chunks, whose committed text must
also equal the JAX package's ``StreamingTranscriber``.  Also WAV decoding
(against the JAX package's), the ``/metrics`` text, the refusals of
``main``, and clean 400 / 404 answers.
"""

import io
import json
import threading
import urllib.error
import urllib.request
import wave
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from qasr_ijcnlp_tpu import serving as jserving
from qasr_ijcnlp_tpu.decode import DecodingOptions as JOptions
from qasr_ijcnlp_tpu.streaming import StreamingTranscriber as JStreaming
import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch import parallel, serving
from qasr_ijcnlp_tpu_torch.streaming import StreamingTranscriber
from tests.torch_port_common import lf_models, one_torch_thread, speechlike_pcm  # noqa: F401

OPTS = dict(language="en", without_timestamps=True, sample_len=6, fp16=False)


@pytest.fixture(scope="module")
def lf():
    return lf_models(0)


@pytest.fixture(scope="module")
def servers(lf):
    """{"plain": (port, transcriber), "engine": (port, transcriber)}."""
    _, tm = lf
    out, handles = {}, []
    for name, kw in (("plain", {}), ("engine", {"engine_slots": 2})):
        server, tr = serving.serve(tm, port=0, batch_size=2, max_wait_ms=50, block=False,
                                   options=port.DecodingOptions(**OPTS), **kw)
        handles.append(server)
        out[name] = (server.server_address[1], tr)
    yield out
    for server in handles:
        server.shutdown()
        server.close_all()


def _post(port_, path, audio=None, data=None, ctype="application/json", timeout=300):
    if data is None:
        data = json.dumps({"audio": np.asarray(audio).tolist()}).encode() if audio is not None \
            else b""
    req = urllib.request.Request(f"http://127.0.0.1:{port_}{path}", data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _wav(pcm16, rate=16000, channels=1, width=2):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


def _direct(tr, audio):
    """The port's decode of the int16 wire audio's mel, as the routes
    quantize it."""
    q, scale = port.audio.wire_pcm16(audio)
    (r,) = port.decode(tr.model, tr.mels(q[None], np.asarray([scale], np.float32)),
                       port.DecodingOptions(**OPTS))
    return {"text": r.text, "tokens": r.tokens, "language": r.language}


def _same(answer, direct):
    assert {k: answer[k] for k in direct} == direct


def test_wav_decoding_equals_jax():
    rng = np.random.default_rng(0)
    mono = (rng.standard_normal(16000) * 3000).astype(np.int16)
    got = serving._decode_wav_bytes(_wav(mono))
    assert got.dtype == np.int16 and np.array_equal(got, mono)  # passed through
    stereo = (rng.standard_normal((44100, 2)) * 3000).astype(np.int16)
    data = _wav(stereo, rate=44100, channels=2)
    np.testing.assert_allclose(serving._decode_wav_bytes(data),
                               jserving._decode_wav_bytes(data), atol=1e-6)
    with pytest.raises(ValueError, match="16-bit"):
        serving._decode_wav_bytes(_wav(np.zeros(100, np.uint8), width=1))


def test_healthz_microbatch_and_engine_routes_equal_direct(servers):
    audio = [speechlike_pcm(s, seed=10 + i) for i, s in enumerate((3.0, 5.0, 1.5))]
    results = {}
    for name in ("plain", "engine"):
        p, tr = servers[name]
        with urllib.request.urlopen(f"http://127.0.0.1:{p}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        out = [None] * 3

        def go(i, p=p, out=out):
            out[i] = _post(p, "/v1/transcribe", audio[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        results[name] = out
        # a WAV body: int16 passed through, the same wire audio
        pcm16 = np.clip(audio[0] * 32768, -32768, 32767).astype(np.int16)
        _same(_post(p, "/v1/transcribe", data=_wav(pcm16), ctype="audio/wav"),
              _direct(tr, pcm16))
    _, tr = servers["plain"]
    for i in range(3):
        direct = _direct(tr, audio[i])
        _same(results["plain"][i], direct)
        _same(results["engine"][i], direct)


def test_long_form_and_chunked_routes_equal_direct(servers, lf):
    """The long-form routes run the temperature ladder, whose sampling
    rungs draw from torch's global generator (the server passes none), so
    each call here starts from one seed."""
    _, tm = lf
    audio = speechlike_pcm(35.0, seed=4)
    p, _ = servers["plain"]
    kw = serving._long_form_kwargs(port.DecodingOptions(**OPTS), {})
    torch.manual_seed(0)
    direct = tm.transcribe(audio, **kw)
    torch.manual_seed(0)
    assert _post(p, "/v1/transcribe", audio) == json.loads(json.dumps(direct))
    torch.manual_seed(0)
    req = urllib.request.Request(f"http://127.0.0.1:{p}/v1/transcribe/stream",
                                 data=json.dumps({"audio": audio.tolist()}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers.get("Content-Type") == "application/x-ndjson"
        events = [json.loads(line) for line in r]
    assert events[-1] == {"done": True, "text": direct["text"],
                          "language": direct["language"]}
    segs = [s for ev in events[:-1] for s in ev["segments"]]
    assert segs == json.loads(json.dumps(direct["segments"]))
    # the engine server: independent windows through its long-form pool
    pe, _ = servers["engine"]
    torch.manual_seed(0)
    ours = _post(pe, "/v1/transcribe?condition_on_previous_text=0", audio)
    torch.manual_seed(0)
    plain = tm.transcribe(audio, condition_on_previous_text=False, **kw)
    assert ours["text"] == plain["text"]
    assert [s["tokens"] for s in ours["segments"]] == [s["tokens"] for s in plain["segments"]]


def test_stream_session_equals_direct_and_jax(servers, lf):
    """A session fed 1-s chunks, then ended: the committed text of the port's
    StreamingTranscriber on the same chunks, and of JAX's; the engine
    server's session (its pool) the same."""
    jm, tm = lf
    audio = speechlike_pcm(3.0, seed=6)
    chunks = [audio[i:i + 16000] for i in range(0, len(audio), 16000)]
    opts = dict(OPTS, without_timestamps=False)
    ref = StreamingTranscriber(tm, port.DecodingOptions(**opts))
    jref = JStreaming(jm, JOptions(**opts))
    for c in chunks:
        ref.feed(c)
        jref.feed(c)
    expected, jexpected = ref.end(), jref.end()
    assert expected["text"] == jexpected["text"]
    assert expected["language"] == jexpected["language"]
    for name in ("plain", "engine"):
        p, _ = servers[name]
        sid = _post(p, "/v1/stream/sessions")["id"]
        for c in chunks:
            out = _post(p, f"/v1/stream/sessions/{sid}/audio", c)
            assert "partial" in out and "text" in out
        final = _post(p, f"/v1/stream/sessions/{sid}/end")
        assert final["text"] == expected["text"] and final["partial"] == ""
        with pytest.raises(urllib.error.HTTPError) as e:  # gone after end
            _post(p, f"/v1/stream/sessions/{sid}/audio", [0.0] * 100)
        assert e.value.code == 404


def test_long_form_pool_failure_fails_the_request(lf, monkeypatch):
    """A long-form pool that cannot be built fails the request with a 400
    naming the fault; the request never falls back to the serialized
    per-window path."""
    from qasr_ijcnlp_tpu_torch.decode import engine as engine_mod

    _, tm = lf
    server, _ = serving.serve(tm, port=0, batch_size=1, block=False, engine_slots=1,
                              options=port.DecodingOptions(**OPTS))
    try:
        def broken(*a, **k):
            raise RuntimeError("no pool here")

        monkeypatch.setattr(engine_mod, "DecodeEngine", broken)
        calls = []
        monkeypatch.setattr(tm, "decode", lambda *a, **k: calls.append(1))
        p = server.server_address[1]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(p, "/v1/transcribe?long=1", speechlike_pcm(2.0, seed=3))
        assert e.value.code == 400
        assert "no pool here" in json.load(e.value)["error"]
        assert not calls  # no window was decoded outside the pool
    finally:
        server.shutdown()
        server.close_all()
        monkeypatch.undo()


def test_metrics_text_and_errors(servers):
    p, _ = servers["engine"]
    _post(p, "/v1/transcribe", speechlike_pcm(1.0, seed=2))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(p, "/v1/transcribe", data=b"{not json")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(p, "/v1/nothing")
    assert e.value.code == 404
    with urllib.request.urlopen(f"http://127.0.0.1:{p}/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    metrics = dict(line.rsplit(" ", 1) for line in body.strip().splitlines())
    metrics = {k: float(v) for k, v in metrics.items()}
    assert metrics['qasr_requests_total{route="transcribe_engine"}'] >= 1
    assert metrics['qasr_errors_total{route="transcribe"}'] == 1
    assert metrics["qasr_engine_admitted_total"] >= 1
    assert metrics["qasr_engine_retired_total"] >= 1
    assert metrics["qasr_engine_committed_tokens_total"] >= 1
    assert metrics["qasr_audio_seconds_total"] > 0
    assert all(line.startswith("qasr_") for line in body.strip().splitlines())


def test_main_device_and_refusals(lf):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            serving.main(["--device", "auto"])
    _, tm = lf
    with pytest.raises(ValueError, match="data-only mesh"):
        serving.serve(tm, mesh=SimpleNamespace(size=2, shape={"data": 1, "model": 2}))
    one = serving.BatchingTranscriber(tm, mesh=parallel.make_mesh())  # one rank: plain
    assert one.mesh is None and one.batch_size == 16
    one.close()
    with pytest.raises(ValueError, match="without_timestamps"):
        StreamingTranscriber(tm, port.DecodingOptions(**OPTS))
    with pytest.raises(ValueError, match="temperature 0"):
        StreamingTranscriber(tm, replace(port.DecodingOptions(**OPTS), temperature=0.3,
                                         without_timestamps=False))
