"""Batched transcription serving over HTTP.

Port of ``qasr_ijcnlp_tpu/serving.py``:

* :class:`BatchingTranscriber`: concurrent requests queue up; a worker
  groups them into micro-batches padded to ``batch_size``, computes the
  batch's log-mel on the device from the int16 wire audio (K1) and decodes
  it in one call;
* :func:`serve`: a standard-library HTTP front end:
    POST /v1/transcribe           body = PCM WAV bytes or JSON {"audio": [...]};
         audio over 30 s (or ``long=1``, ``word_timestamps=1``,
         ``batch_windows=N``) takes the long-form pipeline, the rest the
         micro-batcher, or with ``engine_slots`` the continuous-batching
         ``DecodeEngine``;
    POST /v1/transcribe/stream    the same body, answered as newline-delimited
         JSON: {"segments", "progress"} per committed window, then
         {"done", "text", "language"};
    POST /v1/stream/sessions[/<id>/audio|/<id>/end]   online sessions
         (``streaming.StreamingTranscriber``);
    GET  /healthz, /metrics (Prometheus text).

Start it with ``python -m qasr_ijcnlp_tpu_torch.serving --model tiny``; it
serves on the card (``--device cpu`` for the CPU).  Data-parallel serving
runs one process per rank under a launcher (``torchrun --nproc_per_node N
-m qasr_ijcnlp_tpu_torch.serving --data_parallel``): every rank builds the
micro-batcher and the engine pools over a data-only mesh, rank 0 serves
HTTP and the other ranks follow its plans (``BatchingTranscriber``,
``decode.engine``).  Long-form requests run on rank 0 alone.
"""

from __future__ import annotations

import atexit
import io
import json
import queue
import threading
import time
import wave
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from . import _kernels, parallel
from .audio import resample_audio, wire_log_mel, wire_pcm16
from .decode import DecodingOptions, DecodingTask, decode


class ServerMetrics:
    """Thread-safe counters, rendered in the Prometheus text format at
    ``GET /metrics``: requests and errors per route, latency sums and
    maxima, micro-batch occupancy, audio seconds, and the engine's
    ``engine_*`` counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_max(self, name: str, value: float):
        with self._lock:
            if value > self._counters.get(name, 0.0):
                self._counters[name] = value

    def set(self, name: str, value: float):
        """A gauge: the last write wins."""
        with self._lock:
            self._counters[name] = value

    def observe_request(self, route: str, seconds: float, error: bool):
        self.inc(f'requests_total{{route="{route}"}}')
        if error:
            self.inc(f'errors_total{{route="{route}"}}')
        self.inc(f'request_seconds_sum{{route="{route}"}}', seconds)
        self.set_max(f'request_seconds_max{{route="{route}"}}', seconds)

    def observe_batch(self, size: int, capacity: int, seconds: float):
        self.inc("batches_total")
        self.inc("batched_requests_total", size)
        self.inc("batch_slots_total", capacity)
        self.inc("batch_seconds_sum", seconds)

    def render(self) -> str:
        with self._lock:
            items = sorted(self._counters.items())
        return "".join(f"qasr_{name} {value:g}\n" for name, value in items)


@dataclass
class _Pending:
    audio: np.ndarray  # 30 s of 16 kHz mono, int16 wire format
    scale: float  # float = int16 * scale
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[str] = None


class BatchingTranscriber:
    """Groups concurrent requests into padded fixed-size decode batches on
    the model's device.

    ``mesh``: data-parallel micro-batches.  Every rank of the mesh builds
    the transcriber (a collective call); the batch size is rounded up to
    the data extent (``parallel.round_up_to_mesh``); the leader (rank 0)
    takes the requests and broadcasts each micro-batch's wire audio, and
    every rank computes the log-mel and decodes its rows of it
    (``DecodingTask.run`` data-parallel, on a fork of the mesh's groups).
    One worker; the other ranks follow until the leader closes."""

    def __init__(self, model, batch_size: int = 16, max_wait_ms: float = 25.0,
                 options: Optional[DecodingOptions] = None, workers: int = 1, mesh=None,
                 metrics: Optional[ServerMetrics] = None):
        self.mesh = None
        if mesh is not None and mesh.size > 1:
            if mesh.shape[parallel.MODEL_AXIS] > 1:
                model.shard(mesh)
            batch_size = parallel.round_up_to_mesh(batch_size, mesh)
            self.mesh = mesh.fork()
            workers = 1
        if model.device.type == "cuda":
            _kernels.library()  # built here, never by two threads at first use
        self.model = model
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.metrics = metrics or ServerMetrics()
        # The long-form route's default: detect on multilingual models, so a
        # clip transcribes alike at 20 s (here) and 40 s (long-form).
        self.options = options or DecodingOptions(
            language=None if model.is_multilingual else "en", without_timestamps=True)
        self._task = None if self.mesh is None else DecodingTask(model, self.options,
                                                                 mesh=self.mesh)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        run = self._run if self.mesh is None else self._run_mesh
        self._workers = [threading.Thread(target=run, daemon=True)
                         for _ in range(max(1, workers))]
        for w in self._workers:
            w.start()
        atexit.register(self.close)

    def transcribe(self, audio, timeout: float = 600.0) -> dict:
        """Blocking single-utterance request (thread-safe).  The request
        thread only pads and quantizes; the worker computes the whole
        micro-batch's log-mel in one call on the device."""
        if self._stop.is_set():
            raise RuntimeError("transcriber is closed")
        if self.mesh is not None and not self.mesh.is_leader:
            raise RuntimeError("a data-parallel transcriber takes its requests on the "
                               f"mesh's leader (rank {self.mesh.leader})")
        item = _Pending(*wire_pcm16(audio))
        self._queue.put(item)
        if self._stop.is_set() and not item.event.is_set():
            # close() may have drained the queue already
            item.error = "server shutting down"
            item.event.set()
        if not item.event.wait(timeout):
            raise TimeoutError("transcription timed out")
        if item.error:
            raise RuntimeError(item.error)
        return item.result

    def join(self, timeout: Optional[float] = None):
        """Wait for the workers to end: on a follower rank of a mesh, until
        the leader closes."""
        for w in self._workers:
            w.join(timeout)

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        atexit.unregister(self.close)
        for w in self._workers:
            w.join(timeout=600)
        while True:  # fail what is still queued, so its waiters wake
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                break
            p.error = "server shutting down"
            p.event.set()

    def _collect(self) -> List[_Pending]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        t0 = time.perf_counter()
        while len(batch) < self.batch_size:
            remaining = self.max_wait - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def mels(self, audios: np.ndarray, scales: np.ndarray) -> torch.Tensor:
        """(B, n_mels, 3000) log-mel on the model's device of int16 audio
        (B, 480000) times its per-clip scales: K1 on the card."""
        dev = self.model.device
        return wire_log_mel(torch.from_numpy(audios).to(dev), torch.from_numpy(scales).to(dev),
                            self.model.dims.n_mels)

    def _run(self):
        with torch.inference_mode():  # per thread
            while not self._stop.is_set():
                batch = self._collect()
                if batch:
                    self._serve(batch)

    def _run_mesh(self):
        """The worker of a data-parallel transcriber: the leader collects a
        micro-batch (or nothing, at least every 0.1 s) and broadcasts it;
        every rank decodes its rows; the leader answers."""
        leader = self.mesh.is_leader
        with torch.inference_mode():
            while True:
                batch, plan = [], None
                if leader:
                    if not self._stop.is_set():
                        batch = self._collect()
                    plan = {"stop": self._stop.is_set() and not batch,
                            "wire": self._wire(batch) if batch else None}
                plan = parallel.broadcast_object(plan, self.mesh)
                if plan["stop"]:
                    return
                if plan["wire"] is not None:
                    self._serve(batch, plan["wire"])

    def _wire(self, batch: List[_Pending]):
        """The micro-batch's int16 audio and scales, padded to the batch
        size by repeating the last clip."""
        pad = [batch[-1]] * (self.batch_size - len(batch))
        return (np.stack([p.audio for p in batch + pad]),
                np.asarray([p.scale for p in batch + pad], np.float32))

    def _serve(self, batch: List[_Pending], wire=None):
        t0 = time.perf_counter()
        try:
            mels = self.mels(*(wire if wire is not None else self._wire(batch)))
            results = (decode(self.model, mels, self.options) if self._task is None
                       else self._task.run(mels))
            for p, r in zip(batch, results):
                p.result = {"text": r.text.strip(), "tokens": [int(t) for t in r.tokens],
                            "avg_logprob": float(r.avg_logprob),
                            "no_speech_prob": float(r.no_speech_prob), "language": r.language}
                p.event.set()
            self.metrics.observe_batch(len(batch), self.batch_size, time.perf_counter() - t0)
        except Exception as e:  # fail this batch's requests
            self.metrics.inc("batch_errors_total")
            for p in batch:
                if not p.event.is_set():
                    p.error = f"{type(e).__name__}: {e}"
                    p.event.set()


def _decode_wav_bytes(data: bytes) -> np.ndarray:
    """16-bit PCM WAV -> 16 kHz mono: int16 as it is for mono 16 kHz (the
    mel dequantizes it on the device), else float32 downmixed and
    resampled."""
    with wave.open(io.BytesIO(data), "rb") as w:
        n_ch, width, rate = w.getnchannels(), w.getsampwidth(), w.getframerate()
        raw = w.readframes(w.getnframes())
    if width != 2:
        raise ValueError("only 16-bit PCM WAV is supported")
    pcm = np.frombuffer(raw, np.int16).copy()  # writable, for torch.from_numpy
    if n_ch == 1 and rate == 16000:
        return pcm
    audio = pcm.astype(np.float32) / 32768.0
    if n_ch > 1:
        audio = audio.reshape(-1, n_ch).mean(axis=1)
    return resample_audio(audio, rate, 16000)


# Decode options the long-form pipeline takes as they are.  Not temperature
# (transcribe runs its own ladder), without_timestamps (segmentation needs
# timestamps), prompt or prefix (long-form builds its own prompt).
_FORWARDED_OPTIONS = (
    "language", "task", "beam_size", "patience", "best_of", "length_penalty",
    "suppress_tokens", "suppress_blank", "fp16", "kv_int8", "prompt_bucket",
    "sample_len", "draft",
)


def _long_form_kwargs(options: Optional[DecodingOptions], query: dict) -> dict:
    """``transcribe`` kwargs of a long-form or streamed request: the query's
    flags, then every decode option the server was configured with."""
    truthy = ("1", "true")
    kwargs = {"word_timestamps": query.get("word_timestamps", ["0"])[0] in truthy}
    if query.get("condition_on_previous_text", [""])[0] in ("0", "false"):
        # independent windows: with an engine every window can share its pool
        kwargs["condition_on_previous_text"] = False
    if bw := query.get("batch_windows", [None])[0]:
        kwargs["batch_windows"] = int(bw)
    if sl := query.get("sample_len", [None])[0]:
        kwargs["sample_len"] = int(sl)
    if options is not None:
        defaults = DecodingOptions()
        for name in _FORWARDED_OPTIONS:
            value = getattr(options, name)
            if value is not None and value != getattr(defaults, name):
                kwargs.setdefault(name, value)  # the query wins
    return kwargs


def serve(model, host: str = "127.0.0.1", port: int = 8077, batch_size: int = 16,
          max_wait_ms: float = 25.0, options: Optional[DecodingOptions] = None,
          block: bool = True, mesh=None, engine_slots: Optional[int] = None,
          engine_lookup_gamma: int = 0):
    """Start the HTTP service; returns (server, transcriber).

    ``engine_slots``: short (<= 30 s) requests go through a
    ``DecodeEngine`` of this many slots instead of the micro-batcher (no
    head-of-line blocking, admission mid-flight), and so do online sessions
    (their own pool, with timestamps) and long-form windows (a third pool,
    built at the first long request)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from .transcribe import transcribe as _long_transcribe

    if mesh is not None and mesh.size == 1:
        mesh = None
    if mesh is not None and mesh.shape[parallel.MODEL_AXIS] > 1:
        raise ValueError("serve shards requests over a data-only mesh "
                         "(parallel.make_mesh(model_parallel=1))")
    if model.device.type == "cuda":
        _kernels.library()
    transcriber = BatchingTranscriber(model, batch_size, max_wait_ms, options, mesh=mesh)
    engine = stream_engine = None
    if engine_slots:
        from .decode.engine import DecodeEngine

        try:
            engine = DecodeEngine(model, options or transcriber.options, slots=engine_slots,
                                  audio_frontend=True, lookup_gamma=engine_lookup_gamma,
                                  mesh=mesh, metrics=transcriber.metrics)
            # Sessions decode with timestamps (the slide needs segment
            # boundaries): a pool of their own.
            stream_engine = DecodeEngine(
                model, replace(options or transcriber.options, without_timestamps=False),
                slots=engine_slots, audio_frontend=True, lookup_gamma=engine_lookup_gamma,
                mesh=mesh)
        except Exception:
            transcriber.close()
            if engine is not None:
                engine.close()
            raise
    if mesh is not None and not mesh.is_leader:
        # A follower rank: no HTTP; its components follow the leader's plans
        # until the leader closes them.
        if block:
            for part in (transcriber, engine, stream_engine):
                if part is not None:
                    part.join()
        return None, transcriber

    # The long-form pool: mel input and timestamps, with the options
    # transcribe builds its t = 0 rung from (_engine_shortcut compares them),
    # built at the first long request.  A pool that fails to build fails
    # the request (and the next one tries again); it never falls back to
    # the serialized path.
    long_engine: dict = {}
    long_engine_lock = threading.Lock()

    def _get_long_engine():
        # Under a mesh the long-form pool would be built on rank 0 alone,
        # where a mesh pool needs every rank: long-form runs on rank 0 alone.
        if not engine_slots or mesh is not None:
            return None
        with long_engine_lock:
            if "engine" not in long_engine:
                from .decode.engine import DecodeEngine

                lf = {k: v for k, v in _long_form_kwargs(options, {}).items()
                      if k not in ("word_timestamps", "batch_windows")}
                lf.setdefault("language", "en")
                long_engine["engine"] = DecodeEngine(
                    model, DecodingOptions(**lf, temperature=0.0), slots=engine_slots,
                    lookup_gamma=engine_lookup_gamma, metrics=transcriber.metrics)
            return long_engine["engine"]

    # Long-form work outside an engine is serialized; reentrant, because
    # transcribe takes it again inside regions the engine route holds.
    long_lock = threading.RLock()

    def _run_long_transcribe(audio, **kw):
        eng = _get_long_engine()
        if eng is not None:
            return _long_transcribe(transcriber.model, audio, engine=eng,
                                    device_lock=long_lock, **kw)
        with long_lock:
            return _long_transcribe(transcriber.model, audio, **kw)

    # Online sessions: id -> [session, last access]; idle ones are purged.
    sessions: Dict[str, list] = {}
    sessions_lock = threading.Lock()
    session_idle_ttl = 600.0

    def _purge_sessions_locked(now):
        for k in [k for k, v in sessions.items() if now - v[1] > session_idle_ttl]:
            del sessions[k]

    def _get_session(sid):
        with sessions_lock:
            _purge_sessions_locked(time.time())
            entry = sessions.get(sid)
            if entry is not None:
                entry[1] = time.time()
                return entry[0]
        return None

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked streaming answers

        def log_message(self, *args):
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload, default=float).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "model": transcriber.model.name})
            elif self.path == "/metrics":
                body = transcriber.metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def _read_audio(self) -> np.ndarray:
            data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if "json" in self.headers.get("Content-Type", ""):
                return np.asarray(json.loads(data)["audio"], np.float32)
            return _decode_wav_bytes(data)

        def do_POST(self):
            url = urlparse(self.path)
            query = parse_qs(url.query)
            if url.path == "/v1/transcribe":
                self._transcribe(query)
            elif url.path == "/v1/stream/sessions":
                self._create_session(query)
            elif url.path.startswith("/v1/stream/sessions/"):
                self._session(url.path)
            elif url.path == "/v1/transcribe/stream":
                self._stream(query)
            else:
                self._send(404, {"error": "not found"})

        def _transcribe(self, query):
            metrics = transcriber.metrics
            t0, route, failed = time.perf_counter(), "transcribe", False
            try:
                audio = self._read_audio()
                metrics.inc("audio_seconds_total", len(audio) / 16000.0)
                force_long = (query.get("long", ["0"])[0] in ("1", "true")
                              or query.get("word_timestamps", ["0"])[0] in ("1", "true")
                              or "batch_windows" in query)
                if force_long or len(audio) > 30 * 16000:
                    route = "transcribe_long"
                    self._send(200, _run_long_transcribe(
                        audio, **_long_form_kwargs(options, query)))
                elif engine is not None:
                    route = "transcribe_engine"
                    self._send(200, engine.submit(audio))
                else:
                    self._send(200, transcriber.transcribe(audio))
            except Exception as e:
                failed = True
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            metrics.observe_request(route, time.perf_counter() - t0, failed)

        def _create_session(self, query):
            import uuid

            from .streaming import StreamingTranscriber

            t0, failed = time.perf_counter(), False
            try:
                opts = options or transcriber.options
                if "language" in query:
                    opts = replace(opts, language=query["language"][0] or None)
                kwargs = {k: float(query[k][0])
                          for k in ("step_seconds", "window_seconds", "vad_rms")
                          if k in query}
                if query.get("word_timestamps", ["0"])[0] in ("1", "true"):
                    kwargs["word_timestamps"] = True
                # the shared pool has the server's language; a session's own
                # language decodes on the plain (locked) path
                use_engine = stream_engine is not None and "language" not in query
                st = StreamingTranscriber(
                    transcriber.model, replace(opts, without_timestamps=False),
                    decode_fn=stream_engine.submit if use_engine else None, **kwargs)
                sid = uuid.uuid4().hex[:16]
                with sessions_lock:
                    _purge_sessions_locked(time.time())
                    sessions[sid] = [st, time.time()]
                self._send(200, {"id": sid})
            except Exception as e:
                failed = True
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            transcriber.metrics.observe_request("stream_session_create",
                                                time.perf_counter() - t0, failed)

        def _session(self, path):
            parts = path.split("/")
            sid = parts[4] if len(parts) > 4 else ""
            action = parts[5] if len(parts) > 5 else ""
            st = _get_session(sid)
            t0, failed = time.perf_counter(), False
            if st is None:
                failed = True
                self._send(404, {"error": "unknown session"})
            elif action in ("audio", "end"):
                try:
                    if action == "audio":
                        audio = self._read_audio()
                        transcriber.metrics.inc("audio_seconds_total", len(audio) / 16000.0)
                        call = lambda: st.feed(audio)  # noqa: E731
                    else:
                        call = st.end
                    # engine-backed sessions batch in their pool; the others
                    # decode under the lock, and answer outside it
                    if st.decode_fn is not None:
                        out = call()
                    else:
                        with long_lock:
                            out = call()
                    if action == "end":
                        with sessions_lock:
                            sessions.pop(sid, None)
                    self._send(200, out)
                except Exception as e:
                    failed = True
                    if action == "end":
                        with sessions_lock:
                            sessions.pop(sid, None)
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
            else:
                failed = True
                self._send(404, {"error": "not found"})
            transcriber.metrics.observe_request(f"stream_session_{action or 'unknown'}",
                                                time.perf_counter() - t0, failed)

        def _stream(self, query):
            metrics = transcriber.metrics
            t0 = time.perf_counter()
            try:
                audio = self._read_audio()
                metrics.inc("audio_seconds_total", len(audio) / 16000.0)
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                metrics.observe_request("stream", time.perf_counter() - t0, True)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(obj):
                line = (json.dumps(obj, default=float) + "\n").encode()
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                self.wfile.flush()

            # The decode runs in a thread and queues its chunks, written here
            # outside the lock: a slow client stalls only its own handler.
            self.connection.settimeout(30.0)
            chunks: "queue.Queue" = queue.Queue()

            def run():
                try:
                    result = _run_long_transcribe(
                        audio, on_segments=lambda segs, prog: chunks.put(
                            {"segments": segs, "progress": prog}),
                        **_long_form_kwargs(options, query))
                    chunks.put({"done": True, "text": result["text"],
                                "language": result["language"]})
                except Exception as e:
                    chunks.put({"error": f"{type(e).__name__}: {e}"})
                chunks.put(None)

            threading.Thread(target=run, daemon=True).start()
            failed = False
            try:
                while (obj := chunks.get()) is not None:
                    failed = failed or "error" in obj
                    emit(obj)
                self.wfile.write(b"0\r\n\r\n")
            except OSError:  # the client left: let the decode finish unread
                failed = True
                while chunks.get() is not None:
                    pass
            metrics.observe_request("stream", time.perf_counter() - t0, failed)

    class Server(ThreadingHTTPServer):
        # the default listen backlog of 5 resets bursts of clients
        request_queue_size = 256

        @property
        def long_engine(self):
            return _get_long_engine()

    server = Server((host, port), Handler)
    server.engine = engine
    server.stream_engine = stream_engine

    def close_all():
        transcriber.close()
        for eng in (engine, stream_engine, long_engine.get("engine")):
            if eng is not None:
                eng.close()

    server.close_all = close_all
    if block:
        try:
            print(f"serving on http://{host}:{port} (batch={batch_size})")
            server.serve_forever()
        finally:
            close_all()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, transcriber


def main(argv=None):
    import argparse

    from .cli import load_model_with_fallback, resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", type=str, default="tiny")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8077)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=25.0)
    p.add_argument("--device", type=str, default="auto",
                   help="auto or cuda (the card; exits without one) or cpu")
    p.add_argument("--data_parallel", action="store_true",
                   help="one process per rank under torchrun: micro-batches and engine "
                        "pools data-parallel over every rank, rank 0 serves HTTP")
    p.add_argument("--engine_slots", type=int, default=None,
                   help="route short requests through the continuous-batching "
                        "DecodeEngine with this many slots")
    p.add_argument("--engine_lookup_gamma", type=int, default=0,
                   help="prompt-lookup speculative rounds in the engine: up to "
                        "gamma+1 tokens per slot per forward (token-exact)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.data_parallel:
        parallel.initialize_distributed()
        mesh = parallel.make_mesh(model_parallel=1)
        device = parallel.rank_device(device)
        if mesh.is_leader:
            print(f"data-parallel serving over {mesh.size} ranks")
    model = load_model_with_fallback(args.model, device=device)
    serve(model, args.host, args.port, args.batch_size, args.max_wait_ms, mesh=mesh,
          engine_slots=args.engine_slots, engine_lookup_gamma=args.engine_lookup_gamma)


if __name__ == "__main__":
    main()
