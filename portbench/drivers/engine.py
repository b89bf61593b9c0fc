"""A closed loop of clients on the continuous-batching ``DecodeEngine``.

``clients`` requests are kept in flight: each retirement queues that
client's next clip at once, in the engine's own worker, so that no client
thread shares the interpreter with the worker.  A request is queued as
``DecodeEngine.submit`` queues it, in the wire form ``submit`` makes
(``wire_pcm16``: padded to 30 s, int16 against the clip's peak), made once
for every clip in set-up.  The clips are made
in set-up: ``clips`` of them, of lengths spread evenly over
[``clip_seconds_min``, ``clip_seconds_max``] (the same lengths for every
seed, in a seeded order), 16 kHz float PCM, queued in that order.  Engine
keys: ``slots``, ``unroll``, ``admit_width``; decode: ``sample_len``.  The
first ``warmup_requests`` completions are set-up; the window counts the
requests that complete inside it (see ``window``); the loop runs on through
the traced stretch of ``--trace 1`` (``trace_seconds``) and stops at
release.

The check reads what the engine served and, for the requests of
``feature_clips`` clips drawn from the seed, the cross-attention keys of
the first and the last decoder layer as the request's slot holds them when
it retires: what admission (K1 on the wire audio, the encoder, the cross
projections) wrote, in the slot that the request's result is read from.

Mix keys besides: ``check_requests`` (requests the reference checks).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from qasr_ijcnlp_tpu_torch.audio import wire_pcm16
from qasr_ijcnlp_tpu_torch.decode.engine import DecodeEngine, _Request

from .. import roofline, trace
from ..port import build_model, decoding_options, judged
from ..reference import whisper as ref
from ..weights import AUDIO, ORDER, make_pcm, make_weights, permutation, pick_checked

# seconds to wait for the first completion of the window before giving up
STALL_S = 120.0


class Counters:
    """The engine's ``metrics`` registry: counts by name."""

    def __init__(self):
        self.values = {}
        self._lock = threading.Lock()

    def inc(self, name, n=1):
        with self._lock:
            self.values[name] = self.values.get(name, 0) + n

    def set(self, name, value):
        with self._lock:
            self.values[name] = value

    def snapshot(self):
        with self._lock:
            return dict(self.values)


class State:
    def __init__(self, run):
        tr = run.traffic
        self.run = run
        self.model = build_model(run)
        n = tr["clips"]
        seconds = np.linspace(tr["clip_seconds_min"], tr["clip_seconds_max"], n)
        self.lengths = (seconds * ref.SAMPLE_RATE).round().astype(np.int64)[permutation(n, run.seed)]
        full = make_pcm(n, int(self.lengths.max()), run.seed, run.device, AUDIO)
        self.clips = [full[i, :m].copy() for i, m in enumerate(self.lengths)]
        self.wire = [wire_pcm16(c) for c in self.clips]  # what submit queues
        self.counters = Counters()
        self.engine = DecodeEngine(self.model, decoding_options(run, tr["sample_len"]),
                                   slots=tr["slots"], unroll=tr["unroll"],
                                   admit_width=tr["admit_width"], audio_frontend=True,
                                   metrics=self.counters)
        # the clips whose slot keys are kept
        self.kept = set(permutation(n, run.seed, ORDER + 1)[:tr["feature_clips"]].tolist())
        self.layers = sorted({0, run.dims["n_text_layer"] - 1})
        self.capturing = False
        self.real_retire = self.engine._retire
        self.engine._retire = self.retire
        self.next = 0
        self.lock = threading.Lock()
        # id(request) -> (clip, t_submit, request), for the requests in flight
        self.pending = {}
        # (clip, t_submit, t_done, (tokens, avg_logprob), keys or None,
        #  retirement pass: the engine's step call it retired after)
        self.done = []
        self.stop = False

    def submit(self):
        """Queue the next clip, as ``DecodeEngine.submit`` does, without
        waiting for it."""
        eng = self.engine
        with self.lock:
            i = self.next % len(self.clips)
            self.next += 1
            req = _Request(*self.wire[i])
            self.pending[id(req)] = (i, time.perf_counter(), req)
        with eng._lock:
            eng._queue.append(req)
        eng._wake.set()

    def retire(self, slot: int, result: dict):
        """The engine's retirement, which first copies (on the card, queued)
        the slot's cross keys into the result of a kept clip's request, then
        queues that client's next clip."""
        req = self.engine._occupant[slot]
        with self.lock:
            clip, t0, _ = self.pending.pop(id(req))
        if self.capturing and clip in self.kept:
            st = self.engine.state
            result = dict(result, cross_k={i: st.cross_k[i][slot].clone() for i in self.layers})
        self.real_retire(slot, result)
        with self.lock:
            self.done.append((clip, t0, time.perf_counter(),
                              (result["tokens"], result["avg_logprob"]), result.get("cross_k"),
                              self.engine.step_calls))
        if not self.stop:
            self.submit()

    def completed(self) -> int:
        with self.lock:
            return len(self.done)

    def errors(self) -> int:
        """Requests the engine failed (they never retire)."""
        with self.lock:
            return sum(r.error is not None for _, _, r in self.pending.values())


def setup(run):
    state = State(run)
    run.mark("model, clips and engine")
    for _ in range(run.traffic["clients"]):
        state.submit()
    t_end = time.perf_counter() + STALL_S
    while state.completed() < run.traffic["warmup_requests"]:
        if state.errors() or time.perf_counter() > t_end:
            raise RuntimeError(f"the engine failed {state.errors()} warm-up requests and "
                               f"completed {state.completed()}")
        time.sleep(0.01)
    return state


def _wait(what, until):
    """Wait until ``until()`` holds, for at most ``STALL_S`` seconds."""
    t_end = time.perf_counter() + STALL_S
    while not until():
        if time.perf_counter() > t_end:
            raise RuntimeError(f"the engine stalled: {what}")
        time.sleep(0.002)


def _pass_end(state: State, p: int) -> float:
    """The time of the last completion of retirement pass ``p``, once the
    engine's worker has left that pass."""
    _wait(f"in retirement pass {p}", lambda: state.engine.step_calls > p)
    with state.lock:
        return max(d[2] for d in state.done if d[5] == p)


def window(state: State, run) -> dict:
    """The window holds whole retirement passes (slots admitted together
    retire together): it runs from the end of the first pass that retires
    after it opens to the end of the last pass that retires within
    ``--seconds`` of that, and counts the requests of the passes between,
    that one excluded and this one included."""
    eng, tr = state.engine, run.traffic
    state.capturing = True
    t_open = time.perf_counter()
    _wait("no request completed", lambda: state.done and state.done[-1][2] > t_open)
    with state.lock:
        p_a = next(d[5] for d in state.done if d[2] > t_open)
    t_a = _pass_end(state, p_a)
    stages0, counts0, steps0 = eng.stage_seconds, state.counters.snapshot(), eng.step_calls
    time.sleep(max(0.0, t_a + run.seconds - time.perf_counter()))
    stages1, counts1, steps1 = eng.stage_seconds, state.counters.snapshot(), eng.step_calls
    with state.lock:
        p_b = max((d[5] for d in state.done if d[5] > p_a and d[2] <= t_a + run.seconds),
                  default=None)
    if p_b is None:
        raise RuntimeError(f"no request completed in {run.seconds} s")
    t_b = _pass_end(state, p_b)
    state.capturing = False
    with state.lock:
        done = [d for d in state.done if p_a < d[5] <= p_b]
    ok = [d for d in done if len(d[3][0]) == tr["sample_len"]]
    errors = state.errors()
    failed = len(done) - len(ok) + errors
    audio_s = sum(state.lengths[d[0]] for d in ok) / ref.SAMPLE_RATE
    per_request = roofline.decode_flops(run.dims, len(ref.prompt_tokens(run.dims["n_vocab"])),
                                        tr["sample_len"])
    run.inputs = state.clips
    admitted = counts1.get("engine_admitted_total", 0) - counts0.get("engine_admitted_total", 0)
    return {"e2e": {"served_audio_s_per_s": audio_s / (t_b - t_a)},
            "attempted": len(done) + errors, "failed": failed, "seconds": t_b - t_a,
            "passes": len({d[5] for d in done}),
            "latencies": sorted(d[2] - d[1] for d in done),
            "model_flops": len(ok) * per_request,
            "admit_s": stages1["admit"] - stages0["admit"],
            "step_s": stages1["step"] - stages0["step"],
            "retire_s": stages1["retire"] - stages0["retire"],
            "admitted": admitted, "step_calls": steps1 - steps0, "unroll": tr["unroll"],
            "served": [(d[0], d[3], d[4]) for d in ok]}


def profiled(state: State, run) -> dict:
    """``trace_seconds`` more of serving, traced (the loop goes on)."""
    return {"trace": trace.profiled(lambda: time.sleep(run.traffic["trace_seconds"]))}


def release(state: State):
    state.stop = True
    state.engine.close()
    del state.engine._retire  # the engine's own retirement again: no cycle
    state.engine = state.model = state.real_retire = None


def check(run) -> dict:
    """``check_requests`` requests completed in the window, drawn from the
    seed with the longest among them, and every request whose slot keys
    were kept, against the reference on the audio the engine's int16 wire
    carries."""
    tr, served = run.traffic, run.window["served"]
    sizes = [(len(t[0]), len(run.inputs[c])) for c, t, _ in served]
    picked = pick_checked(sizes, tr["check_requests"], run.seed)
    picked += [i for i, s in enumerate(served) if s[2] is not None and i not in picked]

    def wire(clip):  # the wire's audio, cut back to the clip's length
        return ref.wire_int16(clip)[:len(clip)]

    items = [(wire(run.inputs[served[i][0]]), *served[i][1], served[i][2]) for i in picked]
    w = make_weights(run.dims, run.seed, run.device)
    got = ref.served_numbers(w, run.dims, items, run.device, control=run.control)
    run.window["checked"] = got
    return judged(run, got)
