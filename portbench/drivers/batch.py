"""Offline batches: ``batch`` clips of ``clip_seconds`` of host PCM each,
padded to 30 s, through the log-mel frontend and a greedy decode of
``sample_len`` tokens, back to back; host PCM in, host tokens out.

Mix keys: ``metric`` (the name of the end-to-end rate it reports),
``batch``, ``clip_seconds``, ``sample_len``, ``pools`` (distinct
batches of PCM made in set-up, used in turn), ``check_rows`` (rows the
reference checks), ``feature_rows`` (rows of each batch whose encoder
output, which the decode returns with the tokens, is kept for the check),
``warmup_batches``.
"""

from __future__ import annotations

import time

import torch

import qasr_ijcnlp_tpu_torch as port

from .. import roofline, trace
from ..port import build_model, decoding_options, judged
from ..reference import whisper as ref
from ..weights import AUDIO, make_pcm, make_weights, permutation, pick_checked


class State:
    def __init__(self, run):
        tr = run.traffic
        self.run = run
        self.model = build_model(run)
        self.options = decoding_options(run, tr["sample_len"])
        samples = int(round(tr["clip_seconds"] * ref.SAMPLE_RATE))
        self.pools = [make_pcm(tr["batch"], samples, run.seed, run.device, AUDIO + 16 * (k + 1))
                      for k in range(tr["pools"])]

    def mel(self, k: int):
        audio = port.pad_or_trim(self.pools[k % len(self.pools)])
        return port.log_mel_spectrogram(audio, self.run.dims["n_mels"], device=self.run.device)

    def batch(self, k: int, keep=()):
        """Batch ``k``: (tokens, average log probability) of every row, on
        the host, and copies of the encoder outputs of the rows ``keep``."""
        results = port.decode(self.model, self.mel(k), self.options)
        return ([(list(r.tokens), r.avg_logprob) for r in results],
                {i: results[i].audio_features.clone() for i in keep})


def setup(run):
    state = State(run)
    run.mark("model and inputs")
    for k in range(run.traffic.get("warmup_batches", 1)):
        state.batch(k)
    return state


def kept_rows(run, k: int):
    """The rows of batch ``k`` whose encoder output the check may read."""
    return sorted(permutation(run.traffic["batch"], run.seed, 64 + k)[:run.traffic["feature_rows"]])


def window(state: State, run) -> dict:
    tr = run.traffic
    served, features, ends = [], {}, []
    t0 = time.perf_counter()
    while True:
        k = len(served)
        rows, feats = state.batch(k, kept_rows(run, k))
        served.append(rows)
        features.update({(k, i): f for i, f in feats.items()})
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= run.seconds:
            break
    run.features = {key: f.cpu() for key, f in features.items()}
    rows = len(served) * tr["batch"]
    failed = sum(len(t) != tr["sample_len"] for b in served for t, _ in b)
    flops = rows * roofline.decode_flops(run.dims, len(ref.prompt_tokens(run.dims["n_vocab"])),
                                         tr["sample_len"])
    run.inputs = state.pools
    return {"e2e": {tr["metric"]: rows * tr["clip_seconds"] / elapsed},
            "attempted": rows, "failed": failed, "seconds": elapsed,
            "batches": len(served), "model_flops": flops, "served": served,
            "batch_ends_s": ends}


def _cuda_ms(fn, reps: int = 3) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(state: State, run) -> dict:
    """One more batch traced, then the frontend and the encoder of a batch
    alone by CUDA events (the card only)."""
    k = len(run.window["served"])
    summary = trace.profiled(lambda: state.batch(k, kept_rows(run, k)))
    mel = state.mel(k)
    return {"trace": summary, "batch": run.traffic["batch"],
            "token_steps": run.traffic["sample_len"],
            "frontend_ms": _cuda_ms(lambda: state.mel(k)),
            "encoder_ms": _cuda_ms(lambda: state.model.embed_audio(mel))}


def release(state: State):
    state.model = None


def check(run) -> dict:
    """``check_rows`` rows of the window, drawn from the seed among the
    rows whose encoder output was kept, the longest among them: their
    tokens, average log probabilities and encoder outputs against the
    reference."""
    tr, served = run.traffic, run.window["served"]
    every = sorted(run.features)
    sizes = [len(served[k][r][0]) for k, r in every]
    picked = [every[i] for i in pick_checked(sizes, tr["check_rows"], run.seed)]
    pools = run.inputs
    items = [(pools[k % len(pools)][r], *served[k][r], run.features[k, r]) for k, r in picked]
    w = make_weights(run.dims, run.seed, run.device)
    got = ref.served_numbers(w, run.dims, items, run.device, control=run.control)
    run.window["checked"] = got
    return judged(run, got)
