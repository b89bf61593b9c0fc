"""Fine-tuning steps: the port's train step (``train.step.make_train_step``
over ``whisper_loss_fn`` in ``compute_dtype``, AdamW with float32 master
weights and moments, each block rematerialized with ``remat``) on batches of
``batch`` rows, each a 30-s log-mel and ``prompt_tokens`` + ``target_tokens``
tokens, run back to back.

Set-up builds the one step object and drives it through ``check_steps``
steps on distinct rows; those steps are the warm-up and what the reference
follows.  The window cycles through ``pool_batches`` batches.  Mix keys
besides: ``learning_rate``, ``weight_decay``, ``b1``, ``b2``, ``eps``,
``clip_norm``, ``reference_rows`` (rows a block of the reference's
gradient), ``trace_steps``.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.models import whisper as port_whisper
from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions
from qasr_ijcnlp_tpu_torch.train.step import (
    init_state, make_optimizer, make_train_step, whisper_loss_fn,
)

from .. import roofline, trace
from ..port import judged, sync
from ..reference import train as ref_train
from ..reference import whisper as ref
from ..weights import AUDIO, TOKENS, generator, make_pcm, make_weights


def make_batches(run):
    """``pool_batches`` batches on the host: mel (B, n_mels, 3000) float32
    from seeded PCM through the reference's log-mel, tokens (B, prompt +
    targets) int64, the English transcription prompt then text tokens."""
    tr, dims = run.traffic, run.dims
    B, n = tr["batch"], tr["pool_batches"]
    pcm = make_pcm(B * n, ref.N_SAMPLES, run.seed, run.device, AUDIO)
    g = generator(run.seed, TOKENS, run.device)
    text = torch.randint(0, ref.special_tokens(dims["n_vocab"])["eot"],
                         (B * n, tr["target_tokens"]), generator=g, device=run.device)
    prompt = torch.tensor(ref.prompt_tokens(dims["n_vocab"]), device=run.device)
    tokens = torch.cat([prompt.expand(B * n, -1), text], 1).cpu().numpy()
    batches = []
    with ref.exact_fp32(), torch.no_grad():
        for k in range(n):
            audio = torch.from_numpy(pcm[k * B:(k + 1) * B]).to(run.device)
            batches.append((ref.log_mel(audio, dims["n_mels"]).cpu().numpy(),
                            tokens[k * B:(k + 1) * B]))
    return batches


class State:
    def __init__(self, run):
        tr = run.traffic
        self.run = run
        self.batches = make_batches(run)
        self.device_batches = [(torch.from_numpy(m).to(run.device), torch.from_numpy(t).to(run.device))
                               for m, t in self.batches]
        sd = make_weights(run.dims, run.seed, run.device)
        model = port.WhisperModel.from_state_dict(sd, ModelDimensions(**run.dims), run.device)
        self.module = model.module.requires_grad_(True)
        port_whisper.set_remat(bool(tr["remat"]))
        self.tx = make_optimizer(tr["learning_rate"], tr["weight_decay"], tr["b1"], tr["b2"],
                                 tr["eps"], tr["clip_norm"])
        self.state = init_state(self.module, self.tx)
        self.step_fn = make_train_step(whisper_loss_fn(model.dims, tr["compute_dtype"]),
                                       self.tx)
        self.steps = 0

    def step(self):
        mel, tokens = self.device_batches[self.steps % len(self.device_batches)]
        self.state, m = self.step_fn(self.state, mel, tokens)
        self.steps += 1
        return m


def setup(run):
    """The step object, driven through the first ``check_steps`` steps; what
    the reference compares is read as they complete."""
    s = State(run)
    run.mark("model, optimizer and batches")
    named = dict(s.module.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    readings = {"losses": []}
    for i in range(run.traffic["check_steps"]):
        m = s.step()
        readings["losses"].append(float(m["loss"]))
        if i == 0:
            b1 = s.tx.b1
            readings["grad_norms"] = {
                n: float(torch.linalg.vector_norm(mu.double())) / (1 - b1)
                for n, mu in zip(s.state.opt_state["names"], s.state.opt_state["mu"])}
    readings["change_norms"] = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
                                for n, p in named.items()}
    del start
    s.readings = readings
    return s


def window(state: State, run) -> dict:
    tr = run.traffic
    t0 = time.perf_counter()
    n0 = state.steps
    losses = []
    while True:
        m = state.step()
        losses.append(m["loss"])
        sync(run.device)
        elapsed = time.perf_counter() - t0
        if elapsed >= run.seconds:
            break
    steps = state.steps - n0
    bad = sum(not np.isfinite(float(v)) for v in losses)
    run.inputs = state.batches
    run.readings = state.readings
    tokens = tr["prompt_tokens"] + tr["target_tokens"]
    return {"e2e": {"train_audio_s_per_s": steps * tr["batch"] * 30.0 / elapsed},
            "attempted": steps, "failed": bad, "seconds": elapsed, "steps": steps,
            "model_flops": steps * tr["batch"] * roofline.train_flops(run.dims, tokens)}


def profiled(state: State, run) -> dict:
    n = run.traffic["trace_steps"]

    def steps():
        for _ in range(n):
            state.step()

    return {"trace": trace.profiled(steps), "steps": n, "batch": run.traffic["batch"]}


def release(state: State):
    port_whisper.set_remat(False)
    state.state = state.step_fn = state.module = state.tx = state.device_batches = None


def _leaf_gaps(got: dict, want: dict, leaves) -> dict:
    """Each leaf's |got - want| over its reference norm or the median
    leaf's, whichever is larger."""
    median = statistics.median(want.values())
    return {n: abs(got[n] - want[n]) / max(want[n], median) for n in leaves}


def check(run) -> dict:
    tr, dims = run.traffic, run.dims
    w = make_weights(dims, run.seed, run.device)
    batches = [(torch.from_numpy(m).to(run.device), torch.from_numpy(t).to(run.device))
               for m, t in run.inputs[:tr["check_steps"]]]
    hyper = {"lr": tr["learning_rate"], "weight_decay": tr["weight_decay"], "b1": tr["b1"],
             "b2": tr["b2"], "eps": tr["eps"], "clip_norm": tr["clip_norm"]}
    want = ref_train.reference_steps(w, dims, batches, hyper, tr["reference_rows"])
    del w
    g_med = statistics.median(want["grad_norms"].values())
    moved = [n for n, v in want["grad_norms"].items() if v >= 1e-3 * g_med]

    def numbers(got, worst=None):
        grad = _leaf_gaps(got["grad_norms"], want["grad_norms"], want["grad_norms"])
        change = _leaf_gaps(got["change_norms"], want["change_norms"], moved)
        if worst is not None:
            worst.update(grad=max(grad, key=grad.get), update=max(change, key=change.get))
        return {"loss_gap": max(abs(a - b) for a, b in zip(got["losses"], want["losses"])),
                "grad_leaf_gap": max(grad.values()), "update_leaf_gap": max(change.values())}

    worst = {}
    got = numbers(run.readings, worst)
    run.window["checked"] = {"numbers": got, "worst_leaf": worst, "moved": len(moved),
                             "leaves": len(want["grad_norms"]), "losses": run.readings["losses"],
                             "reference_losses": want["losses"]}
    if run.control is not None:
        # the reference itself in the control's precision, and a step that
        # takes the mean over half of each batch
        w = make_weights(dims, run.seed, run.device)
        control = numbers(ref_train.reference_steps(
            w, dims, batches, hyper, tr["reference_rows"], run.control))
        got = dict(got, **{"control_" + k: v for k, v in control.items()})
        w = make_weights(dims, run.seed, run.device)
        half = [(m[:m.shape[0] // 2], t[:t.shape[0] // 2]) for m, t in batches]
        run.window["half_batch"] = numbers(ref_train.reference_steps(
            w, dims, half, hyper, tr["reference_rows"]))
    return judged(run, got)
