"""The system under test as the drivers call it: qasr_ijcnlp_tpu_torch's
public entry points, with the decode options every decoding cell uses."""

from __future__ import annotations

import torch

import qasr_ijcnlp_tpu_torch as port
from qasr_ijcnlp_tpu_torch.models.dims import ModelDimensions

from .reference.whisper import special_tokens
from .weights import make_weights


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_model(run) -> "port.WhisperModel":
    """The cell's Whisper from the seed's weights, made on the run's
    device, its encoder entry (``embed_audio``) in bfloat16, the decode's
    dtype."""
    sd = make_weights(run.dims, run.seed, run.device)
    return port.WhisperModel.from_state_dict(sd, ModelDimensions(**run.dims), device=run.device,
                                             name=run.cell["config"],
                                             compute_dtype=torch.bfloat16)


def decoding_options(run, sample_len: int) -> "port.DecodingOptions":
    """English transcription without timestamps, eot suppressed (so every
    row decodes exactly ``sample_len`` tokens on random weights), greedy,
    bfloat16 on the card."""
    eot = special_tokens(run.dims["n_vocab"])["eot"]
    return port.DecodingOptions(language="en", without_timestamps=True, sample_len=sample_len,
                                suppress_tokens=[eot], suppress_blank=False, fp16=True)


def judged(run, got: dict) -> dict:
    """The numbers that decide ``correct``, each beside its limit: the
    program's (``got[name]``), or with the calibration's control in the
    program's place, the control's (``got["control_" + name]``).  Both are
    kept in ``run.window`` (``program``, ``control``)."""
    names = tuple(run.limits)  # the numbers this cell compares
    run.window["program"] = {n: got[n] for n in names}
    values = run.window["program"]
    if run.control is not None:
        values = run.window["control"] = {n: got["control_" + n] for n in names}
    return {n: {"value": values[n], "limit": run.limits[n]} for n in names}
