"""Draft-model distillation for speculative decoding.

Port of ``qasr_ijcnlp_tpu/train/distill.py``.  Speculative decoding
(``decode/speculative.py``) pays off in proportion to how often the draft's
filtered argmax agrees with the target's, so a small draft is trained to
imitate a frozen target on the target's own greedy outputs
(sequence-level distillation):

1. label: the frozen target's greedy decode over audio batches (the
   port's ``DecodingTask``), once per distinct batch;
2. train: teacher-forced forwards of both models on the teacher's tokens,
   loss = KL(teacher || student) at temperature tau times tau^2, the
   teacher's forward under ``torch.no_grad`` (JAX's ``stop_gradient``);
3. measure: top-1 agreement on held-out teacher-forced positions, the
   proxy for the verifier's per-token acceptance.

The optimizer is JAX's bare ``optax.adamw(lr, b1=0.9, b2=0.98, eps=1e-6)``:
weight decay 1e-4 (optax's default) and no clipping, where the port's
``make_optimizer`` defaults to 0.01 and a clip at 1.0; ``make_train_step``
keeps its non-finite guard, as JAX's does.  On the card both forwards run
the encoder kernels (the student's through their autograd Functions).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models import whisper as model
from ..models.dims import ModelDimensions
from .step import init_state, make_optimizer, make_train_step

_PARALLEL = "sharded distillation is not ported yet (ROADMAP queue 1, item 7: parallelism)"


def _dtype(compute_dtype) -> torch.dtype:
    return compute_dtype if isinstance(compute_dtype, torch.dtype) else \
        getattr(torch, str(compute_dtype))


def distill_loss_fn(t_dims: ModelDimensions, s_dims: ModelDimensions, compute_dtype="float32",
                    tau: float = 1.0, mesh=None) -> Callable:
    """(student module, teacher module, mel, tokens) -> scalar distillation
    loss: KL(teacher || student) over the next-token distributions at every
    position whose label is not -100, both softened by ``tau``, times
    tau^2 (the gradient's scale does not depend on tau)."""
    if mesh is not None:
        raise NotImplementedError(_PARALLEL)
    dt = _dtype(compute_dtype)

    def loss_fn(student, teacher, mel, tokens):
        inputs = tokens.clamp_min(0).long()
        with torch.no_grad():
            t_logits = model.forward(teacher, mel, inputs, t_dims, dt)
        s_logits = model.forward(student, mel, inputs, s_dims, dt)
        # predict token t+1 from the prefix ..t (as shifted_token_loss)
        t_lp = torch.log_softmax(t_logits[:, :-1].float() / tau, dim=-1)
        s_lp = torch.log_softmax(s_logits[:, :-1].float() / tau, dim=-1)
        kl = torch.sum(torch.exp(t_lp) * (t_lp - s_lp), dim=-1)  # (B, T-1)
        mask = (tokens[:, 1:] != -100).float()
        return (tau * tau) * torch.sum(kl * mask) / torch.clamp(torch.sum(mask), min=1.0)

    return loss_fn


def make_teacher_labeler(target_model, sample_len: int = 48,
                         language: str = "en") -> Callable[[object], np.ndarray]:
    """mels (B, n_mels, T) -> the teacher's greedy tokens (B, L) int32,
    padded with -100.  Each row is the sot prompt, the tokens and the
    final eot, the sequence the student is verified on; every batch pads
    to ``sample_begin + sample_len + 1``."""
    from ..decode import DecodingOptions, _get_task

    options = DecodingOptions(language=language, sample_len=sample_len,
                              without_timestamps=True,
                              fp16=target_model.compute_dtype != torch.float32)
    task = _get_task(target_model, options)
    width = task.sample_begin + sample_len + 1

    def label(mels) -> np.ndarray:
        with torch.inference_mode():
            results = task.run(torch.as_tensor(mels).to(target_model.device))
        out = np.full((len(results), width), -100, np.int32)
        for i, r in enumerate(results):
            seq = list(task.initial_tokens) + list(r.tokens) + [task.tokenizer.eot]
            out[i, : len(seq)] = seq[:width]
        return out

    return label


@torch.no_grad()
def agreement_rate(t_model, s_model, mels, tokens) -> float:
    """Fraction of teacher-forced positions where the student's argmax
    matches the teacher's (float32 forwards), the per-token acceptance
    proxy the speculative verifier realizes."""
    dev = t_model.device
    mel = torch.as_tensor(mels).to(dev)
    tokens = torch.as_tensor(np.asarray(tokens)).to(dev).long()
    inputs = tokens.clamp_min(0)
    t_logits = model.forward(t_model.module, mel, inputs, t_model.dims, torch.float32)
    s_logits = model.forward(s_model.module, mel.to(s_model.device), inputs.to(s_model.device),
                             s_model.dims, torch.float32).to(dev)
    mask = tokens[:, 1:] != -100
    agree = (t_logits[:, :-1].argmax(-1) == s_logits[:, :-1].argmax(-1)) & mask
    return float(agree.sum()) / max(float(mask.sum()), 1.0)


def distill_draft(
    target_model,
    draft_model,
    mel_batches: Iterable,
    steps: int,
    learning_rate: float = 1e-3,
    tau: float = 1.0,
    sample_len: int = 48,
    language: str = "en",
    mesh=None,
    log_every: int = 50,
    on_log: Optional[Callable[[int, float], None]] = None,
) -> Tuple[object, list]:
    """Train ``draft_model``'s weights (in place) toward the frozen target;
    returns the draft model and the loss history [(step, loss)].

    ``mel_batches`` yields (B, n_mels, T) arrays or tensors and is cycled;
    the teacher's labels are computed once per distinct batch.  Every
    draft parameter trains (``requires_grad`` is set for the run and
    restored after)."""
    if mesh is not None:
        raise NotImplementedError(_PARALLEL)
    label = make_teacher_labeler(target_model, sample_len, language)
    loss_fn = distill_loss_fn(target_model.dims, draft_model.dims,
                              compute_dtype=draft_model.compute_dtype, tau=tau)
    student = draft_model.module
    flags = [p.requires_grad for p in student.parameters()]
    student.requires_grad_(True)
    try:
        tx = make_optimizer(learning_rate, weight_decay=1e-4, clip_norm=None)
        step_fn = make_train_step(loss_fn, tx)
        state = init_state(student, tx)
        dev = draft_model.device
        batches = [torch.as_tensor(b).to(dev) for b in mel_batches]
        labels = [None] * len(batches)
        history = []
        for i in range(steps):
            j = i % len(batches)
            if labels[j] is None:
                labels[j] = torch.from_numpy(label(batches[j])).to(dev)
            state, metrics = step_fn(state, target_model.module, batches[j], labels[j])
            if (i + 1) % log_every == 0 or i + 1 == steps:
                loss = float(metrics["loss"])
                history.append((i + 1, loss))
                if on_log is not None:
                    on_log(i + 1, loss)
    finally:
        for p, f in zip(student.parameters(), flags):
            p.requires_grad_(f)
    return draft_model, history
