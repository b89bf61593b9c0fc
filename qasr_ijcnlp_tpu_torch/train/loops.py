"""Evaluation loops of the character-ASR and classification tasks.

The evaluation half of ``qasr_ijcnlp_tpu/train/loops.py``: the encoder
function of a model (:func:`encoder_fn_for`, through the quantum-vs-
classical dispatch), the two tasks' losses and their evaluation passes.
``params`` is ``{"encoder": encoder module, "head": head module}`` (the
JAX package's tree, as modules); batches go to the encoder's device.  One
encoder pass per batch serves the loss and the predictions.  The trainers
are not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import metrics as qmetrics
from ..data import CharVocabulary, END, PAD, START
from ..data.loader import DataLoader, pad_batch_to
from ..models import asr as asr_model
from ..models import classifier as clf_model
from ..models.whisper import dispatch_encoder_apply
from .loss import masked_cross_entropy

_TRAINING = ("training is not ported yet (ROADMAP queue 1, item 5: training and "
             "evaluation); only the evaluation loops run")


def encoder_fn_for(model_obj) -> Callable:
    """(encoder module, mel) -> (B, Ta, D) in f32 for the model's encoder,
    quantum or classical (``dispatch_encoder_apply``)."""
    dims = model_obj.dims

    def apply(encoder, mel):
        return dispatch_encoder_apply(encoder, mel, dims)

    return apply


def _device(params) -> torch.device:
    return next(params["encoder"].parameters()).device


def _char_logits(head, head_kind: str, enc, char_ids):
    if head_kind == "lstm":
        return asr_model.lstm_teacher_forced(head, enc, char_ids)
    return asr_model.mlp_head_char_logits(head, enc, char_ids)


def char_asr_loss_fn(encoder_apply: Callable, head_kind: str) -> Callable:
    """(params, mel, char_ids) -> CE over the next-char targets, ignoring
    <PAD>."""

    def loss(params, mel, char_ids):
        enc = encoder_apply(params["encoder"], mel)
        logits = _char_logits(params["head"], head_kind, enc, char_ids)
        return masked_cross_entropy(logits, char_ids[:, 1:], ignore_index=PAD)

    return loss


@torch.inference_mode()
def evaluate_char_asr(params, encoder_apply: Callable, head_kind: str, loader: DataLoader,
                      vocab: CharVocabulary, max_len: int = 100,
                      real_decode: bool = False) -> Dict[str, float]:
    """Validation loss and greedy CER/WER.

    The MLP head is scored, by default, by the argmax of its teacher-forced
    logits (the reference's optimistic validation, kept for parity);
    ``real_decode`` decodes it autoregressively instead
    (``models.asr.mlp_greedy_decode``).  The LSTM head always decodes."""
    dev = _device(params)
    head = params["head"]
    preds, refs, losses = [], [], []
    for batch in loader:
        # padded rows carry <PAD> targets: zero weight in the masked CE
        (mel, char_ids), real = pad_batch_to(batch, loader.batch_size, (None, PAD))
        mel = torch.from_numpy(np.ascontiguousarray(mel)).to(dev)
        ids = torch.from_numpy(np.ascontiguousarray(char_ids)).long().to(dev)
        enc = encoder_apply(params["encoder"], mel)
        logits = _char_logits(head, head_kind, enc, ids)
        losses.append(float(masked_cross_entropy(logits, ids[:, 1:], ignore_index=PAD)))
        if head_kind == "lstm":
            out, _ = asr_model.lstm_greedy_decode(head, enc, START, END, max_len)
        elif real_decode:
            out, _ = asr_model.mlp_greedy_decode(head, enc, START, END, max_len)
        else:
            out = logits.argmax(-1)
        out = out.cpu().numpy()
        for b in range(real):
            preds.append(vocab.decode(out[b]))
            refs.append(vocab.decode(np.asarray(char_ids[b][1:])))
    return {
        "loss": float(np.mean(losses)) if losses else 0.0,
        "cer": qmetrics.calculate_cer(preds, refs),
        "wer": qmetrics.calculate_wer(preds, refs),
    }


def classifier_loss_fn(encoder_apply: Callable) -> Callable:
    """(params, mel, labels) -> mean CE; negative labels mark padding rows
    and weigh nothing."""

    def loss(params, mel, labels):
        logits = clf_model.classifier_apply(params["head"],
                                            encoder_apply(params["encoder"], mel))
        valid = (labels >= 0).float()
        ce = F.cross_entropy(logits.float(), labels.clamp_min(0).long(), reduction="none")
        return (ce * valid).sum() / valid.sum().clamp_min(1.0)

    return loss


@torch.inference_mode()
def evaluate_classifier(params, encoder_apply: Callable, loader: DataLoader
                        ) -> Dict[str, float]:
    """Loss, accuracy and the reference's "WER" over stringified class
    ids (kept for checkpoint parity)."""
    dev = _device(params)
    correct = total = 0
    losses, pred_ids, true_ids = [], [], []
    for batch in loader:
        (mel, labels), real = pad_batch_to(batch, loader.batch_size)
        mel = torch.from_numpy(np.ascontiguousarray(mel)).to(dev)
        logits = clf_model.classifier_apply(params["head"],
                                            encoder_apply(params["encoder"], mel))
        logits = logits.float().cpu()
        pred = logits.argmax(-1).numpy()
        labels = np.asarray(labels)
        losses.append(float(F.cross_entropy(logits[:real],
                                            torch.from_numpy(labels[:real]).long())))
        correct += int((pred[:real] == labels[:real]).sum())
        total += real
        pred_ids.extend(str(p) for p in pred[:real])
        true_ids.extend(str(t) for t in labels[:real])
    return {
        "loss": float(np.mean(losses)) if losses else 0.0,
        "accuracy": correct / max(total, 1),
        "wer": qmetrics.calculate_wer(pred_ids, true_ids),
    }


def train_char_asr(*args, **kwargs):
    raise NotImplementedError(_TRAINING)


def train_classifier(*args, **kwargs):
    raise NotImplementedError(_TRAINING)


def train_token_asr(*args, **kwargs):
    raise NotImplementedError(_TRAINING)
