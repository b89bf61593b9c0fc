"""Epoch-driven trainers and evaluation loops of the three task families.

Port of ``qasr_ijcnlp_tpu/train/loops.py``:

* char-level ASR (quantum or classical encoder + MLP/LSTM char head):
  :func:`train_char_asr`, AdamW + cosine, the freeze mask, best-CER/WER
  checkpoints, ``resume_from``; validated by :func:`evaluate_char_asr`
  (real greedy decoding for the LSTM head);
* classification: :func:`train_classifier`, best-accuracy/loss/WER
  checkpoints; :func:`evaluate_classifier`;
* token-level Whisper ASR: :func:`train_token_asr`, AdamW + warmup-cosine,
  ``grad_accum``, full-state checkpoints every ``save_state_every`` epochs
  and ``resume_state``, teacher-forced validation WER.

``params`` is ``{"encoder": encoder module, "head": head module}`` (the JAX
package's tree, as modules) for the first two and the ``Whisper`` module
for the third; batches go to the parameters' device, through
``prefetch_to_device``.  The trainers set ``requires_grad`` from the mask
for the run and restore the modules' flags afterwards; they update the
modules in place and return them.  Best-metric checkpoints are written in
the JAX package's layout (its ``load_pytree`` reads them).  Training runs
with autograd on (never under ``inference_mode``); the evaluation
functions run under ``inference_mode``.  Each epoch's statistics come from
one host transfer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import metrics as qmetrics
from ..data import CharVocabulary, END, PAD, START
from ..data.loader import DataLoader, pad_batch_to, prefetch_to_device
from ..models import asr as asr_model
from ..models import classifier as clf_model
from ..models import whisper as cmodel
from ..models.convert import from_jax_encoder, from_jax_head, to_jax_encoder, to_jax_head
from ..models.convert import to_jax_params
from ..models.whisper import dispatch_encoder_apply
from .checkpoint import BestTracker, TrainingHistory
from .loss import masked_cross_entropy
from .step import as_module, init_state, make_optimizer, make_train_step


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


def _epoch_stats(step_metrics) -> Dict[str, float]:
    """The epoch's mean loss over its finite batches and its count of
    batches the non-finite guard skipped, from one host transfer."""
    if not step_metrics:
        return {"train_loss": 0.0, "skipped": 0}
    host = torch.stack([torch.stack([m["loss"].double(), m["skipped"].double()])
                        for m in step_metrics]).cpu().numpy()
    losses = host[:, 0]
    finite = losses[np.isfinite(losses)]
    return {"train_loss": float(finite.mean()) if finite.size else 0.0,
            "skipped": int(host[:, 1].sum())}


@contextlib.contextmanager
def _trainable(module, mask):
    """``requires_grad`` set from ``mask`` (a set of names; None: all) for
    the block, the module's own flags restored after it."""
    before = [(p, p.requires_grad) for p in module.parameters()]
    try:
        for n, p in module.named_parameters():
            p.requires_grad_(mask is None or n in mask)
        yield
    finally:
        for p, flag in before:
            p.requires_grad_(flag)


def _batches(loader: DataLoader, fills, device):
    """The loader's batches padded to its batch size (``pad_batch_to``) and
    moved to ``device`` ahead of use; ids as int64."""
    padded = (pad_batch_to(b, loader.batch_size, fills)[0] for b in loader)
    for batch in prefetch_to_device(padded, device=device):
        yield tuple(x if x.is_floating_point() else x.long() for x in batch)


def _log_entry(log, epoch, entry):
    log(f"epoch {epoch}: " + "  ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in entry.items()))


def _jax_tree(params):
    """{"encoder", "head"} modules -> the JAX package's tree (numpy)."""
    return {"encoder": to_jax_encoder(params["encoder"]), "head": to_jax_head(params["head"])}


def train_char_asr(params, encoder_apply: Callable, train_loader: DataLoader,
                   val_loader: Optional[DataLoader], vocab: CharVocabulary, *,
                   head_kind: str = "lstm", epochs: int = 10, learning_rate: float = 1e-4,
                   weight_decay: float = 0.01, trainable_mask=None,
                   checkpoint_dir: str = "checkpoints/char_asr",
                   history_path: Optional[str] = None, resume_from: Optional[str] = None,
                   real_decode: bool = False, log: Callable = print) -> Dict:
    """AdamW + cosine, clip 1.0, dual best-CER/WER checkpoints.
    ``resume_from`` loads a checkpoint's encoder and head (the JAX layout)
    into the modules before training."""
    from .checkpoint import load_pytree
    from .schedule import cosine

    module = as_module(params)
    if resume_from:
        tree = load_pytree(resume_from)
        with torch.no_grad():
            module["encoder"].load_state_dict(from_jax_encoder(tree["encoder"], None, ""))
            module["head"].load_state_dict(from_jax_head(tree["head"]))
        log(f"resumed params from {resume_from}")
    dev = next(module.parameters()).device
    steps_per_epoch = max(len(train_loader), 1)
    tx = make_optimizer(cosine(learning_rate, epochs * steps_per_epoch),
                        weight_decay=weight_decay, trainable_mask=trainable_mask)
    step = make_train_step(char_asr_loss_fn(encoder_apply, head_kind), tx)
    tracker = BestTracker(checkpoint_dir, {"cer": "min", "wer": "min"})
    if resume_from:
        tracker.seed_from_disk()
    history = TrainingHistory(history_path)
    history.config = {"head": head_kind, "epochs": epochs, "lr": learning_rate,
                      "num_chars": vocab.num_chars}
    with _trainable(module, tx.trainable_mask):
        state = init_state(module, tx)
        for epoch in range(epochs):
            t0 = time.time()
            step_metrics = []
            for mel, char_ids in _batches(train_loader, (None, PAD), dev):
                state, m = step(state, mel, char_ids)
                step_metrics.append(m)
            entry = {"epoch": epoch, **_epoch_stats(step_metrics), "time_s": time.time() - t0}
            if val_loader is not None:
                val = evaluate_char_asr(module, encoder_apply, head_kind, val_loader, vocab,
                                        real_decode=real_decode)
                entry.update({f"val_{k}": v for k, v in val.items()})
                tracker.update({"cer": val["cer"], "wer": val["wer"]},
                               lambda: _jax_tree(module),
                               {"epoch": epoch, "char_vocab": vocab.to_json()})
            history.log(**entry)
            _log_entry(log, epoch, entry)
    return {"params": params, "history": history, "tracker": tracker}


def train_classifier(params, encoder_apply: Callable, train_loader: DataLoader,
                     val_loader: Optional[DataLoader], *, epochs: int = 10,
                     learning_rate: float = 1e-4, weight_decay: float = 0.01,
                     trainable_mask=None, checkpoint_dir: str = "checkpoints/classifier",
                     history_path: Optional[str] = None, log: Callable = print) -> Dict:
    """AdamW + cosine; triple best-accuracy/loss/WER checkpoints."""
    from .schedule import cosine

    module = as_module(params)
    dev = next(module.parameters()).device
    steps_per_epoch = max(len(train_loader), 1)
    tx = make_optimizer(cosine(learning_rate, epochs * steps_per_epoch),
                        weight_decay=weight_decay, trainable_mask=trainable_mask)
    step = make_train_step(classifier_loss_fn(encoder_apply), tx)
    tracker = BestTracker(checkpoint_dir, {"accuracy": "max", "loss": "min", "wer": "min"})
    history = TrainingHistory(history_path)
    history.config = {"epochs": epochs, "lr": learning_rate}
    with _trainable(module, tx.trainable_mask):
        state = init_state(module, tx)
        for epoch in range(epochs):
            t0 = time.time()
            step_metrics = []
            for mel, labels in _batches(train_loader, (None, -1), dev):
                state, m = step(state, mel, labels)
                step_metrics.append(m)
            entry = {"epoch": epoch, **_epoch_stats(step_metrics), "time_s": time.time() - t0}
            if val_loader is not None:
                val = evaluate_classifier(module, encoder_apply, val_loader)
                entry.update({f"val_{k}": v for k, v in val.items()})
                tracker.update(val, lambda: _jax_tree(module), {"epoch": epoch})
            history.log(**entry)
            _log_entry(log, epoch, entry)
    return {"params": params, "history": history, "tracker": tracker}


@torch.inference_mode()
def _token_validation(module, dims, tokenizer, loader: DataLoader, compute_dtype, mesh=None):
    """Teacher-forced validation: the loss and the argmax WER/CER of one
    forward a batch (the JAX package runs the same forward twice, for the
    loss and for the argmax).  Under ``mesh`` the forward routes as the
    train step's: each data rank runs its rows of the batch (padded to the
    data extent), the loss is the global mean and the argmax rows are
    gathered, so every rank returns the same numbers."""
    from ..parallel import DATA_AXIS, all_gather, axis_size, pad_batch_to_mesh, shard_batch
    from .loss import shifted_token_loss

    dev = next(module.parameters()).device
    dt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    preds, refs, vlosses = [], [], []
    for batch in loader:
        (mel, tokens), real = pad_batch_to(batch, loader.batch_size, (None, -100))
        mel_d = torch.from_numpy(np.ascontiguousarray(mel)).to(dev)
        tok_d = torch.from_numpy(np.ascontiguousarray(tokens)).long().to(dev)
        if axis_size(mesh, DATA_AXIS) > 1:
            (mel_d, tok_d), rows = pad_batch_to_mesh((mel_d, tok_d), mesh)
            # the padding rows repeat the last one: mask their targets out
            tok_d[rows:] = -100
            mel_d, tok_d = shard_batch((mel_d, tok_d), mesh)
        logits = cmodel.forward(module, mel_d, tok_d.clamp_min(0), dims, dt, mesh=mesh)
        vlosses.append(float(shifted_token_loss(logits, tok_d, mesh=mesh)))
        out = logits.argmax(-1)
        if axis_size(mesh, DATA_AXIS) > 1:
            out = all_gather(out, mesh, DATA_AXIS, 0)
        out = out.cpu().numpy()
        tok_np = np.asarray(tokens)
        for b in range(real):
            valid = tok_np[b] != -100
            ref_ids = [t for t in tok_np[b][valid].tolist() if t < tokenizer.eot]
            hyp_ids = [t for t in out[b][:-1][valid[1:]].tolist() if t < tokenizer.eot]
            refs.append(tokenizer.decode(ref_ids))
            preds.append(tokenizer.decode(hyp_ids))
    return {"val_loss": float(np.mean(vlosses)) if vlosses else 0.0,
            "val_wer": qmetrics.calculate_wer(preds, refs),
            "val_cer": qmetrics.calculate_cer(preds, refs)}


def train_token_asr(params, dims, tokenizer, train_loader: DataLoader,
                    val_loader: Optional[DataLoader], *, epochs: int = 10,
                    learning_rate: float = 1e-4, warmup_steps: int = 500,
                    weight_decay: float = 0.01, checkpoint_dir: str = "checkpoints/token_asr",
                    history_path: Optional[str] = None, compute_dtype: str = "float32",
                    mesh=None, fsdp: bool = False, grad_accum: int = 1,
                    save_state_every: int = 0, resume_state: Optional[str] = None,
                    log: Callable = print) -> Dict:
    """Token-level training of a ``Whisper`` module: AdamW(0.9, 0.98, 1e-6)
    + linear-warmup-cosine, best-WER checkpoint (the JAX layout).

    ``grad_accum`` > 1 takes one optimizer step over that many
    micro-batches (the batch size must divide by it; exactly the
    full-batch step).  ``save_state_every`` > 0 writes the full train
    state every N epochs (``state_epoch_N``) and beside each new best WER
    (``best_wer_state``); ``resume_state`` restores such a state and
    continues at the epoch its step count reaches.

    ``mesh`` (a ``parallel.Mesh``; every rank of it runs this with the same
    loaders) trains on it: the state is placed by ``train.step.
    shard_state`` (``fsdp`` also slices the parameters and moments along
    ``data``), each step takes this data rank's rows of the batch, the
    validation runs under the same mesh, and only the mesh's leader writes
    the history and the best checkpoints (every rank gathers them)."""
    from .. import parallel
    from .checkpoint import restore_train_state, save_train_state
    from .schedule import warmup_cosine
    from .step import (
        make_accum_train_step, make_sharded_train_step, shard_state, whisper_loss_fn,
        whisper_sum_loss_fn,
    )

    if fsdp and mesh is None:
        raise ValueError("fsdp=True requires a mesh (the data extent determines the "
                         "shard layout)")
    module = params
    dev = next(module.parameters()).device
    steps_per_epoch = max(len(train_loader), 1)
    tx = make_optimizer(warmup_cosine(learning_rate, warmup_steps, epochs * steps_per_epoch),
                        weight_decay=weight_decay)
    if grad_accum > 1:
        step = make_accum_train_step(whisper_sum_loss_fn(dims, compute_dtype), tx, grad_accum)
    else:
        step = make_train_step(whisper_loss_fn(dims, compute_dtype), tx)
    if mesh is not None:
        step = make_sharded_train_step(None, tx, mesh, step_fn=step)
    writer = mesh is None or mesh.is_leader
    tracker = BestTracker(checkpoint_dir, {"wer": "min"}, write=writer)
    history = TrainingHistory(history_path if writer else None)
    history.config = {"epochs": epochs, "lr": learning_rate, "warmup": warmup_steps}
    whole = (lambda: to_jax_params(module, dims)) if mesh is None else \
        (lambda: to_jax_params(parallel.full_state_dict(module), dims))
    with _trainable(module, None):
        state = init_state(module, tx)
        if mesh is not None:
            state = shard_state(state, mesh, fsdp=fsdp)
        start_epoch = 0
        if resume_state:
            state = restore_train_state(resume_state, state, mesh=mesh, fsdp=fsdp)
            # the step counts loader batches: step // steps_per_epoch epochs are done
            start_epoch = min(int(state.step) // steps_per_epoch, epochs)
            for ldr in (train_loader, val_loader):
                if hasattr(ldr, "epoch"):
                    ldr.epoch = start_epoch
            tracker.seed_from_disk()
            log(f"resumed full train state from {resume_state} "
                f"(step {int(state.step)}, continuing at epoch {start_epoch})")
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            step_metrics = []
            for mel, tokens in _batches(train_loader, (None, -100), dev):
                state, m = step(state, mel, tokens)
                step_metrics.append(m)
            entry = {"epoch": epoch, **_epoch_stats(step_metrics), "time_s": time.time() - t0}
            if val_loader is not None:
                entry.update(_token_validation(module, dims, tokenizer, val_loader,
                                               compute_dtype, mesh))
                improved = tracker.update({"wer": entry["val_wer"]}, whole, {"epoch": epoch})
                if improved.get("wer") and save_state_every:
                    save_train_state(os.path.join(checkpoint_dir, "best_wer_state"), state,
                                     {"epoch": epoch, "val_wer": entry["val_wer"]})
            if save_state_every and (epoch + 1) % save_state_every == 0:
                save_train_state(os.path.join(checkpoint_dir, f"state_epoch_{epoch}"), state,
                                 {"epoch": epoch})
            history.log(**entry)
            _log_entry(log, epoch, entry)
    return {"params": params, "history": history, "tracker": tracker, "state": state}
