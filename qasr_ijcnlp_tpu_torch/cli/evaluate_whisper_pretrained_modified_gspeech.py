"""Speech-command classification eval with the Whisper encoder.

Port of ``qasr_ijcnlp_tpu/cli/evaluate_whisper_pretrained_modified_gspeech
.py``, same flags: encoder -> mean-pool -> Linear classifier on Google
Speech Commands (or LibriSpeech transcripts as classes), overall and
class-wise accuracy, on ``--device`` (the card unless ``cpu`` is asked
for).  ``--model_size`` takes an official name or a checkpoint path, or
``quantum-<name>`` for that model with a quantum stem (random, seed 0).
``--classifier_path`` restores a trained encoder and head from the JAX
package's numpy pickle.  The forward is deterministic, so one pass serves
all ``--n_repeats`` votes.

    python -m qasr_ijcnlp_tpu_torch.cli.evaluate_whisper_pretrained_modified_gspeech \\
        [--model_size tiny|quantum-tiny] [--classifier_path CKPT] [--device cpu]
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np
import torch

from ..data import (
    ClassificationView,
    SPEECH_COMMANDS_LABELS,
    dataset_texts,
    load_librispeech,
    load_speech_commands,
)
from ..data.loader import DataLoader, pad_batch_to
from ..models import classifier as clf_model
from ..models.convert import from_jax_encoder, from_jax_head
from ..reporting import save_results_json
from ..train.loops import encoder_fn_for
from . import load_checkpoint_into, load_model_with_fallback, resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", type=str, default="google",
                   choices=["google", "librispeech"])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_repeats", type=int, default=10)
    p.add_argument("--model_size", type=str, default="tiny")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--classifier_path", type=str, default=None,
                   help="Optional trained encoder + head checkpoint")
    p.add_argument("--device", type=str, default="auto")
    return p


def _model(name: str, device, n_qubits: int):
    if name.startswith("quantum-"):
        from ..models.quantum import create_quantum_whisper_from_model

        return create_quantum_whisper_from_model(
            load_model_with_fallback(name[len("quantum-"):], device=device), n_qubits)
    return load_model_with_fallback(name, device=device)


@torch.inference_mode()
def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    tree = None
    if args.classifier_path:
        from ..train.checkpoint import load_pytree

        tree = load_pytree(args.classifier_path)
    # a quantum checkpoint's qubit count sizes the quantum stem
    qconv = tree["encoder"].get("qconv1") if tree is not None else None
    model = _model(args.model_size, device, 4 if qconv is None else len(qconv["qweights"]))
    if args.dataset == "google":
        base = load_speech_commands("test", args.max_samples or 32)
        num_classes = len(SPEECH_COMMANDS_LABELS)
        label_names = SPEECH_COMMANDS_LABELS
    else:
        # LibriSpeech as classification: the whole transcript is the class
        libri = load_librispeech("test", args.max_samples or 32)
        texts = sorted(set(dataset_texts(libri)))
        label_of = {t: i for i, t in enumerate(texts)}

        class _View:
            is_synthetic = getattr(libri, "is_synthetic", False)

            def __len__(self):
                return len(libri)

            def __getitem__(self, i):
                audio, text = libri[i]
                return audio, label_of[text]

        base = _View()
        num_classes = len(texts)
        label_names = [t[:20] for t in texts]

    head = clf_model.init_classifier_head(torch.Generator().manual_seed(0),
                                          model.dims.n_audio_state, num_classes)
    if tree is not None:
        load_checkpoint_into(model.module.encoder,
                             from_jax_encoder(tree["encoder"], model.dims, ""), device)
        head = load_checkpoint_into(head, from_jax_head(tree["head"]), device)
    head = head.to(device)
    loader = DataLoader(ClassificationView(base, model.dims.n_mels, device=device),
                        args.batch_size, shuffle=False)
    encoder_apply = encoder_fn_for(model)

    per_class = defaultdict(lambda: [0, 0])
    correct = total = 0
    for batch in loader:
        (mel, labels), real = pad_batch_to(batch, args.batch_size)
        # The reference majority-votes over n_repeats stochastic passes; this
        # forward is deterministic (no dropout, closed-form quantum sim), so
        # the n identical votes are one pass.
        logits = clf_model.classifier_apply(
            head, encoder_apply(model.module.encoder, torch.from_numpy(mel).to(device)))
        pred = logits.argmax(-1).cpu().numpy()
        labels = np.asarray(labels)
        for b in range(real):
            per_class[int(labels[b])][1] += 1
            if pred[b] == labels[b]:
                per_class[int(labels[b])][0] += 1
                correct += 1
            total += 1

    acc = correct / max(total, 1)
    print(f"\nOverall accuracy: {acc:.4f} ({correct}/{total})  n_repeats={args.n_repeats}")
    print("\nClass-wise accuracy:")
    class_acc = {}
    for cid in sorted(per_class):
        hit, n = per_class[cid]
        name = label_names[cid] if cid < len(label_names) else str(cid)
        class_acc[name] = hit / max(n, 1)
        print(f"  {name:<10} {hit}/{n}  ({100.0 * hit / max(n, 1):.1f}%)")
    if getattr(base, "is_synthetic", False):
        print("NOTE: synthetic offline dataset - metrics are not comparable")

    save_results_json("gspeech_classification_results.json", {
        "model": model.name,
        "accuracy": acc,
        "n_repeats": args.n_repeats,
        "num_samples": total,
        "class_accuracy": class_acc,
        "used_dummy_dataset": bool(getattr(base, "is_synthetic", False)),
    })
    return {"accuracy": acc, "class_accuracy": class_acc}


if __name__ == "__main__":
    main()
