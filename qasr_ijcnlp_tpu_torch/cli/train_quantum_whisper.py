"""Train the quantum Whisper classifier (Speech Commands or LibriSpeech).

Port of ``qasr_ijcnlp_tpu/cli/train_quantum_whisper.py``, same flags:
quantum tiny, encoder -> mean-pool -> Linear head, trainable = the quantum
layers and the head, AdamW + cosine, best-accuracy/loss/WER checkpoints
(the JAX package's layout), then the test split through the trained
model.  ``--dataset librispeech`` takes each whole transcript as a class
label (the reference's quirk, kept).  On ``--device`` (the card unless
``cpu`` is asked for).

    python -m qasr_ijcnlp_tpu_torch.cli.train_quantum_whisper \\
        --epochs 2 --max_samples 16 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
from torch import nn

from ..data import (
    SPEECH_COMMANDS_LABELS, ClassificationView, dataset_texts, load_librispeech,
    load_speech_commands,
)
from ..data.loader import DataLoader
from ..models import classifier as clf_model
from ..models.quantum import count_params, create_quantum_whisper_tiny, trainable_mask
from ..reporting import print_model_info, print_training_header
from ..train.loops import encoder_fn_for, evaluate_classifier, train_classifier
from . import load_checkpoint_into, resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--n_qubits", type=int, default=4)
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--dataset", type=str, default="google", choices=["google", "librispeech"])
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints/quantum_classifier")
    return p


def _librispeech_as_classification(split, max_samples):
    """Whole-utterance transcript as the class label."""
    base = load_librispeech(split, max_samples)
    texts = sorted(set(dataset_texts(base)))
    label_of = {t: i for i, t in enumerate(texts)}

    class _View:
        is_synthetic = getattr(base, "is_synthetic", False)

        def __len__(self):
            return len(base)

        def __getitem__(self, i):
            audio, text = base[i]
            return audio, label_of[text]

    return _View(), len(texts)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    n_val = (args.max_samples or 64) // 4 or 8
    if args.dataset == "google":
        train_base = load_speech_commands("train", args.max_samples or 64)
        val_base = load_speech_commands("validation", n_val)
        num_classes = len(SPEECH_COMMANDS_LABELS)
    else:
        train_base, num_classes = _librispeech_as_classification("train.100",
                                                                 args.max_samples or 64)
        val_base, _ = _librispeech_as_classification("validation", n_val)

    model = create_quantum_whisper_tiny(n_qubits=args.n_qubits, device=device)
    if args.pretrained_path:
        from ..models.convert import from_jax_params
        from ..train.checkpoint import load_pytree

        try:  # a whole model in the JAX package's layout, names and shapes matching
            load_checkpoint_into(model.module, from_jax_params(
                load_pytree(args.pretrained_path), model.dims), device)
            print(f"Loaded pretrained weights from {args.pretrained_path}")
        except (OSError, KeyError, ValueError, RuntimeError) as e:
            print(f"Could not load {args.pretrained_path}: {e}; continuing")

    head = clf_model.init_classifier_head(torch.Generator().manual_seed(0),
                                          model.dims.n_audio_state, num_classes)
    params = nn.ModuleDict({"encoder": model.module.encoder, "head": head.to(device)})
    mask = trainable_mask(params, extra_names=("head",))
    n_train = sum(p.numel() for n, p in params.named_parameters() if n in mask)
    print_model_info(f"{model.name} classifier ({num_classes} classes)",
                     count_params(params), n_train)
    print_training_header(f"quantum classification ({args.dataset})", args.epochs, args.lr,
                          args.batch_size)

    train_loader = DataLoader(ClassificationView(train_base, device=device), args.batch_size)
    val_loader = DataLoader(ClassificationView(val_base, device=device), args.batch_size,
                            shuffle=False)
    out = train_classifier(
        params, encoder_fn_for(model), train_loader, val_loader, epochs=args.epochs,
        learning_rate=args.lr, trainable_mask=mask, checkpoint_dir=args.checkpoint_dir,
        history_path="quantum_whisper_training_history.json",
    )

    test_base = (load_speech_commands("test", n_val) if args.dataset == "google"
                 else _librispeech_as_classification("test", n_val)[0])
    test_loader = DataLoader(ClassificationView(test_base, device=device), args.batch_size,
                             shuffle=False)
    test = evaluate_classifier(out["params"], encoder_fn_for(model), test_loader)
    print(f"Test: acc={test['accuracy']:.4f} loss={test['loss']:.4f} wer={test['wer']:.4f}")
    out["test"] = test
    return out


if __name__ == "__main__":
    main()
