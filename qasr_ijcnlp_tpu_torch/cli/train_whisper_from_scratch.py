"""Train a (scaled) quantum Whisper from scratch on LibriSpeech.

Port of ``qasr_ijcnlp_tpu/cli/train_whisper_from_scratch.py``, same flags:
an 8-qubit quantum conv stem on a randomly initialized tiny trunk
(``models.quantum.init_quantum_params`` from a seeded ``torch.Generator``)
and the LSTM char decoder, trained end to end with nothing frozen, best-CER
and best-WER checkpoints (the JAX package's layout) and a JSON history; on
``--device`` (the card unless ``cpu`` is asked for).  On the card every
trunk weight's gradient runs through the encoder kernels' autograd
Functions (K4, K5/K6).

    python -m qasr_ijcnlp_tpu_torch.cli.train_whisper_from_scratch \\
        --epochs 2 --max_samples 16 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
from torch import nn

from ..data import CharASRView, CharVocabulary, dataset_texts, load_librispeech
from ..data.loader import DataLoader
from ..models import asr as asr_model
from ..models.dims import tiny_dims
from ..models.quantum import QuantumWhisperModel, count_params, init_quantum_params
from ..reporting import print_model_info, print_training_header
from ..train.loops import encoder_fn_for, train_char_asr
from . import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--n_qubits", type=int, default=8)
    p.add_argument("--hidden_size", type=int, default=384)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--max_text_len", type=int, default=100)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints/from_scratch")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    dims = tiny_dims()
    gen = torch.Generator().manual_seed(0)
    model = QuantumWhisperModel.from_state_dict(
        init_quantum_params(gen, dims, n_qubits=args.n_qubits), dims, device,
        name=f"quantum-tiny (from scratch, {args.n_qubits} qubits)")

    train_base = load_librispeech("train.100", args.max_samples or 64)
    val_base = load_librispeech("validation", (args.max_samples or 64) // 4 or 8)
    vocab = CharVocabulary.build(dataset_texts(train_base, 1000))
    head = asr_model.init_lstm_decoder(gen, dims.n_audio_state, vocab.num_chars,
                                       args.hidden_size, args.num_layers)
    params = nn.ModuleDict({"encoder": model.module.encoder, "head": head.to(device)})

    print_model_info(f"quantum whisper from scratch ({args.n_qubits} qubits)",
                     count_params(params), count_params(params))
    print_training_header("from-scratch quantum ASR", args.epochs, args.lr, args.batch_size)

    train_loader = DataLoader(CharASRView(train_base, vocab, args.max_text_len, device=device),
                              args.batch_size)
    val_loader = DataLoader(CharASRView(val_base, vocab, args.max_text_len, device=device),
                            args.batch_size, shuffle=False)
    out = train_char_asr(
        params, encoder_fn_for(model), train_loader, val_loader, vocab,
        head_kind="lstm", epochs=args.epochs, learning_rate=args.lr,
        trainable_mask=None,  # nothing frozen: true from-scratch training
        checkpoint_dir=args.checkpoint_dir,
        history_path="whisper_from_scratch_training_history.json",
    )
    print("Training complete. Best:", out["tracker"].best)
    return out


if __name__ == "__main__":
    main()
