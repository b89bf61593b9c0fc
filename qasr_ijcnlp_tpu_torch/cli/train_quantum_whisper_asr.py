"""Train the quantum Whisper ASR model (char level) on LibriSpeech.

Port of ``qasr_ijcnlp_tpu/cli/train_quantum_whisper_asr.py``, same flags:
quantum tiny (the quantum conv stem on tiny's trunk, official weights
where a checkpoint is at hand, random otherwise), a char vocabulary from
the first 1000 training transcripts, the LSTM char decoder (or ``--head
mlp``), trainable = the quantum layers and the head (the trunk frozen),
AdamW + cosine, best-CER/WER checkpoints (the JAX package's layout) and a
JSON history; on ``--device`` (the card unless ``cpu`` is asked for).

    python -m qasr_ijcnlp_tpu_torch.cli.train_quantum_whisper_asr \\
        --epochs 2 --max_samples 16 [--head mlp] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
from torch import nn

from ..data import CharASRView, CharVocabulary, dataset_texts, load_librispeech
from ..data.loader import DataLoader
from ..models import asr as asr_model
from ..models.quantum import count_params, create_quantum_whisper_tiny, trainable_mask
from ..reporting import print_model_info, print_training_header
from ..train.loops import encoder_fn_for, train_char_asr
from . import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--n_qubits", type=int, default=4)
    p.add_argument("--hidden_size", type=int, default=384)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--head", type=str, default="lstm", choices=["lstm", "mlp"])
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--max_text_len", type=int, default=100)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints/quantum_asr")
    p.add_argument("--resume", type=str, default=None,
                   help="Checkpoint path to resume parameters from")
    p.add_argument("--real_val_decode", action="store_true",
                   help="Validate the MLP head with true autoregressive greedy decoding "
                        "instead of the reference's teacher-forced argmax (LSTM always "
                        "decodes autoregressively)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    model = create_quantum_whisper_tiny(n_qubits=args.n_qubits, device=device)
    train_base = load_librispeech("train.100", args.max_samples or 64)
    val_base = load_librispeech("validation", (args.max_samples or 64) // 4 or 8)
    vocab = CharVocabulary.build(dataset_texts(train_base, 1000))
    print(f"Built character vocabulary with {vocab.num_chars} characters")

    init = asr_model.init_lstm_decoder if args.head == "lstm" else asr_model.init_mlp_head
    head = init(torch.Generator().manual_seed(0), model.dims.n_audio_state, vocab.num_chars,
                args.hidden_size, args.num_layers)
    params = nn.ModuleDict({"encoder": model.module.encoder, "head": head.to(device)})
    mask = trainable_mask(params, extra_names=("head",))
    n_train = sum(p.numel() for n, p in params.named_parameters() if n in mask)
    print_model_info(model.name + f" + {args.head} char decoder", count_params(params), n_train)
    print_training_header("quantum ASR (char-level)", args.epochs, args.lr, args.batch_size)

    train_loader = DataLoader(CharASRView(train_base, vocab, args.max_text_len, device=device),
                              args.batch_size)
    val_loader = DataLoader(CharASRView(val_base, vocab, args.max_text_len, device=device),
                            args.batch_size, shuffle=False)
    out = train_char_asr(
        params, encoder_fn_for(model), train_loader, val_loader, vocab,
        head_kind=args.head, epochs=args.epochs, learning_rate=args.lr, trainable_mask=mask,
        checkpoint_dir=args.checkpoint_dir,
        history_path="quantum_whisper_asr_training_history.json",
        resume_from=args.resume, real_decode=args.real_val_decode,
    )
    print("Training complete. Best:", out["tracker"].best)
    return out


if __name__ == "__main__":
    main()
