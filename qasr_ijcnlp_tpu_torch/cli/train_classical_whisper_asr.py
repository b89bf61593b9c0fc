"""Token-level Whisper training on LibriSpeech (from re-initialized weights).

Port of ``qasr_ijcnlp_tpu/cli/train_classical_whisper_asr.py``, same
flags: a ``--model_size`` architecture with random weights (seed 0),
tokenizer-space teacher forcing with -100 padding, AdamW(0.9, 0.98, 1e-6)
+ linear-warmup-cosine per step, best-WER checkpoints (the JAX package's
layout), full train states every ``--save_every`` epochs, ``--resume_state``,
``--grad_accum`` and ``--remat``; on ``--device`` (the card unless ``cpu``
is asked for).  ``--model_parallel N`` and ``--fsdp`` train on a (data,
model) mesh of every rank of the job (``parallel.initialize_distributed``
reads torchrun's environment; each rank takes ``parallel.rank_device``):
N-way tensor parallelism, and with ``--fsdp`` the parameters and moments
sliced along ``data`` (ZeRO-3); in one process either runs on a (1, 1)
mesh.  Only the mesh's leader writes the history and the checkpoints.

    python -m qasr_ijcnlp_tpu_torch.cli.train_classical_whisper_asr \\
        --model_size tiny --epochs 2 --batch_size 8 --max_samples 16 \\
        [--grad_accum 2] [--remat] [--device cpu]
    torchrun --nproc_per_node 4 -m qasr_ijcnlp_tpu_torch.cli.train_classical_whisper_asr \\
        --model_size tiny --model_parallel 2 [--fsdp] ...
"""

from __future__ import annotations

import argparse

import torch

from .. import parallel
from ..data import TokenASRView, load_librispeech
from ..data.loader import DataLoader
from ..models import whisper as cmodel
from ..models.dims import dims_for
from ..models.registry import WhisperModel
from ..reporting import print_training_header
from ..tokenizer import get_tokenizer
from ..train.loops import train_token_asr
from . import resolve_device

def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_size", type=str, default="tiny")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_audio_length", type=int, default=30)
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--save_every", type=int, default=5,
                   help="Write a full train state (params + optimizer + step) "
                        "checkpoint every N epochs; 0 disables")
    p.add_argument("--resume_state", type=str, default=None,
                   help="Resume from a full train state checkpoint "
                        "(state_epoch_N / best_wer_state)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="Accumulate gradients over N microbatches per optimizer step "
                        "(batch_size must divide by N); exact full-batch equivalence")
    p.add_argument("--warmup_epochs", type=int, default=3)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--max_tokens", type=int, default=448)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints/classical_asr")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize transformer blocks in backward (less device "
                        "memory, one more forward of each block)")
    p.add_argument("--model_parallel", type=int, default=0,
                   help="Train on a (data, model) mesh of every rank of the job with this "
                        "tensor-parallel degree (0: one rank, no mesh); degraded to a "
                        "divisor of the rank count")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: slice the parameters and Adam moments along the data axis "
                        "(implies a mesh; combine with --model_parallel for TP x FSDP)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.model_parallel or args.fsdp:
        parallel.initialize_distributed()
        device = parallel.rank_device(device)
        mesh = parallel.make_mesh(model_parallel=args.model_parallel or 1)
        print(f"mesh: ({mesh.shape['data']}, {mesh.shape['model']}) (data, model)"
              + (" + fsdp" if args.fsdp else ""))

    dims = dims_for(args.model_size)
    # "From scratch": random init with the official architecture.
    module = WhisperModel.from_state_dict(
        cmodel.init_params(torch.Generator().manual_seed(0), dims), dims, device).module
    tokenizer = get_tokenizer(multilingual=not args.model_size.endswith(".en"),
                              num_languages=99, language="en", task="transcribe")
    train_base = load_librispeech("train.100", args.max_samples or 64)
    val_base = load_librispeech("validation", (args.max_samples or 64) // 4 or 8)
    train_loader = DataLoader(TokenASRView(train_base, tokenizer, args.max_tokens, dims.n_mels,
                                           device=device), args.batch_size)
    val_loader = DataLoader(TokenASRView(val_base, tokenizer, args.max_tokens, dims.n_mels,
                                         device=device), args.batch_size, shuffle=False)

    print_training_header(f"classical whisper {args.model_size} (token-level)", args.epochs,
                          args.lr, args.batch_size)
    steps_per_epoch = max(len(train_loader), 1)
    remat = cmodel._USE_REMAT
    cmodel.set_remat(args.remat or remat)
    try:
        out = train_token_asr(
            module, dims, tokenizer, train_loader, val_loader, epochs=args.epochs,
            learning_rate=args.lr, warmup_steps=args.warmup_epochs * steps_per_epoch,
            checkpoint_dir=args.checkpoint_dir,
            history_path="classical_whisper_asr_training_history.json",
            mesh=mesh, fsdp=args.fsdp,
            grad_accum=args.grad_accum, save_state_every=args.save_every,
            resume_state=args.resume_state,
        )
    finally:
        cmodel.set_remat(remat)
    print("Training complete. Best:", out["tracker"].best)
    return out


if __name__ == "__main__":
    main()
