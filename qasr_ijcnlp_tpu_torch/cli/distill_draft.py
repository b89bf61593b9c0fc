"""Distill a small DRAFT model from a frozen target for speculative decoding.

Port of ``qasr_ijcnlp_tpu/cli/distill_draft.py``, same flags and flow: the
target and the draft (checkpoints, or random weights with a warning), a
check that they share a vocabulary, log-mels of LibriSpeech clips (a local
copy, else the synthetic set, with a warning; K1 on the card), one batch
held out, the teacher's labels of it, the agreement before, the
distillation (``train/distill.py``), the agreement after, and the draft
written with ``save_model`` (the official ``.pt`` layout, which
``transcribe --draft_model`` and ``DecodingOptions(draft=Draft(...))``
take); on ``--device`` (the card unless ``cpu`` is asked for).

    python -m qasr_ijcnlp_tpu_torch.cli.distill_draft \\
        --model small --draft tiny --steps 2000 --out draft_small.pt [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..audio import log_mel_spectrogram, pad_or_trim
from ..data import load_librispeech
from ..models.registry import save_model
from ..train.distill import agreement_rate, distill_draft, make_teacher_labeler
from . import load_model_with_fallback, resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", type=str, default="small", help="target (teacher) model name")
    p.add_argument("--draft", type=str, default="tiny",
                   help="draft architecture to initialize (model-family name; weights "
                        "from the checkpoint when at hand, else random init)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--tau", type=float, default=1.0, help="distillation temperature")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--n_batches", type=int, default=32,
                   help="distinct audio batches to cycle over")
    p.add_argument("--sample_len", type=int, default=48,
                   help="teacher greedy continuation length per clip")
    p.add_argument("--language", type=str, default="en")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--out", type=str, default="draft_distilled.pt",
                   help="save the distilled draft here (the official .pt layout)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    target = load_model_with_fallback(args.model, device=device)
    draft = load_model_with_fallback(args.draft, device=device)
    if draft.dims.n_vocab != target.dims.n_vocab:
        raise SystemExit(
            f"draft {args.draft} (vocab {draft.dims.n_vocab}) does not share "
            f"the target's tokenizer (vocab {target.dims.n_vocab})")

    n_clips = args.max_samples or args.batch_size * args.n_batches
    base = load_librispeech("train.100", n_clips)
    if getattr(base, "is_synthetic", False):
        print("[distill] WARNING: synthetic audio fallback — the distilled "
              "draft will only track the teacher on synthetic inputs")
    pcm = np.stack([pad_or_trim(np.asarray(base[i][0], np.float32)) for i in range(len(base))])
    mels = log_mel_spectrogram(pcm, target.dims.n_mels, device=device)
    batches = [mels[i: i + args.batch_size]
               for i in range(0, len(mels) - args.batch_size + 1, args.batch_size)]
    held_out = batches.pop() if len(batches) > 1 else batches[0]

    label = make_teacher_labeler(target, args.sample_len, args.language)
    held_tokens = label(held_out)
    before = agreement_rate(target, draft, held_out, held_tokens)

    draft, history = distill_draft(
        target, draft, batches, steps=args.steps, learning_rate=args.lr, tau=args.tau,
        sample_len=args.sample_len, language=args.language,
        on_log=lambda step, loss: print(f"step {step}: kl={loss:.4f}"),
    )

    after = agreement_rate(target, draft, held_out, held_tokens)
    print(f"teacher-argmax agreement (held-out): {before:.3f} -> {after:.3f} "
          f"(per-token acceptance proxy for speculative decode)")
    save_model(draft, args.out)
    print(f"saved distilled draft to {args.out}; use it via "
          f"transcribe --draft_model or DecodingOptions(draft=Draft(...))")
    return {"before": before, "after": after, "history": history}


if __name__ == "__main__":
    main()
