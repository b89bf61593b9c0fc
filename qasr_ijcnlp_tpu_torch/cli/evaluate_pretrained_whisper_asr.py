"""Per-sample ``model.transcribe`` evaluation on LibriSpeech.

Port of ``qasr_ijcnlp_tpu/cli/evaluate_pretrained_whisper_asr.py``, same
flags: the long-form pipeline on each utterance, uppercase and stripped
punctuation on both sides, CER/WER, a per-sample failure sentinel
(``[TRANSCRIPTION_ERROR]``), the sample analysis and the metric
distributions; on ``--device`` (the card unless ``cpu`` is asked for).

    python -m qasr_ijcnlp_tpu_torch.cli.evaluate_pretrained_whisper_asr \\
        --model_size tiny --max_samples 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import re
import string
import traceback

from .. import metrics as qmetrics
from ..data import load_librispeech
from ..reporting import analyze_predictions, plot_metrics_distribution, save_results_json
from . import load_model_with_fallback, resolve_device

SENTINEL = "[TRANSCRIPTION_ERROR]"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_size", type=str, default="tiny")
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--output", type=str, default=None)
    return p


def _normalize(text: str) -> str:
    """Uppercase, punctuation stripped, whitespace runs to one space."""
    text = text.upper().strip()
    text = text.translate(str.maketrans("", "", string.punctuation))
    return re.sub(r"\s+", " ", text)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = load_model_with_fallback(args.model_size, device=device)
    base = load_librispeech("test", args.max_samples or 16)

    predictions, targets = [], []
    for i in range(len(base)):
        audio, text = base[i]
        try:
            result = model.transcribe(audio, language="en")
            predictions.append(_normalize(result["text"]))
        except Exception as e:  # the per-sample sentinel: one clip never stops the run
            print(f"sample {i}: transcription failed ({type(e).__name__}: {e})")
            traceback.print_exc()
            predictions.append(SENTINEL)
        targets.append(_normalize(text))

    cer = qmetrics.calculate_cer(predictions, targets)
    wer = qmetrics.calculate_wer(predictions, targets)
    print(f"\nCER: {cer:.4f}  WER: {wer:.4f}  n={len(base)}")
    if getattr(base, "is_synthetic", False):
        print("NOTE: synthetic offline dataset - metrics are not comparable")

    analyze_predictions(predictions, targets)
    per_sample = {
        "cer": [qmetrics.calculate_cer([p], [t]) for p, t in zip(predictions, targets)],
        "wer": [qmetrics.calculate_wer_per_sample_mean([p], [t])
                for p, t in zip(predictions, targets)],
    }
    plot_metrics_distribution(per_sample, "metrics_distribution.png")

    out = args.output or f"pretrained_whisper_{args.model_size}_asr_evaluation_results.json"
    save_results_json(out, {
        "model": model.name,
        "cer": cer,
        "wer": wer,
        "num_samples": len(base),
        "used_dummy_dataset": bool(getattr(base, "is_synthetic", False)),
    })
    print(f"Results saved to {out}")
    return {"cer": cer, "wer": wer, "predictions": predictions}


if __name__ == "__main__":
    main()
