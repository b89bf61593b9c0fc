"""Evaluate a trained quantum Whisper ASR checkpoint on LibriSpeech test.

Port of ``qasr_ijcnlp_tpu/cli/evaluate_quantum_whisper_asr.py``, same
flags: rebuild the quantum model, restore the checkpoint (the JAX package's
numpy pickle, ``--model_path`` + ``.pkl``: the encoder and the head),
greedy char decoding on ``--device`` (the card unless ``cpu`` is asked
for), CER/WER and the CER distribution.

    python -m qasr_ijcnlp_tpu_torch.cli.evaluate_quantum_whisper_asr \\
        --model_path CKPT [--head lstm|mlp] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import metrics as qmetrics
from ..data import CharASRView, CharVocabulary, END, START, load_librispeech
from ..data.loader import DataLoader, pad_batch_to
from ..models import asr as asr_model
from ..models.convert import from_jax_encoder, from_jax_head
from ..models.quantum import create_quantum_whisper_tiny
from ..reporting import analyze_predictions, plot_cer_distribution, save_results_json
from ..train.checkpoint import load_metadata, load_pytree
from ..train.loops import encoder_fn_for
from . import load_checkpoint_into, resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, required=True,
                   help="Path of a trained checkpoint (the JAX package's "
                        "numpy pickle is read from PATH.pkl)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--n_qubits", type=int, default=4)
    p.add_argument("--hidden_size", type=int, default=384)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--head", type=str, default="lstm", choices=["lstm", "mlp"])
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--max_text_len", type=int, default=100)
    p.add_argument("--real_decode", action="store_true",
                   help="Decode the MLP head autoregressively instead of "
                        "the reference's teacher-forced argmax")
    return p


def _vocabulary(model_path: str) -> CharVocabulary:
    meta = load_metadata(model_path) or {}
    if "char_vocab" in meta:
        return CharVocabulary.from_json(meta["char_vocab"])
    # the training history's config, as the reference rebuilds it
    hist = "quantum_whisper_asr_training_history.json"
    if os.path.exists(hist):
        with open(hist) as f:
            cfg = json.load(f).get("config", {})
        return CharVocabulary.from_json(cfg["char_vocab"])
    raise SystemExit("No char vocabulary found in checkpoint metadata or history JSON")


@torch.inference_mode()
def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    vocab = _vocabulary(args.model_path)

    model = create_quantum_whisper_tiny(n_qubits=args.n_qubits, device=device)
    init = (asr_model.init_lstm_decoder if args.head == "lstm"
            else asr_model.init_mlp_head)
    head = init(torch.Generator().manual_seed(0), model.dims.n_audio_state,
                vocab.num_chars, args.hidden_size, args.num_layers)
    tree = load_pytree(args.model_path)
    load_checkpoint_into(model.module.encoder, from_jax_encoder(tree["encoder"], model.dims, ""),
                         device)
    head = load_checkpoint_into(head, from_jax_head(tree["head"]), device)
    params = {"encoder": model.module.encoder, "head": head}

    base = load_librispeech("test", args.max_samples or 32)
    loader = DataLoader(CharASRView(base, vocab, args.max_text_len, device=device),
                        args.batch_size, shuffle=False)
    encoder_apply = encoder_fn_for(model)

    predictions, targets = [], []
    for batch in loader:
        (mel, char_ids), real = pad_batch_to(batch, args.batch_size)
        enc = encoder_apply(params["encoder"], torch.from_numpy(mel).to(device))
        if args.head == "lstm":
            out, _ = asr_model.lstm_greedy_decode(head, enc, START, END, args.max_text_len)
        elif args.real_decode:
            out, _ = asr_model.mlp_greedy_decode(head, enc, START, END, args.max_text_len)
        else:
            ids = torch.from_numpy(char_ids).long().to(device)
            out = asr_model.mlp_head_char_logits(head, enc, ids).argmax(-1)
        out = out.cpu().numpy()
        for b in range(real):
            predictions.append(vocab.decode(out[b]))
            targets.append(vocab.decode(np.asarray(char_ids[b][1:])))

    cer = qmetrics.calculate_cer(predictions, targets)
    wer = qmetrics.calculate_wer(predictions, targets)
    print(f"\nTest CER: {cer:.4f}  WER: {wer:.4f}  n={len(predictions)}")
    analyze_predictions(predictions, targets)
    per_sample = [qmetrics.calculate_cer([p], [t]) for p, t in zip(predictions, targets)]
    plot_cer_distribution(per_sample, "quantum_asr_cer_distribution.png")
    save_results_json("quantum_whisper_asr_evaluation_results.json", {
        "model_path": args.model_path,
        "cer": cer,
        "wer": wer,
        "num_samples": len(predictions),
        "used_dummy_dataset": bool(getattr(base, "is_synthetic", False)),
    })
    return {"cer": cer, "wer": wer, "predictions": predictions}


if __name__ == "__main__":
    main()
