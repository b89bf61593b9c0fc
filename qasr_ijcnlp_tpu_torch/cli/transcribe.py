"""The ``whisper``-style transcription CLI on the port.

``python -m qasr_ijcnlp_tpu_torch.cli.transcribe audio.wav --model PATH``:
the flags of ``qasr_ijcnlp_tpu/cli/transcribe.py`` (the reference's
transcribe.py:517-620), its writers and per-file error handling.
``--device auto`` is the card; ``--device cpu`` runs on the CPU.
``--draft_model NAME`` (or ``lookup``) decodes greedy windows speculatively.
"""

from __future__ import annotations

import argparse
import os
import traceback
import warnings

import numpy as np

from ..tokenizer import LANGUAGES, TO_LANGUAGE_CODE
from ..transcribe import transcribe
from ..transcribe.writers import get_writer
from ..utils import optional_float, optional_int, str2bool
from . import load_model_with_fallback, resolve_device


def build_parser():
    from ..models.registry import available_models

    def valid_model_name(name):
        if name in available_models() or os.path.exists(name):
            return name
        raise ValueError(
            f"model should be one of {available_models()} or a checkpoint path"
        )

    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    p.add_argument("audio", nargs="+", type=str, help="audio file(s) to transcribe")
    p.add_argument("--model", default="turbo", type=valid_model_name)
    p.add_argument("--model_dir", type=str, default=None)
    p.add_argument("--device", default="auto")
    p.add_argument("--output_dir", "-o", type=str, default=".")
    p.add_argument("--output_format", "-f", type=str, default="all",
                   choices=["txt", "vtt", "srt", "tsv", "json", "all"])
    p.add_argument("--verbose", type=str2bool, default=True)
    p.add_argument("--task", type=str, default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--language", type=str, default=None,
                   choices=sorted(LANGUAGES.keys())
                   + sorted(k.title() for k in TO_LANGUAGE_CODE.keys()))
    p.add_argument("--temperature", type=float, default=0)
    p.add_argument("--best_of", type=optional_int, default=5)
    p.add_argument("--beam_size", type=optional_int, default=5)
    p.add_argument("--patience", type=float, default=None)
    p.add_argument("--length_penalty", type=float, default=None)
    p.add_argument("--suppress_tokens", type=str, default="-1")
    p.add_argument("--initial_prompt", type=str, default=None)
    p.add_argument("--carry_initial_prompt", type=str2bool, default=False)
    p.add_argument("--condition_on_previous_text", type=str2bool, default=True)
    p.add_argument("--fp16", type=str2bool, default=True)
    p.add_argument("--temperature_increment_on_fallback", type=optional_float,
                   default=0.2)
    p.add_argument("--compression_ratio_threshold", type=optional_float,
                   default=2.4)
    p.add_argument("--logprob_threshold", type=optional_float, default=-1.0)
    p.add_argument("--no_speech_threshold", type=optional_float, default=0.6)
    p.add_argument("--word_timestamps", type=str2bool, default=False)
    p.add_argument("--prepend_punctuations", type=str, default="\"'“¿([{-")
    p.add_argument("--append_punctuations", type=str,
                   default="\"'.。,，!！?？:：”)]}、")
    p.add_argument("--highlight_words", type=str2bool, default=False)
    p.add_argument("--max_line_width", type=optional_int, default=None)
    p.add_argument("--max_line_count", type=optional_int, default=None)
    p.add_argument("--max_words_per_line", type=optional_int, default=None)
    p.add_argument("--threads", type=optional_int, default=0)
    p.add_argument("--clip_timestamps", type=str, default="0")
    p.add_argument("--hallucination_silence_threshold", type=optional_float)
    p.add_argument("--batch_windows", type=optional_int, default=None,
                   help="decode all 30s windows as device batches of this "
                        "size (disables cross-window prompt conditioning)")
    p.add_argument("--kv_int8", type=str2bool, default=False,
                   help="int8-quantized cross-attention KV cache (the int8 "
                        "decode kernel; logits perturbed ~1e-2)")
    p.add_argument("--draft_model", default=None,
                   type=lambda n: n if n == "lookup" else valid_model_name(n),
                   help="speculative greedy decoding: this smaller model drafts "
                        "tokens the main model verifies in slab forwards "
                        "(token-exact; greedy windows only); 'lookup' drafts by "
                        "copying earlier n-grams of the transcript instead")
    p.add_argument("--draft_gamma", type=int, default=4,
                   help="tokens drafted per speculative round")
    p.add_argument("--prompt_bucket", type=optional_int, default=None,
                   help="trim conditioning prompts to a multiple of this "
                        "many tokens (may change transcripts; None = exact "
                        "reference prompt handling)")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv).__dict__
    model_name = args.pop("model")
    model_dir = args.pop("model_dir")
    output_dir = args.pop("output_dir")
    output_format = args.pop("output_format")
    device = resolve_device(args.pop("device"))
    draft_name, draft_gamma = args.pop("draft_model"), args.pop("draft_gamma")
    os.makedirs(output_dir, exist_ok=True)

    if model_name.endswith(".en") and args["language"] not in {"en", "English"}:
        if args["language"] is not None:
            warnings.warn(
                f"{model_name} is an English-only model but received "
                f"'{args['language']}'; using English instead."
            )
        args["language"] = "en"

    temperature = args.pop("temperature")
    if (increment := args.pop("temperature_increment_on_fallback")) is not None:
        temperature = tuple(np.arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

    if threads := args.pop("threads"):
        import torch

        torch.set_num_threads(threads)

    model = load_model_with_fallback(model_name, device=device, download_root=model_dir)
    if draft_name is not None:
        from ..decode import Draft

        if args.get("beam_size") is not None:
            warnings.warn("--draft_model accelerates GREEDY decoding only; pass "
                          "--beam_size None (and keep temperature 0) for the speculative "
                          "path to engage on beam-default windows")
        args["draft"] = Draft(
            None if draft_name == "lookup"
            else load_model_with_fallback(draft_name, device=device, download_root=model_dir),
            draft_gamma)

    writer = get_writer(output_format, output_dir)
    word_options = ["highlight_words", "max_line_count", "max_line_width",
                    "max_words_per_line"]
    if not args["word_timestamps"]:
        for option in word_options:
            if args[option]:
                parser.error(f"--{option} requires --word_timestamps True")
    if args["max_line_count"] and not args["max_line_width"]:
        warnings.warn("--max_line_count has no effect without --max_line_width")
    if args["max_words_per_line"] and args["max_line_width"]:
        warnings.warn("--max_words_per_line has no effect with --max_line_width")
    writer_args = {arg: args.pop(arg) for arg in word_options}

    for audio_path in args.pop("audio"):
        try:
            result = transcribe(model, audio_path, temperature=temperature, **args)
            writer(result, audio_path, **writer_args)
        except Exception:
            traceback.print_exc()
            print(f"Skipping {audio_path} due to an error")


if __name__ == "__main__":
    main()
