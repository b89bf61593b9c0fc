"""Export the greedy-decode program as a deployment artifact.

Port of ``qasr_ijcnlp_tpu/cli/export_decode.py``, same flags: one
self-describing file (JSON metadata + a ``torch.export`` program with the
weights inside) that a deployment host runs with torch alone to get token
ids; see ``qasr_ijcnlp_tpu_torch/export.py``.  ``--platforms`` names the
device the program runs on (``cuda`` or ``cpu``; default: ``--device``'s),
``--device auto`` is the card and exits with an error where torch sees
none, ``--with_kernels`` keeps the CUDA kernels in the program.

    python -m qasr_ijcnlp_tpu_torch.cli.export_decode --model tiny \\
        --batch 8 --out tiny_decode.qasrt [--quantize int8] [--device cpu]
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", type=str, default="tiny")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--language", type=str, default="en")
    p.add_argument("--task", type=str, default="transcribe")
    p.add_argument("--sample_len", type=int, default=None)
    p.add_argument("--timestamps", action="store_true",
                   help="Include timestamp tokens (default: notimestamps)")
    p.add_argument("--from_mel", action="store_true",
                   help="Artifact takes a (batch, n_mels, 3000) mel instead of raw 30 s audio")
    p.add_argument("--platforms", type=str, default=None, choices=["cuda", "cpu"],
                   help="The device the program runs on (default: --device's). The compute "
                        "dtype is resolved for it: bfloat16 on the card unless --no_fp16")
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--no_fp16", action="store_true")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="Weight-only quantization of the stored weights (per-channel "
                        "symmetric int8 + f32 scales; the decode shifts by the rounding error)")
    p.add_argument("--with_kernels", action="store_true",
                   help="Keep the encoder's CUDA kernels in the program as qasr:: ops "
                        "(card only; load where the same kernel sources and torch run)")
    args = p.parse_args(argv)

    from . import load_model_with_fallback, resolve_device

    device = resolve_device(args.device)
    target = args.platforms or ("cpu" if device == "cpu" else "cuda")

    from ..decode import DecodingOptions
    from ..export import export_greedy_decode, save_artifact

    model = load_model_with_fallback(args.model, device=device)
    opts = DecodingOptions(
        language=args.language, task=args.task, without_timestamps=not args.timestamps,
        sample_len=args.sample_len, fp16=not args.no_fp16,
    )
    exported, meta = export_greedy_decode(
        model, opts, batch=args.batch, from_audio=not args.from_mel, device=target,
        quantize=args.quantize, with_kernels=args.with_kernels,
    )
    save_artifact(args.out, exported, meta)
    print(
        f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB): "
        f"batch={args.batch} device={meta['device']} input={meta['input_shape']} "
        f"quantize={meta['quantize']} with_kernels={meta['with_kernels']}"
    )
    return meta


if __name__ == "__main__":
    main()
