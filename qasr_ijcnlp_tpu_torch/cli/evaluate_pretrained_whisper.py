"""Batched greedy-decode evaluation of pretrained Whisper on LibriSpeech.

Port of ``qasr_ijcnlp_tpu/cli/evaluate_pretrained_whisper.py``, same
flags: each clip padded or trimmed to 30 s, the log-mel of a whole eval
batch at once, batched ``decode`` with ``language='en',
without_timestamps=True``, EnglishTextNormalizer on both sides, corpus WER
and pure CER, and RTF (seconds of real speech per wall second); on
``--device`` (the card unless ``cpu`` is asked for).

``--data_parallel`` runs one process per rank under a launcher: each rank's
loader takes its stride of the dataset (``DataLoader(process_index=,
process_count=)`` at the mesh's data rank and extent), an eval batch of
``--batch_size`` rounded up to the data extent is split over the ranks,
each rank decodes its rows, and the hypotheses and clip durations are
gathered, so every rank scores the whole split; rank 0 prints and writes
the results.

    python -m qasr_ijcnlp_tpu_torch.cli.evaluate_pretrained_whisper \\
        --model_size tiny --max_samples 16 [--device cpu]
    torchrun --nproc_per_node 2 -m qasr_ijcnlp_tpu_torch.cli.evaluate_pretrained_whisper \\
        --model_size tiny --max_samples 16 --data_parallel
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import metrics as qmetrics
from .. import parallel
from ..audio import log_mel_spectrogram, pad_or_trim
from ..data import dataset_texts, load_librispeech
from ..data.loader import DataLoader, pad_batch_to
from ..decode import DecodingOptions
from ..reporting import save_results_json
from . import load_model_with_fallback, resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_size", type=str, default="base.en")
    p.add_argument("--split", type=str, default="test-clean")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--device", type=str, default="auto")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--data_parallel", action="store_true",
                   help="one process per rank under torchrun: the eval batch (rounded up "
                        "to a multiple of the ranks) split over every rank")
    return p


_SPLIT_MAP = {"test-clean": "test", "dev-clean": "validation",
              "train-clean-100": "train.100"}


class _AudioView:
    """Padded raw audio and the item's index; the mel runs once per eval
    batch.  Records each clip's true duration, so the RTF counts real
    speech seconds, not the 30-s window."""

    def __init__(self, base):
        self.base = base
        self.durations = np.zeros(len(base))

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        audio, _ = self.base[i]
        self.durations[int(i)] = len(audio) / 16000.0
        return np.asarray(pad_or_trim(audio), np.float32), np.int32(i)


@torch.inference_mode()
def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh, batch_size = None, args.batch_size
    if args.data_parallel:
        parallel.initialize_distributed()
        mesh = parallel.make_mesh(model_parallel=1)
        device = parallel.rank_device(device)
        # degrade, never refuse: the global batch rounded up to the ranks
        batch_size = parallel.round_up_to_mesh(args.batch_size, mesh) // mesh.size
        if mesh.is_leader:
            print(f"Data-parallel eval over {mesh.size} ranks (batch {args.batch_size} -> "
                  f"{batch_size * mesh.size})")
    model = load_model_with_fallback(args.model_size, device=device)
    base = load_librispeech(_SPLIT_MAP.get(args.split, args.split), args.max_samples)
    texts = dataset_texts(base)
    view = _AudioView(base)
    n_data = parallel.axis_size(mesh, parallel.DATA_AXIS)
    loader = DataLoader(view, batch_size, shuffle=False,
                        process_index=mesh.index(parallel.DATA_AXIS) if mesh else 0,
                        process_count=n_data)

    options = DecodingOptions(language="en", without_timestamps=True)
    hypotheses = [None] * len(base)
    t0 = time.time()
    for batch in loader:
        (audio, idx), real = pad_batch_to(batch, batch_size)
        mel = log_mel_spectrogram(torch.from_numpy(audio), model.dims.n_mels, device=device)
        results = model.decode(mel, options)
        for b in range(real):
            hypotheses[int(idx[b])] = results[b].text
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    if mesh is not None:  # every rank's clips, on every rank
        for part in parallel.gather_objects(hypotheses, mesh, parallel.DATA_AXIS):
            hypotheses = [h if h is not None else o for h, o in zip(hypotheses, part)]
        view.durations = np.max(parallel.gather_objects(view.durations, mesh,
                                                        parallel.DATA_AXIS), axis=0)
    wall = time.time() - t0
    rtf = float(view.durations.sum()) / wall
    leader = mesh is None or mesh.is_leader

    normalizer = qmetrics.EnglishTextNormalizer()
    norm_hyps = [normalizer(h) for h in hypotheses]
    norm_refs = [normalizer(t) for t in texts]
    wer = qmetrics.wer_corpus(norm_refs, norm_hyps)
    cer = qmetrics.calculate_cer_pure(norm_hyps, norm_refs)

    result = {"wer": wer, "cer": cer, "rtf": rtf, "hypotheses": hypotheses}
    if not leader:
        return result
    print(f"\nModel: {model.name}  split: {args.split}  n={len(base)}")
    print(f"WER: {wer * 100:.2f} %   CER: {cer * 100:.2f} %")
    print(f"RTF: {rtf:.1f} audio-sec/sec ({wall:.1f}s wall)")
    if getattr(base, "is_synthetic", False):
        print("NOTE: synthetic offline dataset - metrics are not comparable")

    out = args.output or f"pretrained_whisper_{args.model_size}_evaluation_results.json"
    save_results_json(out, {
        "model": model.name,
        "split": args.split,
        "num_samples": len(base),
        "wer": wer,
        "cer": cer,
        "rtf_audio_sec_per_sec": rtf,
        "used_dummy_dataset": bool(getattr(base, "is_synthetic", False)),
        "samples": [{"reference": r, "hypothesis": h}
                    for r, h in list(zip(texts, hypotheses))[:10]],
    })
    print(f"Results saved to {out}")
    return result


if __name__ == "__main__":
    main()
