"""Datasets and host-side loading: LibriSpeech, Speech Commands, char vocab.

Port of ``qasr_ijcnlp_tpu/data/__init__.py``:

* char-level LibriSpeech ASR items: mel (n_mels, 3000) and <START>...<END>
  char indices padded to ``max_text_len`` (:class:`CharASRView`);
* whole-utterance token-level items (:class:`TokenASRView`);
* Speech Commands classification items (:class:`ClassificationView`);
* the dataset fallback chain ending in a deterministic synthetic set,
  flagged by ``.is_synthetic``.  The synthetic audio is bit for bit the
  JAX package's (the same sha1-seeded numpy generator).

The views compute each item's log-mel with the port's
``log_mel_spectrogram`` on ``device`` (the card unless the caller asks for
the CPU: K1 there) and return it as a numpy array, as the JAX views do.
The port opens no network connection: the real sets load only from a local
``datasets.save_to_disk`` copy passed as ``data_dir``; without one the
chain ends in the synthetic set, as it does offline in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..audio import N_FRAMES, SAMPLE_RATE, log_mel_spectrogram, pad_or_trim

SPEECH_COMMANDS_LABELS = [
    "backward", "bed", "bird", "cat", "dog", "down", "eight", "five",
    "follow", "forward", "four", "go", "happy", "house", "learn", "left",
    "marvin", "nine", "no", "off", "on", "one", "right", "seven", "sheila",
    "six", "stop", "three", "tree", "two", "up", "visual", "wow", "yes",
    "zero",
]


# ---------------------------------------------------------------------------
# Character vocabulary
# ---------------------------------------------------------------------------

PAD, UNK, START, END = 0, 1, 2, 3
_SPECIALS = ["<PAD>", "<UNK>", "<START>", "<END>"]


@dataclass
class CharVocabulary:
    """Char↔index mapping with the reference's special-token layout
    (librispeech_asr.py:186-217; the 'UNK' vs '<UNK>' quirk is fixed —
    SURVEY.md §2.4)."""

    char_to_idx: Dict[str, int]

    @classmethod
    def build(cls, texts: Sequence[str]) -> "CharVocabulary":
        chars = set()
        for text in texts:
            chars.update(text.lower())
        ordered = sorted(c for c in chars if c not in _SPECIALS)
        mapping = {tok: i for i, tok in enumerate(_SPECIALS)}
        mapping.update({c: i + 4 for i, c in enumerate(ordered)})
        return cls(mapping)

    @property
    def num_chars(self) -> int:
        return len(self.char_to_idx)

    @property
    def idx_to_char(self) -> Dict[int, str]:
        return {i: c for c, i in self.char_to_idx.items()}

    def encode(self, text: str, max_len: int = 100) -> np.ndarray:
        """<START> text <END>, padded/truncated to ``max_len``
        (librispeech_asr.py:102-127)."""
        ids = [START]
        for ch in text.lower():
            ids.append(self.char_to_idx.get(ch, UNK))
        ids = ids[: max_len - 1]
        ids.append(END)
        out = np.full(max_len, PAD, np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        inv = self.idx_to_char
        chars = []
        for i in ids:
            i = int(i)
            if i == END:
                break
            if i in (PAD, START):
                continue
            chars.append(inv.get(i, ""))
        return "".join(chars)

    def to_json(self) -> str:
        return json.dumps(self.char_to_idx)

    @classmethod
    def from_json(cls, s: str) -> "CharVocabulary":
        return cls({k: int(v) for k, v in json.loads(s).items()})


def build_character_vocabulary(texts: Sequence[str]) -> Tuple[Dict[str, int], int]:
    """Reference-signature wrapper returning (char_to_idx, num_chars)."""
    vocab = CharVocabulary.build(texts)
    return vocab.char_to_idx, vocab.num_chars


# ---------------------------------------------------------------------------
# Synthetic fallback corpus (deterministic, offline)
# ---------------------------------------------------------------------------

_SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "speech recognition converts audio into text",
    "quantum circuits process amplitudes in superposition",
    "a transformer encoder attends over mel spectrogram frames",
    "the weather today is sunny with a gentle breeze",
    "please remember to validate the dataset before training",
    "character level decoders predict one symbol at a time",
    "tensor processing units multiply large matrices quickly",
    "she sells sea shells by the sea shore",
    "open the pod bay doors please",
]


def _synthetic_utterance(index: int, seconds: float = 3.0) -> Tuple[np.ndarray, str]:
    """Deterministic pseudo-speech: per-sentence formant-ish sine mixture."""
    text = _SENTENCES[index % len(_SENTENCES)]
    seed = int(hashlib.sha1(f"{index}:{text}".encode()).hexdigest()[:8], 16)
    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    f0 = 100 + 50 * rng.random()
    audio = sum(
        a * np.sin(2 * np.pi * (f0 * k + 5 * np.sin(2 * np.pi * 1.3 * t)) * t)
        for k, a in [(1, 0.1), (2, 0.05), (3, 0.02)]
    )
    audio += 0.01 * rng.standard_normal(n)
    return audio.astype(np.float32), text


class SyntheticLibriSpeech:
    """Offline stand-in with the LibriSpeech item contract (audio, text)."""

    is_synthetic = True

    def __init__(self, split: str = "train", size: int = 64):
        self.split = split
        self.size = size
        self._offset = {"train": 0, "validation": 10_000, "test": 20_000}.get(
            split.split(".")[0], 30_000
        )

    def __len__(self):
        return self.size

    def __getitem__(self, i: int) -> Tuple[np.ndarray, str]:
        return _synthetic_utterance(self._offset + i)


class SyntheticSpeechCommands:
    """Offline stand-in with the Speech Commands contract (audio, label_id)."""

    is_synthetic = True

    def __init__(self, split: str = "train", size: int = 64):
        self.split = split
        self.size = size
        self._offset = {"train": 0, "validation": 50_000, "test": 90_000}.get(
            split, 0
        )

    def __len__(self):
        return self.size

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        label = (self._offset + i) % len(SPEECH_COMMANDS_LABELS)
        audio, _ = _synthetic_utterance(self._offset + i, seconds=1.0)
        return audio, label


# ---------------------------------------------------------------------------
# Real datasets (a local copy only) with the synthetic fallback
# ---------------------------------------------------------------------------


def _local_split(data_dir: str, split: str):
    """``split`` of the ``datasets.save_to_disk`` copy at ``data_dir`` (a
    read from disk; nothing is downloaded)."""
    import datasets

    ds = datasets.load_from_disk(data_dir)
    return ds[split] if isinstance(ds, datasets.DatasetDict) else ds


def load_librispeech(split: str = "train.100", max_samples: Optional[int] = None,
                     verbose: bool = True, data_dir: Optional[str] = None):
    """(audio float32 16 kHz, transcript) pairs: LibriSpeech from the local
    copy at ``data_dir`` (columns ``audio`` with an ``array``, and
    ``text``), else the synthetic corpus."""
    try:
        if data_dir is None:
            raise FileNotFoundError("no local LibriSpeech copy given (data_dir)")
        ds = _local_split(data_dir, split)
        if max_samples:
            ds = ds.select(range(min(max_samples, len(ds))))

        class _HFLibriSpeech:
            is_synthetic = False
            _texts = None

            def __len__(self):
                return len(ds)

            def __getitem__(self, i):
                item = ds[i]
                return np.asarray(item["audio"]["array"], np.float32), item["text"]

            def text(self, i):
                # the text column alone: ds[i] would decode the audio too
                if _HFLibriSpeech._texts is None:
                    _HFLibriSpeech._texts = ds["text"]
                return _HFLibriSpeech._texts[i]

        return _HFLibriSpeech()
    except Exception as e:
        if verbose:
            print(f"LibriSpeech unavailable ({type(e).__name__}); "
                  "using the synthetic offline corpus")
        return SyntheticLibriSpeech(split, size=max_samples or 64)


def load_speech_commands(split: str = "train", max_samples: Optional[int] = None,
                         verbose: bool = True, data_dir: Optional[str] = None):
    """(audio float32 16 kHz, label_id in [0, 35)) pairs: Speech Commands
    v0.02 from the local copy at ``data_dir`` (its ClassLabel ids remapped
    by name onto the 35 sorted labels, other classes dropped), else the
    synthetic set."""
    try:
        if data_dir is None:
            raise FileNotFoundError("no local Speech Commands copy given (data_dir)")
        ds = _local_split(data_dir, split)
        target = {name: i for i, name in enumerate(SPEECH_COMMANDS_LABELS)}
        names = ds.features["label"].names
        remap = {i: target[n] for i, n in enumerate(names) if n in target}
        keep = [i for i, lab in enumerate(ds["label"]) if int(lab) in remap]
        if len(keep) != len(ds):
            ds = ds.select(keep)
        if max_samples:
            ds = ds.select(range(min(max_samples, len(ds))))

        class _HFSpeechCommands:
            is_synthetic = False

            def __len__(self):
                return len(ds)

            def __getitem__(self, i):
                item = ds[i]
                return (np.asarray(item["audio"]["array"], np.float32),
                        remap[int(item["label"])])

        return _HFSpeechCommands()
    except Exception as e:
        if verbose:
            print(f"Speech Commands unavailable ({type(e).__name__}); "
                  "using the synthetic offline corpus")
        return SyntheticSpeechCommands(split, size=max_samples or 64)


# ---------------------------------------------------------------------------
# Feature extraction views
# ---------------------------------------------------------------------------


def dataset_texts(base, n: Optional[int] = None) -> List[str]:
    """Transcripts of the first ``n`` items, via the dataset's text-only
    accessor when it has one (skips decoding the audio feature — vocab
    building over 1000 HF rows would otherwise decode 1000 FLAC files)."""
    n = len(base) if n is None else min(n, len(base))
    if hasattr(base, "text"):
        return [base.text(i) for i in range(n)]
    return [base[i][1] for i in range(n)]


def create_dataloader(dataset, batch_size: int = 8, shuffle: bool = True,
                      num_workers: int = 0):
    """Reference-signature loader factory (librispeech_asr.py:225-233);
    ``num_workers`` is accepted for compatibility (prefetching is handled by
    loader.prefetch_to_device)."""
    from .loader import DataLoader

    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle)


def validate_dataset(dataset, num_samples: int = 5, log=print) -> None:
    """Print a sample inspection (reference librispeech_asr.py:235-254)."""
    log(f"Dataset validation - showing {num_samples} samples:")
    log("-" * 60)
    for i in range(min(num_samples, len(dataset))):
        item = dataset[i]
        parts = []
        for field in item:
            arr = np.asarray(field)
            parts.append(f"shape={arr.shape} dtype={arr.dtype}"
                         if arr.ndim else f"value={arr}")
        log(f"Sample {i + 1}: " + "  ".join(parts))
    log(f"Total samples: {len(dataset)}")
    log("-" * 60)


def _mel(audio, n_mels: int, device) -> np.ndarray:
    """One clip padded or trimmed to 30 s -> its (n_mels, 3000) log-mel,
    computed on ``device`` and returned as numpy."""
    mel = log_mel_spectrogram(pad_or_trim(np.asarray(audio, np.float32)), n_mels,
                              device=device)
    return mel.cpu().numpy()


class CharASRView:
    """Dataset view yielding (mel (n_mels, 3000), char_ids (max_text_len,))
    like the reference LibriSpeechASRDataset (librispeech_asr.py:41-130);
    the mel computed on ``device``."""

    def __init__(self, base, vocab: CharVocabulary, max_text_len: int = 100,
                 n_mels: int = 80, device="cuda"):
        self.base = base
        self.vocab = vocab
        self.max_text_len = max_text_len
        self.n_mels = n_mels
        self.device = device

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        audio, text = self.base[i]
        return (_mel(audio, self.n_mels, self.device),
                self.vocab.encode(text, self.max_text_len))

    def texts(self, n: Optional[int] = None) -> List[str]:
        return dataset_texts(self.base, n)


class TokenASRView:
    """Dataset view yielding (mel, token_ids padded with -100) like the
    classical trainer (train_classical_whisper_asr.py:100-176)."""

    def __init__(self, base, tokenizer, max_tokens: int = 448, n_mels: int = 80,
                 uppercase: bool = True, device="cuda"):
        self.base = base
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.n_mels = n_mels
        self.uppercase = uppercase
        self.device = device

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        audio, text = self.base[i]
        mel = _mel(audio, self.n_mels, self.device)
        if self.uppercase:
            text = text.upper()
        tok = self.tokenizer
        ids = [tok.sot, tok.no_timestamps, *tok.encode(" " + text.strip()),
               tok.eot][: self.max_tokens]
        out = np.full(self.max_tokens, -100, np.int32)
        out[: len(ids)] = ids
        return mel, out


class ClassificationView:
    """Dataset view yielding (mel (n_mels, 3000), label) like the Speech
    Commands classifier path (train_quantum_whisper.py:52-77: pad/trim to 30 s
    then re-pad the mel to exactly 3000 frames)."""

    def __init__(self, base, n_mels: int = 80, device="cuda"):
        self.base = base
        self.n_mels = n_mels
        self.device = device

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        audio, label = self.base[i]
        mel = _mel(audio, self.n_mels, self.device)
        if mel.shape[-1] != N_FRAMES:
            mel = np.asarray(pad_or_trim(mel, N_FRAMES))
        return mel, np.int32(label)
