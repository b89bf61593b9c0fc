"""Evaluation metrics: CER/WER with the reference's conventions.

Port of ``qasr_ijcnlp_tpu/metrics/__init__.py``.  Three error-rate
definitions, as the reference wires them:

* :func:`calculate_cer`: per-sample char error rate, averaged over samples;
* :func:`calculate_cer_pure`: total char edits / total reference chars;
* :func:`calculate_wer`: corpus word error rate, total word edits / total
  reference words; :func:`calculate_wer_per_sample_mean` is the reference's
  per-sample fallback.

Host code.  The Levenshtein core is the port's copy of the JAX package's
C++ (``native/editdist.cpp``, built by ``_native.py``), with the numpy
two-row DP where no ``g++`` builds it.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from .normalizers import (  # noqa: F401
    BasicTextNormalizer,
    EnglishNumberNormalizer,
    EnglishSpellingNormalizer,
    EnglishTextNormalizer,
)

_NATIVE_LEV = "unset"


def _native_lev():
    global _NATIVE_LEV
    if _NATIVE_LEV == "unset":
        try:
            from .._native import native_levenshtein

            _NATIVE_LEV = native_levenshtein if native_levenshtein([1], [1]) == 0 else None
        except Exception:
            _NATIVE_LEV = None
    return _NATIVE_LEV


def levenshtein(ref: Sequence, hyp: Sequence) -> int:
    """Edit distance (insert, delete, substitute: cost 1): the C++ core,
    else a vectorized numpy two-row DP."""
    if len(ref) == 0:
        return len(hyp)
    if len(hyp) == 0:
        return len(ref)
    # int ids, so the comparison is integer equality
    vocab = {}
    r = np.asarray([vocab.setdefault(x, len(vocab)) for x in ref])
    h = np.asarray([vocab.setdefault(x, len(vocab)) for x in hyp])
    native = _native_lev()
    if native is not None:
        return native(r, h)
    m = len(h)
    pos = np.arange(m + 1)
    prev = pos.copy()
    for i, ri in enumerate(r, start=1):
        # t[j] = min(substitute, delete) for j = 1..m; the insert chain
        # cur[j] = min(t[j], cur[j-1] + 1) unrolls to a prefix-min over t[k] - k.
        t = np.minimum(prev[:-1] + (h != ri), prev[1:] + 1)
        chain = np.concatenate(([i], t)) - pos
        prev = np.minimum.accumulate(chain) + pos
    return int(prev[-1])


def _require_parallel_lists(predictions, targets):
    if len(predictions) != len(targets):
        raise ValueError(f"got {len(predictions)} predictions vs {len(targets)} targets")


def calculate_cer(predictions: List[str], targets: List[str]) -> float:
    """Mean per-sample CER."""
    _require_parallel_lists(predictions, targets)
    rates = []
    for pred, tgt in zip(predictions, targets):
        if len(tgt) == 0:
            rates.append(0.0 if len(pred) == 0 else 1.0)
        else:
            rates.append(levenshtein(tgt, pred) / len(tgt))
    return float(np.mean(rates)) if rates else 0.0


def calculate_cer_pure(predictions: List[str], targets: List[str]) -> float:
    """Aggregate CER: total edits / total target chars."""
    _require_parallel_lists(predictions, targets)
    edits = sum(levenshtein(t, p) for p, t in zip(predictions, targets))
    chars = sum(len(t) for t in targets)
    return edits / chars if chars else 0.0


def _words(s: Union[str, List[str]]) -> List[str]:
    return s.split() if isinstance(s, str) else list(s)


def wer_corpus(references: List[str], hypotheses: List[str]) -> float:
    """Corpus WER: total word edits / total reference words (jiwer.wer)."""
    _require_parallel_lists(hypotheses, references)
    edits = sum(levenshtein(_words(r), _words(h)) for r, h in zip(references, hypotheses))
    words = sum(len(_words(r)) for r in references)
    return edits / words if words else 0.0


def calculate_wer(predictions: List[str], targets: List[str]) -> float:
    """The reference's calculate_wer: corpus WER over the lists."""
    return wer_corpus(targets, predictions)


def calculate_wer_per_sample_mean(predictions: List[str], targets: List[str]) -> float:
    """The reference's fallback without jiwer: the mean per-sample WER."""
    _require_parallel_lists(predictions, targets)
    rates = []
    for pred, tgt in zip(predictions, targets):
        tw, pw = _words(tgt), _words(pred)
        if not tw:
            rates.append(0.0 if not pw else 1.0)
        else:
            rates.append(levenshtein(tw, pw) / len(tw))
    return float(np.mean(rates)) if rates else 0.0
