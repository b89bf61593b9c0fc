"""Word-level timing: median-filtered cross-attention + DTW alignment.

Port of ``qasr_ijcnlp_tpu/align/__init__.py``:

* :func:`median_filter` — width-w sliding median over w shifted copies of
  the reflect-padded input, sorted with ``torch.sort`` (NaN sorts last, as
  in ``jnp.sort``; ``torch.median`` would return the NaN);
* :func:`dtw` — the anti-diagonal wavefront on the host in numpy float32,
  with the JAX recurrence, tie rule and backtrace.  N + M small steps: the
  same loop as device ops would be a few launches per step, all bound by
  launch latency, so the host is the right place (the reference's own
  ``dtw_cpu`` choice);
* :func:`find_alignment` — the teacher-forced cross-QK pass
  (``models.whisper.decoder_apply_with_cross_qk``, plain ``torch.matmul``
  in f32 on the model's device), then z-norm -> median filter -> head mean
  on the device and DTW -> word boundaries on the host;
* :func:`add_word_timestamps` — the duration heuristics and punctuation
  merging, pure host logic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..audio import HOP_LENGTH, SAMPLE_RATE, TOKENS_PER_SECOND
from ..models.whisper import decoder_apply_with_cross_qk
from ..tokenizer import Tokenizer


# ---------------------------------------------------------------------------
# Median filter
# ---------------------------------------------------------------------------


def _median_filter(x: torch.Tensor, width: int) -> torch.Tensor:
    pad = width // 2
    T = x.shape[-1]
    # reflect padding (the edge sample not repeated), as jnp.pad's "reflect"
    idx = torch.cat([
        torch.arange(pad, 0, -1), torch.arange(T), torch.arange(T - 2, T - 2 - pad, -1)
    ]).to(x.device)
    xp = x[..., idx]
    windows = torch.stack([xp[..., k:k + T] for k in range(width)], dim=-2)
    return torch.sort(windows, dim=-2).values[..., pad, :]


def median_filter(x, width: int) -> torch.Tensor:
    """Sliding median along the last axis, reflect-padded (timing.py:19-54);
    inputs no wider than half the filter pass through."""
    assert width > 0 and width % 2 == 1, "`width` should be an odd number"
    x = torch.as_tensor(x)
    if x.shape[-1] <= width // 2:
        return x
    return _median_filter(x, width)


# ---------------------------------------------------------------------------
# DTW
# ---------------------------------------------------------------------------


def _dtw_trace(x: np.ndarray) -> np.ndarray:
    """Wavefront DP over the anti-diagonals i + j = d of cost matrix ``x``
    (N, M) float32: the (N+1, M+1) move matrix (0 diagonal, 1 up, 2 left;
    reference encoding, timing.py:90-103).  A move is 0 only if its cost is
    strictly below both others, 1 likewise, else 2; borders are +inf."""
    N, M = x.shape
    inf = np.float32(np.inf)
    trace = np.full((N + 1, M + 1), -1, np.int8)
    cm2 = np.full(N + 1, inf, np.float32)  # diagonal d - 2 (d = 0: cost[0, 0] = 0)
    cm2[0] = 0.0
    cm1 = np.full(N + 1, inf, np.float32)  # diagonal d - 1 (d = 1: borders)
    for d in range(2, N + M + 1):
        i = np.arange(max(1, d - M), min(N, d - 1) + 1)
        up_prev, up, left = cm2[i - 1], cm1[i - 1], cm1[i]
        t = np.where((up_prev < up) & (up_prev < left), 0,
                     np.where((up < up_prev) & (up < left), 1, 2)).astype(np.int8)
        c = np.where(t == 0, up_prev, np.where(t == 1, up, left))
        new = np.full(N + 1, inf, np.float32)
        new[i] = x[i - 1, d - i - 1] + c
        trace[i, d - i] = t
        cm2, cm1 = cm1, new
    return trace


def _backtrace(trace: np.ndarray) -> np.ndarray:
    """Walk the move matrix from (N, M) to the origin (timing.py:57-79)."""
    i, j = trace.shape[0] - 1, trace.shape[1] - 1
    trace = trace.copy()
    trace[0, :] = 2
    trace[:, 0] = 1
    path = []
    while i > 0 or j > 0:
        path.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(path)[::-1].T


def dtw(x) -> np.ndarray:
    """Minimum-cost monotone alignment path through cost matrix ``x`` (N, M),
    on the host in float32: (2, path_len) text indices and time indices."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return _backtrace(_dtw_trace(np.asarray(x, np.float32)))


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def _alignment_matrix(w: torch.Tensor, qk_scale: float, medfilt_width: int,
                      num_frames_tok: int, t_real: int) -> torch.Tensor:
    """The reference pipeline (timing.py:207-215) over the real rows and
    frames only: slice -> softmax -> z-norm over the token axis (ddof 0) ->
    median filter -> head mean.  ``w`` (n_sel, T, Ta): the selected heads'
    raw cross-attention logits."""
    w = w[:, :t_real, :num_frames_tok]
    w = torch.softmax(w * qk_scale, dim=-1)
    mean = w.mean(dim=-2, keepdim=True)
    std = torch.std(w, dim=-2, keepdim=True, correction=0)
    w = (w - mean) / std
    if num_frames_tok > medfilt_width // 2:
        w = _median_filter(w, medfilt_width)
    return w.mean(dim=0)


def alignment_matrix(
    model_obj,
    tokenizer: Tokenizer,
    text_tokens: List[int],
    mel,
    num_frames: int,
    *,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
    audio_features=None,
):
    """The device half of :func:`find_alignment`: (the alignment matrix over
    the rows [no_timestamps, *text_tokens] and the first num_frames // 2
    frames, numpy float32; each text token's probability, a list).

    ``audio_features`` ((1500, D) or (1, 1500, D)) reuses the window's
    already-encoded features when they are float32; otherwise (a bf16
    decode) the window's ``mel`` is encoded again with ``embed_audio`` in
    the model's ``compute_dtype``, so the alignment's numbers do not depend
    on the decode's dtype.
    """
    tokens = [
        *tokenizer.sot_sequence,
        tokenizer.no_timestamps,
        *text_tokens,
        tokenizer.eot,
    ]
    T_real = len(tokens)
    dev = model_obj.device

    with torch.inference_mode():
        xa = None
        if audio_features is not None:
            feat = torch.as_tensor(audio_features)
            if feat.dtype == torch.float32:
                xa = (feat[None] if feat.dim() == 2 else feat).to(dev)
        if xa is None:
            mel = torch.as_tensor(mel)
            xa = model_obj.embed_audio(mel[None] if mel.dim() == 2 else mel)

        heads = model_obj.alignment_heads
        if heads is None:
            heads = model_obj.default_alignment_heads()
        head_idx = torch.from_numpy(np.flatnonzero(np.asarray(heads).reshape(-1))).to(dev)

        tok = torch.tensor([tokens], dtype=torch.long, device=dev)
        logits, qks = decoder_apply_with_cross_qk(
            model_obj.module.decoder, tok, xa, model_obj.dims)
        # Renormalize over non-special tokens only (timing.py:198-199); row
        # sot_len + k predicts text token k (the no_timestamps token sits
        # between the sot sequence and the text).
        sot_len = len(tokenizer.sot_sequence)
        probs = torch.softmax(logits[0, :, :tokenizer.eot], dim=-1)
        rows = torch.arange(sot_len, sot_len + len(text_tokens), device=dev)
        text_token_probs = probs[rows, torch.tensor(text_tokens, device=dev)]
        L, _, H, T, Ta = qks.shape
        w = qks[:, 0].reshape(L * H, T, Ta)[head_idx]
        matrix = _alignment_matrix(w, float(qk_scale), medfilt_width, num_frames // 2, T_real)
        # Rows [no_timestamps, *text_tokens] take part in the alignment
        # (timing.py:214-216).
        return matrix[sot_len:T_real - 1].cpu().numpy(), text_token_probs.cpu().tolist()


def find_alignment(
    model_obj,
    tokenizer: Tokenizer,
    text_tokens: List[int],
    mel,
    num_frames: int,
    **kwargs,
) -> List[WordTiming]:
    """Token-to-time alignment via cross-attention DTW (timing.py:163-242);
    ``kwargs`` as :func:`alignment_matrix` (``medfilt_width``,
    ``qk_scale``, ``audio_features``)."""
    if len(text_tokens) == 0:
        return []
    if num_frames // 2 == 0:
        # A sliver window shorter than one output frame has nothing to
        # align against (the reference crashes on this edge).
        return []

    matrix, text_token_probs = alignment_matrix(
        model_obj, tokenizer, text_tokens, mel, num_frames, **kwargs)
    return timings_from_matrix(tokenizer, text_tokens, matrix, text_token_probs)


def timings_from_matrix(tokenizer: Tokenizer, text_tokens: List[int], matrix,
                        text_token_probs) -> List[WordTiming]:
    """The host half of :func:`find_alignment`: DTW through ``-matrix``,
    then word boundaries, times and mean token probabilities."""
    text_indices, time_indices = dtw(-matrix)

    words, word_tokens = tokenizer.split_to_word_tokens(
        list(text_tokens) + [tokenizer.eot]
    )
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        float(np.mean(text_token_probs[i:j]))
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]

    return [
        WordTiming(word, toks, start, end, prob)
        for word, toks, start, end, prob in zip(
            words, word_tokens, start_times, end_times, word_probabilities
        )
    ]


def _absorb_timing(src: WordTiming, dst: WordTiming, front: bool) -> None:
    """Move src's text+tokens onto dst (keeping dst's times) and empty src.

    Emptied entries stay in the list rather than being deleted so the
    token-count bookkeeping in add_word_timestamps stays index-stable."""
    if front:
        dst.word = src.word + dst.word
        dst.tokens = src.tokens + dst.tokens
    else:
        dst.word = dst.word + src.word
        dst.tokens = dst.tokens + src.tokens
    src.word = ""
    src.tokens = []


def merge_punctuations(
    alignment: List[WordTiming], prepended: str, appended: str
) -> None:
    """Fold punctuation-only timings into their neighbors (timing.py:245-276).

    Opening marks (tokenized as a space + mark) glue onto the word that
    FOLLOWS them, scanned right-to-left so chains of marks land on the same
    word; closing marks glue onto the word that PRECEDES them, scanned
    left-to-right.
    """
    follower = len(alignment) - 1
    for i in range(len(alignment) - 2, -1, -1):
        cur = alignment[i]
        if cur.word.startswith(" ") and cur.word.strip() in prepended:
            _absorb_timing(cur, alignment[follower], front=True)
        else:
            follower = i

    anchor = 0
    for j in range(1, len(alignment)):
        cur = alignment[j]
        if not alignment[anchor].word.endswith(" ") and cur.word in appended:
            _absorb_timing(cur, alignment[anchor], front=False)
        else:
            anchor = j


_SENTENCE_END_MARKS = ".。!！?？"

# Plausible-duration budget: the per-word duration cap is twice the median
# observed duration, with the median itself capped at 0.7 s; a word sitting
# more than 4 medians after the previous speech is "after a pause"
# (the reference's tuning, timing.py:305-310).
_MEDIAN_DURATION_CAP = 0.7
_MAX_DURATION_RATIO = 2
_PAUSE_MEDIAN_RATIO = 4


def _duration_budget(alignment: List[WordTiming]):
    """(median_duration, max_duration, any_observed) over nonzero words."""
    durations = np.array([w.end - w.start for w in alignment])
    durations = durations[durations.nonzero()]
    median = float(np.median(durations)) if len(durations) else 0.0
    median = min(_MEDIAN_DURATION_CAP, median)
    return median, median * _MAX_DURATION_RATIO, len(durations) > 0


def _clip_sentence_boundary_outliers(
    alignment: List[WordTiming], max_duration: float
) -> None:
    """An over-long word AT a sentence end keeps its start (the DTW smeared
    its end into the pause); one right AFTER a sentence end keeps its end."""
    for k in range(1, len(alignment)):
        if alignment[k].end - alignment[k].start > max_duration:
            if alignment[k].word in _SENTENCE_END_MARKS:
                alignment[k].end = alignment[k].start + max_duration
            elif alignment[k - 1].word in _SENTENCE_END_MARKS:
                alignment[k].start = alignment[k].end - max_duration


def _shorten_first_word_after_pause(
    words: List[dict], last_speech_timestamp: float,
    median_duration: float, max_duration: float,
) -> None:
    """The first word after a long pause must not be implausibly long (the
    DTW tends to stretch it back across the silence): pull its start (and,
    when the second word is also stretched, the shared boundary) forward."""
    stretched = (
        words[0]["end"] - words[0]["start"] > max_duration
        or (
            len(words) > 1
            and words[1]["end"] - words[0]["start"] > max_duration * 2
        )
    )
    after_pause = (
        words[0]["end"] - last_speech_timestamp
        > median_duration * _PAUSE_MEDIAN_RATIO
    )
    if not (after_pause and stretched):
        return
    if len(words) > 1 and words[1]["end"] - words[1]["start"] > max_duration:
        boundary = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
        words[0]["end"] = words[1]["start"] = boundary
    words[0]["start"] = max(0, words[0]["end"] - max_duration)


def _reconcile_segment_bounds(
    segment: dict, words: List[dict], median_duration: float
) -> None:
    """Make the timestamp-token segment bounds and the word timings agree:
    each bound moves to the nearer word edge unless that would cut more
    than half a second into the adjacent word, in which case the word edge
    moves instead."""
    if (
        segment["start"] < words[0]["end"]
        and segment["start"] - 0.5 > words[0]["start"]
    ):
        words[0]["start"] = max(
            0, min(words[0]["end"] - median_duration, segment["start"])
        )
    else:
        segment["start"] = words[0]["start"]

    if (
        segment["end"] > words[-1]["start"]
        and segment["end"] + 0.5 < words[-1]["end"]
    ):
        words[-1]["end"] = max(
            words[-1]["start"] + median_duration, segment["end"]
        )
    else:
        segment["end"] = words[-1]["end"]


def add_word_timestamps(
    *,
    segments: List[dict],
    model_obj,
    tokenizer: Tokenizer,
    mel,
    num_frames: int,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float,
    **kwargs,
) -> None:
    """Attach per-word dicts to each segment: DTW alignment, punctuation
    folding, then the plausible-duration reconciliation rules above
    (reference surface: timing.py:279-388)."""
    if len(segments) == 0:
        return

    text_tokens_per_segment = [
        [t for t in seg["tokens"] if t < tokenizer.eot] for seg in segments
    ]
    text_tokens = [t for seg in text_tokens_per_segment for t in seg]
    alignment = find_alignment(
        model_obj, tokenizer, text_tokens, mel, num_frames, **kwargs
    )
    median_duration, max_duration, observed = _duration_budget(alignment)
    if observed:
        _clip_sentence_boundary_outliers(alignment, max_duration)

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0

    for segment, seg_text_tokens in zip(segments, text_tokens_per_segment):
        # Walk the alignment until this segment's token budget is spent.
        # Entries emptied by merge_punctuations have tokens=[] and count 0
        # here; their tokens are charged to the ABSORBING entry when it is
        # walked (which may sit in the adjacent segment when punctuation
        # merges across a boundary).
        saved_tokens = 0
        words = []
        while word_index < len(alignment) and saved_tokens < len(seg_text_tokens):
            timing = alignment[word_index]
            if timing.word:
                words.append(
                    dict(
                        word=timing.word,
                        start=round(time_offset + timing.start, 2),
                        end=round(time_offset + timing.end, 2),
                        probability=timing.probability,
                    )
                )
            saved_tokens += len(timing.tokens)
            word_index += 1

        if len(words) > 0:
            _shorten_first_word_after_pause(
                words, last_speech_timestamp, median_duration, max_duration
            )
            _reconcile_segment_bounds(segment, words, median_duration)
            last_speech_timestamp = segment["end"]

        segment["words"] = words
