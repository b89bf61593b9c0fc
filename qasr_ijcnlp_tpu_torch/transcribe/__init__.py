"""Long-form transcription: 30 s sliding windows over the file's mel.

Port of ``qasr_ijcnlp_tpu/transcribe/__init__.py``: host-side orchestration
over the decode loop, with the reference's quality machinery
(whisper/transcribe.py:38-514):

* temperature-fallback ladder gated by compression-ratio / avg-logprob /
  no-speech thresholds, its sampling rungs drawn from the caller's
  ``torch.Generator``;
* timestamp-token segmentation and seek advance;
* prompt conditioning on previous text with reset-on-high-temperature;
* optional word timestamps + hallucination-silence skipping;
* clip_timestamps sub-ranges, and the batched fixed-stride windows of
  ``batch_windows``.

The file's log-mel is computed once on the model's device (one K1 launch
per file) with 30 s of zero PCM padding on the right.  The sequential loop
slices that device mel and pads a short last window's *mel* with 0.0; the
batched path gathers full 3000-frame windows from the padded file mel, so
its short last window's tail is the log-mel of zero PCM.  Each path keeps
the reference's own behaviour (they give different tokens there).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..align import add_word_timestamps
from ..audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
    pad_or_trim,
)
from ..decode import DecodingOptions, DecodingResult
from ..decode import decode as _decode
from ..tokenizer import LANGUAGES, get_tokenizer
from ..utils import compression_ratio, exact_div, format_timestamp, get_end, make_safe

_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"

# Word-level anomaly scoring rules: (name, condition, score contribution)
# over a word's (probability, duration): the reference's empirically tuned
# constants (whisper/transcribe.py:225-235) — the thresholds and weights ARE
# the contract; the word-timing parity tests pin them.
_WORD_ANOMALY_RULES = (
    ("improbable", lambda p, d: 1.0 if p < 0.15 else 0.0),
    ("too_short", lambda p, d: (0.133 - d) * 15 if d < 0.133 else 0.0),
    ("too_long", lambda p, d: d - 2.0 if d > 2.0 else 0.0),
)

# A segment is anomalous when its first (up to) 8 non-punctuation words
# accumulate a rule score >= this, or >= (word count - 0.01).
_SEGMENT_ANOMALY_SCORE = 3.0
_SEGMENT_ANOMALY_WORDS = 8


def _word_anomaly_score(word: dict) -> float:
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    return sum(rule(probability, duration) for _, rule in _WORD_ANOMALY_RULES)


def _is_segment_anomaly(segment: Optional[dict]) -> bool:
    if segment is None or not segment["words"]:
        return False
    scored = [
        w for w in segment["words"] if w["word"] not in _PUNCTUATION
    ][:_SEGMENT_ANOMALY_WORDS]
    total = sum(_word_anomaly_score(w) for w in scored)
    return total >= _SEGMENT_ANOMALY_SCORE or total + 0.01 >= len(scored)


def _next_words_segment(segments: List[dict]) -> Optional[dict]:
    return next((s for s in segments if s["words"]), None)


class _HallucinationSkipper:
    """Silence-gated hallucination suppression for the sequential seek loop.

    The thresholds, condition ordering and seek arithmetic are a ported
    behavior spec (reference transcribe.py:418-475, constants preserved:
    re-deriving them would drift transcript parity), organized as three
    named rules over one window's segments.  Each rule returns a new seek
    position in frames, or None to leave the seek alone.
    """

    def __init__(self, threshold: float, window_start: float,
                 window_end: float, previous_seek: int, segment_size: int,
                 segment_duration: float, content_duration: float,
                 content_frames: int):
        self.threshold = threshold
        self.window_start = window_start
        self.window_end = window_end
        self.previous_seek = previous_seek
        self.segment_size = segment_size
        self.segment_duration = segment_duration
        self.content_duration = content_duration
        self.content_frames = content_frames

    def trailing_silence_seek(self, segments: List[dict]) -> Optional[int]:
        """A silent tail longer than the threshold after the last word:
        re-seek to the word end (skip decoding the silence); a short tail
        re-seeks to the window end instead."""
        last_word_end = get_end(segments)
        if last_word_end is None or last_word_end <= self.window_start:
            return None
        if self.window_end - last_word_end > self.threshold:
            return round(last_word_end * FRAMES_PER_SECOND)
        return self.previous_seek + self.segment_size

    def leading_anomaly_seek(self, segments: List[dict]) -> Optional[int]:
        """An anomalous first voiced segment preceded by a silent gap longer
        than the threshold: drop the whole window and re-decode from the
        gap's end."""
        first = _next_words_segment(segments)
        if first is None or not _is_segment_anomaly(first):
            return None
        gap = first["start"] - self.window_start
        if gap > self.threshold:
            return self.previous_seek + round(gap * FRAMES_PER_SECOND)
        return None

    def drop_surrounded_anomaly(
        self, segments: List[dict], last_speech_timestamp: float
    ) -> Optional[Tuple[int, int]]:
        """An anomalous segment with silence on BOTH sides is a
        hallucination: returns (new_seek, index) — the caller truncates the
        window's segments from ``index`` and re-seeks into the silence
        (clamped past the window start; jumped to the stream end when the
        remaining audio is below the threshold)."""
        prev_speech_end = last_speech_timestamp
        for i, segment in enumerate(segments):
            if not segment["words"]:
                continue
            if _is_segment_anomaly(segment):
                following = _next_words_segment(segments[i + 1:])
                if following is not None:
                    next_speech_start = following["words"][0]["start"]
                else:
                    next_speech_start = self.window_start + self.segment_duration
                if self._silence_before(segment, prev_speech_end) and \
                        self._silence_after(segment, next_speech_start,
                                            following):
                    seek = round(
                        max(self.window_start + 1, segment["start"])
                        * FRAMES_PER_SECOND
                    )
                    if self.content_duration - segment["end"] < self.threshold:
                        seek = self.content_frames
                    return seek, i
            prev_speech_end = segment["end"]
        return None

    def _silence_before(self, segment: dict, prev_speech_end: float) -> bool:
        return (
            segment["start"] - prev_speech_end > self.threshold
            or segment["start"] < self.threshold
            or segment["start"] - self.window_start < 2.0
        )

    def _silence_after(self, segment: dict, next_speech_start: float,
                       following: Optional[dict]) -> bool:
        return (
            next_speech_start - segment["end"] > self.threshold
            or _is_segment_anomaly(following)
            or self.window_end - segment["end"] < 2.0
        )


class _Session:
    """State for one transcription run (prompt history, seek, segments)."""

    def __init__(self, model, tokenizer, options: dict, temperatures, thresholds,
                 device_lock=None, generator: Optional[torch.Generator] = None,
                 engine_t0=None):
        self.model = model
        self.tokenizer = tokenizer
        self.options = options
        self.temperatures = temperatures
        # The ladder's t = 0 rung through a shared decode engine (promptless
        # windows only: the engine's prompt is fixed), so concurrent
        # long-form requests share its slot pool.
        self.engine_t0 = engine_t0
        # Drives every sampling rung (t > 0) of the ladder.
        self.generator = generator
        # Serializes device work (ladder decodes, alignment) against other
        # host threads when the caller multiplexes requests (serving).
        self.device_lock = (
            device_lock if device_lock is not None else contextlib.nullcontext()
        )
        (
            self.compression_ratio_threshold,
            self.logprob_threshold,
            self.no_speech_threshold,
        ) = thresholds
        self.all_tokens: List[int] = []
        self.all_segments: List[dict] = []
        # Streaming hook: called with (newly committed segments, progress
        # seconds) after every window commit (serving's chunked endpoint).
        self.on_segments = None
        self.prompt_reset_since = 0
        self.last_speech_timestamp = 0.0
        self.seek = 0
        self.input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)  # 2
        self.time_precision = self.input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02

    # -- decode with the temperature ladder ---------------------------------

    def decode_window(self, mel_segment) -> DecodingResult:
        result = None
        for t in self.temperatures:
            kwargs = dict(self.options)
            if t > 0:
                kwargs.pop("beam_size", None)
                kwargs.pop("patience", None)
            else:
                kwargs.pop("best_of", None)
            result = None
            if t == 0 and self.engine_t0 is not None and not kwargs.get("prompt"):
                # Token-exact against model.decode at t = 0; outside the
                # device lock, since the engine serializes its own device work.
                try:
                    result = self.engine_t0(mel_segment)
                except Exception as e:
                    # A pool timeout or shutdown mid-file sends this request
                    # down the locked per-window path instead of aborting it.
                    warnings.warn(f"engine window decode failed ({type(e).__name__}: {e}); "
                                  "continuing via the locked per-window path")
                    self.engine_t0 = None
            if result is None:
                with self.device_lock:
                    result = self.model.decode(
                        mel_segment, DecodingOptions(**kwargs, temperature=t),
                        generator=self.generator,
                    )
            if self._acceptable(result):
                break
        return result

    def _acceptable(self, result: DecodingResult) -> bool:
        failed = False
        if (
            self.compression_ratio_threshold is not None
            and result.compression_ratio > self.compression_ratio_threshold
        ):
            failed = True  # degenerate repetition
        if (
            self.logprob_threshold is not None
            and result.avg_logprob < self.logprob_threshold
        ):
            failed = True  # low confidence
        if (
            self.no_speech_threshold is not None
            and result.no_speech_prob > self.no_speech_threshold
            and self.logprob_threshold is not None
            and result.avg_logprob < self.logprob_threshold
        ):
            failed = False  # silence: accept and let the caller skip
        return not failed

    # -- segmentation by timestamp tokens ------------------------------------

    def segment_window(
        self, result: DecodingResult, time_offset: float, segment_size: int
    ) -> Tuple[List[dict], int, bool]:
        """Split the decoded tokens into segments; returns (segments,
        seek_advance_frames, single_timestamp_ending)."""
        tokens = np.asarray(result.tokens, dtype=np.int64)
        ts_begin = self.tokenizer.timestamp_begin
        is_ts = tokens >= ts_begin
        single_ts_ending = len(tokens) >= 2 and bool(
            not is_ts[-2] and is_ts[-1]
        )

        segments: List[dict] = []
        consecutive = np.where(is_ts[:-1] & is_ts[1:])[0] + 1
        if len(consecutive) > 0:
            slices = consecutive.tolist()
            if single_ts_ending:
                slices.append(len(tokens))
            last_slice = 0
            for current_slice in slices:
                sliced = tokens[last_slice:current_slice]
                start_pos = int(sliced[0]) - ts_begin
                end_pos = int(sliced[-1]) - ts_begin
                segments.append(
                    self._new_segment(
                        time_offset + start_pos * self.time_precision,
                        time_offset + end_pos * self.time_precision,
                        sliced,
                        result,
                    )
                )
                last_slice = current_slice
            if single_ts_ending:
                advance = segment_size
            else:
                last_ts_pos = int(tokens[last_slice - 1]) - ts_begin
                advance = last_ts_pos * self.input_stride
        else:
            duration = segment_size * HOP_LENGTH / SAMPLE_RATE
            timestamps = tokens[is_ts]
            if len(timestamps) > 0 and int(timestamps[-1]) != ts_begin:
                duration = (int(timestamps[-1]) - ts_begin) * self.time_precision
            segments.append(
                self._new_segment(
                    time_offset, time_offset + duration, tokens, result
                )
            )
            advance = segment_size
        return segments, advance, single_ts_ending

    def _new_segment(self, start, end, tokens, result: DecodingResult) -> dict:
        tokens = [int(t) for t in tokens]
        text_tokens = [t for t in tokens if t < self.tokenizer.eot]
        return {
            "seek": self.seek,
            "start": start,
            "end": end,
            "text": self.tokenizer.decode(text_tokens),
            "tokens": tokens,
            "temperature": result.temperature,
            "avg_logprob": result.avg_logprob,
            "compression_ratio": result.compression_ratio,
            "no_speech_prob": result.no_speech_prob,
        }

    # -- bookkeeping ----------------------------------------------------------

    def commit(self, segments: List[dict], condition_on_previous_text: bool,
               temperature: float):
        for i, segment in enumerate(segments):
            if segment["start"] == segment["end"] or segment["text"].strip() == "":
                segment["text"] = ""
                segment["tokens"] = []
                segment["words"] = []
        n0 = len(self.all_segments)
        self.all_segments.extend(
            {"id": i, **seg}
            for i, seg in enumerate(segments, start=len(self.all_segments))
        )
        self.all_tokens.extend(t for seg in segments for t in seg["tokens"])
        if not condition_on_previous_text or temperature > 0.5:
            self.prompt_reset_since = len(self.all_tokens)
        if self.on_segments is not None and len(self.all_segments) > n0:
            self.on_segments(
                self.all_segments[n0:], self.seek * HOP_LENGTH / SAMPLE_RATE
            )


def _gather_windows(mel_dev: torch.Tensor, starts: List[int]) -> torch.Tensor:
    """(n_mels, L) device mel + B frame starts -> (B, n_mels, N_FRAMES), in
    one index op on the device.  In range by construction: the mel carries
    N_SAMPLES of right padding, so every start < content_frames leaves a
    full window."""
    idx = torch.tensor(starts, device=mel_dev.device)[:, None] + torch.arange(
        N_FRAMES, device=mel_dev.device)
    return mel_dev[:, idx].transpose(0, 1).contiguous()


def _transcribe_batched(
    session: _Session,
    mel_dev: torch.Tensor,
    content_frames: int,
    max_batch: int,
    no_speech_threshold: Optional[float],
    logprob_threshold: Optional[float],
    verbose: Optional[bool],
    seek_clips: Optional[List[Tuple[int, int]]] = None,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    initial_prompt_tokens: Tuple[int, ...] = (),
) -> None:
    """Fixed-stride windows decoded as device batches.

    The sequential loop's data-dependent seek/prompt coupling is dropped -
    window w covers frames [w*N_FRAMES, (w+1)*N_FRAMES); windows failing the
    quality gates re-decode individually through the temperature ladder.
    ``initial_prompt_tokens`` condition EVERY window identically (there is
    no rolling transcript to condition on); ``seek_clips`` restricts the
    fixed-stride windows to the requested sub-ranges; ``word_timestamps``
    runs the cross-attention DTW alignment per committed window, as the
    sequential path does (the alignment never feeds back into seek here,
    because there is no seek).  Each batch's windows are gathered from the
    device mel in one index op.
    """
    if initial_prompt_tokens:
        # the temperature-ladder re-decodes go through session.options
        session.options = {
            **session.options, "prompt": list(initial_prompt_tokens)
        }
    if seek_clips:
        # The sequential semantics (transcribe.py:272-283): the position
        # only moves FORWARD across clips, so overlapping clips never
        # re-decode the overlap, and a clip lying entirely beyond the audio
        # content decodes nothing.
        starts, seg_sizes = [], {}
        pos = 0
        for clip_start, clip_end in seek_clips:
            pos = max(pos, clip_start)
            end = min(clip_end, content_frames)
            while pos < end:
                size = min(N_FRAMES, content_frames - pos, end - pos)
                starts.append(pos)
                seg_sizes[pos] = size
                pos += size
    else:
        starts = list(range(0, max(content_frames, 1), N_FRAMES))
        seg_sizes = {
            s: min(N_FRAMES, max(content_frames - s, 1)) for s in starts
        }
    segments_by_window: dict = {}

    for chunk_start in range(0, len(starts), max_batch):
        chunk = starts[chunk_start : chunk_start + max_batch]
        # A short last batch is padded to the full batch only when there
        # is more than one batch (padded rows are discarded below).
        pad_n = (
            max_batch - len(chunk)
            if len(chunk) < max_batch and len(starts) > max_batch
            else 0
        )
        mels = _gather_windows(mel_dev, chunk + [chunk[-1]] * pad_n)
        opts = dict(session.options)
        opts.pop("prompt", None)
        if initial_prompt_tokens:
            opts["prompt"] = list(initial_prompt_tokens)
        results = _decode(
            session.model, mels,
            DecodingOptions(**opts, temperature=session.temperatures[0]),
            generator=session.generator,
        )
        for s, result in zip(chunk, results):
            if len(session.temperatures) > 1 and not session._acceptable(result):
                result = session.decode_window(_gather_windows(mel_dev, [s])[0])
            segments_by_window[s] = result

    for s in starts:
        result = segments_by_window[s]
        if no_speech_threshold is not None:
            skip = result.no_speech_prob > no_speech_threshold
            if (
                logprob_threshold is not None
                and result.avg_logprob > logprob_threshold
            ):
                skip = False
            if skip:
                continue
        session.seek = s
        time_offset = float(s * HOP_LENGTH / SAMPLE_RATE)
        segment_size = seg_sizes[s]
        segments, _, _ = session.segment_window(result, time_offset, segment_size)
        if word_timestamps and segments:
            add_word_timestamps(
                segments=segments,
                model_obj=session.model,
                tokenizer=session.tokenizer,
                mel=_gather_windows(mel_dev, [s])[0],
                num_frames=segment_size,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                last_speech_timestamp=session.last_speech_timestamp,
                audio_features=result.audio_features,
            )
            last_word_end = get_end(segments)
            if last_word_end is not None:
                session.last_speech_timestamp = last_word_end
        if verbose:
            for seg in segments:
                print(make_safe(
                    f"[{format_timestamp(seg['start'])} --> "
                    f"{format_timestamp(seg['end'])}] {seg['text']}"
                ))
        session.commit(segments, False, result.temperature)


def _engine_shortcut(engine, decode_options: dict):
    """A ``mel_segment -> DecodingResult`` t = 0 decoder on a shared
    ``decode.engine.DecodeEngine``, or None (with a warning) when the pool
    decodes with other options than this call's t = 0 rung (language, task,
    sample_len, kv_int8, timestamps, ...), takes audio instead of mels (it
    would recompute the window mels with other padding), or detects each
    request's language (the reference detects once per file): those windows
    take the plain path, so the engine never changes a window's tokens.
    Engine results carry no audio features, so word timings re-encode."""
    kwargs = dict(decode_options)
    kwargs.pop("best_of", None)  # decode_window drops it at t = 0
    kwargs.pop("prompt", None)  # only promptless windows reach the engine
    try:
        t0 = DecodingOptions(**kwargs, temperature=0.0)
    except TypeError:
        return None
    if t0 != engine.task.options or t0.draft is not None or engine.audio_frontend \
            or engine._detect:
        warnings.warn(
            "transcribe(engine=...) ignored: the engine's decode options do not match "
            "this call's t=0 options (or the pool is audio-input / per-request-detect); "
            "decoding via the plain path.")
        return None
    language = engine.task.options.language or "en"

    def _decode(mel_segment) -> DecodingResult:
        r = engine.submit(np.asarray(torch.as_tensor(mel_segment).float().cpu()))
        return DecodingResult(
            audio_features=None, language=language, tokens=list(r["tokens"]),
            text=r["text"], avg_logprob=float(r["avg_logprob"]),
            no_speech_prob=float(r["no_speech_prob"]), temperature=0.0,
            compression_ratio=compression_ratio(r["text"]))

    return _decode


@torch.inference_mode()
def transcribe(
    model,
    audio: Union[str, np.ndarray, torch.Tensor],
    *,
    verbose: Optional[bool] = None,
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    carry_initial_prompt: bool = False,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    clip_timestamps: Union[str, List[float]] = "0",
    hallucination_silence_threshold: Optional[float] = None,
    batch_windows: Union[bool, int] = False,
    on_segments=None,
    engine=None,
    device_lock=None,
    generator: Optional[torch.Generator] = None,
    **decode_options,
) -> dict:
    """Transcribe audio of any length (reference transcribe.py:38-514).

    Returns {"text", "segments", "language"}.

    ``batch_windows`` decodes the fixed 30 s windows as device batches
    (``int(batch_windows)`` windows per batch, or 64 for True) instead of
    the sequential seek loop: no cross-window prompt conditioning and fixed
    window boundaries; per-window temperature fallback still applies
    (failed windows are re-decoded individually).  ``word_timestamps``,
    ``clip_timestamps`` and ``initial_prompt`` (applied identically to
    every window) are honored there; ``hallucination_silence_threshold`` is
    a seek-loop feature and warns + is ignored.

    ``on_segments(new_segments, progress_seconds)`` is called after every
    committed window (the streaming hook).  ``device_lock``: optional
    REENTRANT lock serializing the device work against other host threads.
    ``generator`` drives the sampling rungs (t > 0) of the ladder; the JAX
    package draws a numpy seed per decode instead, so those rungs are not
    token-exact against it.

    ``engine``: a ``decode.engine.DecodeEngine`` (mel input, timestamps)
    that runs the ladder's t = 0 rung of every promptless window (pass
    ``condition_on_previous_text=False`` to make every window eligible), so
    concurrent calls share its slot pool; used only where its options equal
    this call's t = 0 options (:func:`_engine_shortcut`), so the
    transcript is the same with or without it.  Not used by
    ``batch_windows``, which batches its own windows under the lock.
    """
    _lk = device_lock if device_lock is not None else contextlib.nullcontext()
    # 30 s of zero padding on the right so the last window is full-size.
    with _lk:
        mel_dev = log_mel_spectrogram(
            audio, model.dims.n_mels, padding=N_SAMPLES, device=model.device
        )

    content_frames = int(mel_dev.shape[-1]) - N_FRAMES
    content_duration = float(content_frames * HOP_LENGTH / SAMPLE_RATE)

    if decode_options.get("language") is None:
        if not model.is_multilingual:
            decode_options["language"] = "en"
        else:
            if verbose:
                print(
                    "Detecting language using up to the first 30 seconds. "
                    "Use `language` to specify the language"
                )
            segment = pad_or_trim(mel_dev, N_FRAMES)
            with _lk:
                _, probs = model.detect_language(segment)
            decode_options["language"] = max(probs, key=probs.get)
            if verbose is not None:
                print(
                    f"Detected language: "
                    f"{LANGUAGES[decode_options['language']].title()}"
                )

    language = decode_options["language"]
    task = decode_options.get("task", "transcribe")
    tokenizer = get_tokenizer(
        model.is_multilingual,
        num_languages=model.num_languages,
        language=language,
        task=task,
    )

    if word_timestamps and task == "translate":
        warnings.warn("Word-level timestamps on translations may not be reliable.")

    if isinstance(clip_timestamps, str):
        clip_timestamps = [
            float(ts) for ts in (clip_timestamps.split(",") if clip_timestamps else [])
        ]
    seek_points = [round(ts * FRAMES_PER_SECOND) for ts in clip_timestamps] or [0]
    if len(seek_points) % 2 == 1:
        seek_points.append(content_frames)
    seek_clips = list(zip(seek_points[::2], seek_points[1::2]))

    temperatures = (
        [temperature] if isinstance(temperature, (int, float)) else list(temperature)
    )
    engine_t0 = _engine_shortcut(engine, decode_options) if engine is not None else None
    session = _Session(
        model,
        tokenizer,
        decode_options,
        temperatures,
        (compression_ratio_threshold, logprob_threshold, no_speech_threshold),
        device_lock=device_lock,
        generator=generator,
        engine_t0=engine_t0,
    )
    session.on_segments = on_segments

    remaining_prompt_length = model.dims.n_text_ctx // 2 - 1
    if initial_prompt is not None:
        initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
        session.all_tokens.extend(initial_prompt_tokens)
        remaining_prompt_length -= len(initial_prompt_tokens)
    else:
        initial_prompt_tokens = []

    if batch_windows:
        if hallucination_silence_threshold is not None:
            warnings.warn(
                "hallucination_silence_threshold adjusts the seek position "
                "from word timings, which requires the sequential seek loop; "
                "it is IGNORED under batch_windows. Pass batch_windows=False "
                "to enable hallucination skipping."
            )
        max_batch = 64 if batch_windows is True else max(int(batch_windows), 2)
        # The batched path decodes its own device batches under the lock;
        # an engine rung in its ladder would block on the pool while
        # holding it.
        session.engine_t0 = None
        with _lk:
            _transcribe_batched(
                session, mel_dev, content_frames, max_batch, no_speech_threshold,
                logprob_threshold, verbose,
                seek_clips=seek_clips,
                word_timestamps=word_timestamps,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                initial_prompt_tokens=tuple(initial_prompt_tokens),
            )
        return dict(
            text=tokenizer.decode(
                session.all_tokens[len(initial_prompt_tokens):]
            ),
            segments=session.all_segments,
            language=language,
        )

    for clip_start, clip_end in seek_clips:
        session.seek = max(session.seek, clip_start)
        while session.seek < min(clip_end, content_frames):
            seek = session.seek
            time_offset = float(seek * HOP_LENGTH / SAMPLE_RATE)
            window_end_time = float((seek + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE)
            segment_size = min(N_FRAMES, content_frames - seek, clip_end - seek)
            segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE
            # the device mel sliced, a short window padded with 0.0
            mel_segment = pad_or_trim(mel_dev[:, seek : seek + segment_size], N_FRAMES)

            if carry_initial_prompt:
                nignored = max(len(initial_prompt_tokens), session.prompt_reset_since)
                remaining = session.all_tokens[nignored:][-remaining_prompt_length:]
                decode_options["prompt"] = initial_prompt_tokens + remaining
            else:
                decode_options["prompt"] = session.all_tokens[
                    session.prompt_reset_since :
                ]

            result = session.decode_window(mel_segment)

            if no_speech_threshold is not None:
                should_skip = result.no_speech_prob > no_speech_threshold
                if (
                    logprob_threshold is not None
                    and result.avg_logprob > logprob_threshold
                ):
                    should_skip = False
                if should_skip:
                    session.seek += segment_size
                    continue

            previous_seek = seek
            current_segments, advance, single_ts_ending = session.segment_window(
                result, time_offset, segment_size
            )
            session.seek += advance

            if word_timestamps:
                with _lk:
                    add_word_timestamps(
                        segments=current_segments,
                        model_obj=model,
                        tokenizer=tokenizer,
                        mel=mel_segment,
                        num_frames=segment_size,
                        prepend_punctuations=prepend_punctuations,
                        append_punctuations=append_punctuations,
                        last_speech_timestamp=session.last_speech_timestamp,
                        # reuse the features this window was just decoded from
                        # (find_alignment re-encodes only if they aren't f32)
                        audio_features=result.audio_features,
                    )
                if not single_ts_ending:
                    last_word_end = get_end(current_segments)
                    if last_word_end is not None and last_word_end > time_offset:
                        session.seek = round(last_word_end * FRAMES_PER_SECOND)

                if hallucination_silence_threshold is not None:
                    skipper = _HallucinationSkipper(
                        threshold=hallucination_silence_threshold,
                        window_start=time_offset,
                        window_end=window_end_time,
                        previous_seek=previous_seek,
                        segment_size=segment_size,
                        segment_duration=segment_duration,
                        content_duration=content_duration,
                        content_frames=content_frames,
                    )
                    if not single_ts_ending:
                        seek = skipper.trailing_silence_seek(current_segments)
                        if seek is not None:
                            session.seek = seek

                    seek = skipper.leading_anomaly_seek(current_segments)
                    if seek is not None:
                        session.seek = seek
                        continue  # nothing in this window is trustworthy

                    dropped = skipper.drop_surrounded_anomaly(
                        current_segments, session.last_speech_timestamp
                    )
                    if dropped is not None:
                        session.seek, keep_until = dropped
                        current_segments[keep_until:] = []

                last_word_end = get_end(current_segments)
                if last_word_end is not None:
                    session.last_speech_timestamp = last_word_end

            if verbose:
                for segment in current_segments:
                    line = (
                        f"[{format_timestamp(segment['start'])} --> "
                        f"{format_timestamp(segment['end'])}] {segment['text']}"
                    )
                    print(make_safe(line))

            session.commit(
                current_segments, condition_on_previous_text, result.temperature
            )

    return dict(
        text=tokenizer.decode(session.all_tokens[len(initial_prompt_tokens) :]),
        segments=session.all_segments,
        language=language,
    )
