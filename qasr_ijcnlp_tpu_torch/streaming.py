"""Online transcription: audio in as it arrives, stable partial text out.

Port of ``qasr_ijcnlp_tpu/streaming.py``:

* ``StreamingTranscriber.feed(chunk)`` appends 16 kHz PCM and, once
  ``step_seconds`` of new audio arrived, decodes the current (<= 30 s)
  window again;
* LocalAgreement-2: a token is committed (emitted, never retracted) once
  two consecutive window decodes agree on it;
* near the 30-s ceiling, the text up to the last complete timestamp segment
  is committed and the audio before that boundary dropped, so memory and
  decode cost stay bounded on an endless stream;
* ``end()`` decodes the rest once more and commits everything.

Every decode is the package's temperature-0 ``decode`` (greedy, or beam
search with ``options.beam_size``) of the window padded to 30 s, on the
model's device (the log-mel is K1 there), or ``decode_fn``: serving passes
a ``DecodeEngine.submit`` so concurrent sessions share one slot pool.
"""

from __future__ import annotations

import threading
from dataclasses import replace
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from .audio import HOP_LENGTH, N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram, pad_or_trim
from .decode import DecodingOptions, decode
from .tokenizer import get_tokenizer


def _common_prefix(a: List[int], b: List[int]) -> List[int]:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return a[:n]


class StreamingTranscriber:
    """Incremental transcription of one audio stream, thread-safe per
    session.  ``options`` must decode at temperature 0 and keep timestamps
    (the slide cuts at segment boundaries); a None language is detected on
    the first window and then kept."""

    def __init__(self, model, options: Optional[DecodingOptions] = None,
                 step_seconds: float = 1.0, window_seconds: float = 29.0,
                 agreement: int = 2, decode_fn=None, vad_rms: float = 0.0,
                 word_timestamps: bool = False):
        """``decode_fn``: replaces the window decode; called with the padded
        30-s audio, returns a mapping with ``tokens`` (timestamps included)
        and ``language``.  ``vad_rms``: while the buffered window's RMS
        stays below it, ``feed`` skips the decode, and a silent window
        slides out untranscribed (0 turns the gate off).
        ``word_timestamps``: word timings (cross-attention DTW, ``align``)
        of the committed text whenever a window is final, in stream time."""
        options = options or DecodingOptions()
        if options.temperature != 0 or options.best_of:
            raise ValueError("streaming decodes at temperature 0 (greedy or beam); "
                             "best_of requires sampling")
        if options.without_timestamps:
            raise ValueError("streaming needs timestamp tokens (the window-slide policy "
                             "cuts at segment boundaries); leave without_timestamps False")
        self.model = model
        self.options = options
        self.decode_fn = decode_fn
        self.vad_rms = float(vad_rms)
        self.word_timestamps = bool(word_timestamps)
        self._words: List[dict] = []
        self.step = int(step_seconds * SAMPLE_RATE)
        self.window = int(window_seconds * SAMPLE_RATE)
        self.agreement = max(2, agreement)
        self._ts_begin = None  # from the first result's tokenizer

        self._audio = np.zeros(0, np.float32)
        self._decoded_at = 0  # samples seen by the last decode
        self._offset = 0.0  # stream seconds dropped by slides
        self._committed_text = ""  # never retracted
        self._win_committed: List[int] = []  # committed tokens of this window
        self._prev_hyp: Optional[List[int]] = None
        self._language: Optional[str] = options.language
        self._closed = False
        self._lock = threading.Lock()

    # -- internals ------------------------------------------------------------

    def _mel(self):
        return log_mel_spectrogram(pad_or_trim(self._audio), self.model.dims.n_mels,
                                   device=self.model.device)

    def _decode_window(self):
        if self.decode_fn is not None:
            out = self.decode_fn(pad_or_trim(self._audio))
            result = SimpleNamespace(tokens=list(out["tokens"]),
                                     language=out.get("language") or self._language or "en")
        else:
            opts = self.options
            if self._language is not None and opts.language is None:
                opts = replace(opts, language=self._language)
            (result,) = decode(self.model, self._mel()[None], opts)
        self._language = result.language
        return result

    def _tokenizer(self):
        return get_tokenizer(self.model.is_multilingual,
                             num_languages=self.model.num_languages,
                             language=self._language or "en", task=self.options.task)

    def _commit(self, tokens: List[int]) -> str:
        """Emit ``tokens`` past the window's committed prefix.  Final and
        slide commits emit the suffix blind: a last decode that diverged
        inside the committed region may garble the junction (text a client
        already has is never retracted)."""
        new = tokens[len(self._win_committed):]
        if not new:
            return ""
        delta = self._tokenizer().decode(new)  # drops timestamp tokens
        self._win_committed = list(tokens)
        self._committed_text += delta
        return delta

    def _maybe_slide(self, hyp: List[int]) -> None:
        """Near the 30-s ceiling: commit up to the last timestamp token at or
        after the committed point and drop the audio before it."""
        if len(self._audio) < self.window:
            return
        ts_begin = self._ts_begin
        k = len(self._win_committed)
        pos, ts = -1, None
        for i, t in enumerate(hyp):
            if t >= ts_begin and i >= max(k, 1):
                pos, ts = i, t
        if pos > 0:
            # the decoder may place timestamps past the real audio (the
            # window is padded with silence to 30 s)
            cut = min(int((ts - ts_begin) * 0.02 * SAMPLE_RATE), len(self._audio))
            if cut > 0:
                self._commit(hyp[:pos])
                self._drop(cut)
                return
        # no usable boundary: commit the whole hypothesis and drop exactly
        # what was decoded (30 s), never audio the decoder has not seen
        self._commit(hyp)
        self._drop(min(len(self._audio), N_SAMPLES))

    def _drop(self, cut_samples: int) -> None:
        self._align_committed()  # this window's committed text is final
        self._audio = self._audio[cut_samples:]
        self._offset += cut_samples / SAMPLE_RATE
        self._decoded_at = 0
        self._win_committed = []
        self._prev_hyp = None

    def _align_committed(self) -> None:
        """Word timings of the finalizing window's committed tokens, shifted
        to stream time."""
        if not self.word_timestamps or not self._win_committed:
            return
        from .align import add_word_timestamps

        num_frames = min(len(self._audio), N_SAMPLES) // HOP_LENGTH
        if num_frames < 2:
            return
        seg = {"tokens": list(self._win_committed), "start": 0.0, "end": num_frames / 100.0,
               "seek": 0}
        add_word_timestamps(segments=[seg], model_obj=self.model, tokenizer=self._tokenizer(),
                            mel=self._mel(), num_frames=num_frames, last_speech_timestamp=0.0)
        for w in seg.get("words", []):
            self._words.append({**w, "start": round(w["start"] + self._offset, 3),
                                "end": round(w["end"] + self._offset, 3)})

    def _partial_text(self) -> str:
        """The newest hypothesis's uncommitted tail (may still change)."""
        if self._prev_hyp is None:
            return ""
        return self._tokenizer().decode(self._prev_hyp[len(self._win_committed):])

    def _state(self, delta: str = "") -> dict:
        out = {"committed_delta": delta, "text": self._committed_text,
               "partial": self._partial_text(), "language": self._language,
               "stream_seconds": self._offset + len(self._audio) / SAMPLE_RATE}
        if self.word_timestamps:
            out["words"] = list(self._words)
        return out

    def _step(self, final: bool) -> dict:
        result = self._decode_window()
        if self._ts_begin is None:
            self._ts_begin = self._tokenizer().timestamp_begin
        hyp = list(result.tokens)
        delta = ""
        if final:
            delta = self._commit(hyp)
            self._prev_hyp = hyp
        else:
            if self._prev_hyp is not None:
                agree = _common_prefix(hyp, self._prev_hyp)
                # never retract: only extend an intact committed prefix
                if len(agree) > len(self._win_committed) and \
                        agree[: len(self._win_committed)] == self._win_committed:
                    delta = self._commit(agree)
            self._prev_hyp = hyp
            self._maybe_slide(hyp)
        return self._state(delta)

    def _silent(self) -> bool:
        return float(np.sqrt(np.mean(np.square(self._audio)))) < self.vad_rms

    # -- public API -----------------------------------------------------------

    def feed(self, chunk) -> dict:
        """Append PCM (float32 in [-1, 1], or int16) and, once
        ``step_seconds`` of new audio arrived, decode again.  Returns the
        committed and partial state either way."""
        with self._lock:
            if self._closed:
                raise RuntimeError("stream ended")
            chunk = np.asarray(chunk)
            if chunk.dtype == np.int16:
                chunk = chunk.astype(np.float32) / 32768.0
            self._audio = np.concatenate([self._audio, chunk.astype(np.float32)])
            if len(self._audio) - self._decoded_at < self.step:
                return self._state()
            if self.vad_rms and self._silent():
                # the energy gate: no decode of silence; slide it out unseen
                self._decoded_at = len(self._audio)
                if len(self._audio) >= self.window:
                    self._drop(min(len(self._audio), N_SAMPLES))
                return self._state()
            self._decoded_at = len(self._audio)
            return self._step(final=False)

    def end(self) -> dict:
        """Decode the remaining audio and commit everything."""
        with self._lock:
            if self._closed:
                raise RuntimeError("stream ended")
            self._closed = True
            if len(self._audio) == 0 or (self.vad_rms and self._silent()):
                out = self._state()
                out["partial"] = ""
                return out
            # more than a window buffered (a big last chunk): drain 30-s
            # blocks, each decode covering exactly the audio it drops
            deltas = []
            while len(self._audio) > N_SAMPLES:
                result = self._decode_window()
                if self._ts_begin is None:
                    self._ts_begin = self._tokenizer().timestamp_begin
                deltas.append(self._commit(list(result.tokens)))
                self._drop(N_SAMPLES)
            out = self._step(final=True)
            self._align_committed()  # the last window's text is final
            out["committed_delta"] = "".join(deltas) + out["committed_delta"]
            out["partial"] = ""
            if self.word_timestamps:
                out["words"] = list(self._words)
            return out
