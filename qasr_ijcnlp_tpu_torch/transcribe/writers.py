"""Transcript output writers: txt / vtt / srt / tsv / json.

Port of ``qasr_ijcnlp_tpu/transcribe/writers.py`` (pure host code, the same
output byte for byte; ``tests/test_torch_transcribe.py`` holds them equal).

The on-disk FORMATS are the spec — they must match the reference CLI's output
byte-for-byte (whisper/whisper/utils.py:85-318; pinned by exact-equality
tests against the reference executed in place).  The design underneath is our
own: each format is a pure ``render(result, **options) -> str`` function, and
the subtitle word flow is an explicit layout pass producing cues as *nested
lists of lines of words* (the reference threads a single word stream with
newline characters spliced into word strings through a generator).

Layout rules (shared with the reference by construction, verified by tests):
words flow left-to-right up to ``max_line_width`` columns, lines stack up to
``max_line_count`` per cue, a >3 s inter-word pause forces a cue break when
segments aren't preserved, and ``max_words_per_line`` chunks a segment's
words before layout.  When neither width nor count is given, cue boundaries
follow segment boundaries instead.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, TextIO, Tuple

from ..utils import format_timestamp, get_start

# word entry inside a line: (rendered text, start time, end time)
_Word = Tuple[str, float, float]


@dataclass
class _Cue:
    lines: List[List[_Word]] = field(default_factory=list)

    @property
    def words(self) -> Iterator[Tuple[int, _Word]]:
        flat = 0
        for li, line in enumerate(self.lines):
            for w in line:
                yield li, w
                flat += 1

    @property
    def start(self) -> float:
        return self.lines[0][0][1]

    @property
    def end(self) -> float:
        return self.lines[-1][-1][2]

    def text(self, underline: Optional[int] = None) -> str:
        """Render the cue; ``underline`` wraps the i-th word in <u> tags
        (after any leading space, which stays outside the tag)."""
        parts: List[str] = []
        i = 0
        for line in self.lines:
            if parts:
                parts.append("\n")
            for text, _, _ in line:
                if i == underline:
                    pad = len(text) - len(text.lstrip())
                    text = text[:pad] + "<u>" + text[pad:] + "</u>"
                parts.append(text)
                i += 1
        return "".join(parts)


def _layout_cues(
    segments,
    max_line_width: Optional[int],
    max_line_count: Optional[int],
    max_words_per_line: Optional[int],
) -> Iterator[_Cue]:
    """Flow word timings into subtitle cues under the layout rules above."""
    by_segment = max_line_width is None or max_line_count is None
    width = max_line_width or 1000
    per_line = max_words_per_line or 1000

    cue = _Cue()
    cols = 0  # rendered width of the current line
    prev_start = get_start(segments) or 0.0

    for segment in segments:
        words = segment["words"]
        for chunk_at in range(0, len(words), per_line):
            for i, w in enumerate(words[chunk_at : chunk_at + per_line]):
                text, start, end = w["word"], w["start"], w["end"]
                pause = not by_segment and start - prev_start > 3.0
                fresh_segment = i == 0 and cue.lines and by_segment

                if cols > 0 and cols + len(text) <= width and not pause \
                        and not fresh_segment:
                    cue.lines[-1].append((text, start, end))  # same line
                    cols += len(text)
                else:
                    text = text.strip()
                    full = (
                        cue.lines
                        and max_line_count is not None
                        and (pause or len(cue.lines) >= max_line_count)
                    )
                    if full or fresh_segment:
                        yield cue
                        cue = _Cue()
                    cue.lines.append([(text, start, end)])  # new line
                    cols = len(text)
                prev_start = start
    if cue.lines:
        yield cue


def _timed_texts(result: dict, ts: Callable[[float], str],
                 **options) -> Iterator[Tuple[str, str, str]]:
    """(start, end, text) triples for subtitle formats; per-word highlight
    cues when requested and word timings exist."""
    segments = result["segments"]
    if not (segments and "words" in segments[0]):
        for seg in segments:
            yield (ts(seg["start"]), ts(seg["end"]),
                   seg["text"].strip().replace("-->", "->"))
        return

    highlight = options.pop("highlight_words", False)
    cues = _layout_cues(
        segments,
        options.pop("max_line_width", None),
        options.pop("max_line_count", None),
        options.pop("max_words_per_line", None),
    )
    for cue in cues:
        if not highlight:
            yield ts(cue.start), ts(cue.end), cue.text()
            continue
        prev_end = ts(cue.start)
        for i, (_, (_, start, end)) in enumerate(cue.words):
            if prev_end != ts(start):  # silence inside the cue: no underline
                yield prev_end, ts(start), cue.text()
            yield ts(start), ts(end), cue.text(underline=i)
            prev_end = ts(end)


def _merge_cli_options(options: Optional[dict], kwargs: dict) -> dict:
    merged = dict(options or {})
    for k, v in kwargs.items():
        if v or k not in merged:
            merged[k] = v
    return merged


# --------------------------------------------------------------------------
# Per-format renderers: result -> file content
# --------------------------------------------------------------------------


def _render_txt(result: dict, **_) -> str:
    return "".join(seg["text"].strip() + "\n" for seg in result["segments"])


def _render_vtt(result: dict, **options) -> str:
    ts = lambda s: format_timestamp(s, always_include_hours=False,
                                    decimal_marker=".")
    out = ["WEBVTT\n\n"]
    for start, end, text in _timed_texts(result, ts, **options):
        out.append(f"{start} --> {end}\n{text}\n\n")
    return "".join(out)


def _render_srt(result: dict, **options) -> str:
    ts = lambda s: format_timestamp(s, always_include_hours=True,
                                    decimal_marker=",")
    out = []
    for n, (start, end, text) in enumerate(
        _timed_texts(result, ts, **options), start=1
    ):
        out.append(f"{n}\n{start} --> {end}\n{text}\n\n")
    return "".join(out)


def _render_tsv(result: dict, **_) -> str:
    rows = ["start\tend\ttext\n"]
    for seg in result["segments"]:
        rows.append(
            f"{round(1000 * seg['start'])}\t{round(1000 * seg['end'])}\t"
            + seg["text"].strip().replace("\t", " ") + "\n"
        )
    return "".join(rows)


def _render_json(result: dict, **_) -> str:
    return json.dumps(result)


_RENDERERS: dict = {
    "txt": _render_txt,
    "vtt": _render_vtt,
    "srt": _render_srt,
    "tsv": _render_tsv,
    "json": _render_json,
}


class TranscriptWriter:
    """Binds a render function to an output directory.

    ``writer(result, audio_path)`` writes ``<stem>.<ext>`` into the output
    dir; ``write_result(result, file=...)`` renders into an open handle.
    """

    def __init__(self, extension: str, render: Callable, output_dir: str):
        self.extension = extension
        self.render = render
        self.output_dir = output_dir

    def __call__(self, result: dict, audio_path: str,
                 options: Optional[dict] = None, **kwargs):
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        out = os.path.join(self.output_dir, f"{stem}.{self.extension}")
        with open(out, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, options=options, **kwargs)

    def write_result(self, result: dict, file: TextIO,
                     options: Optional[dict] = None, **kwargs):
        file.write(self.render(result, **_merge_cli_options(options, kwargs)))


def get_writer(output_format: str, output_dir: str) -> Callable:
    if output_format == "all":
        writers = [
            TranscriptWriter(ext, render, output_dir)
            for ext, render in _RENDERERS.items()
        ]

        def write_all(result, audio_path, options=None, **kwargs):
            for w in writers:
                w(result, audio_path, options, **kwargs)

        return write_all
    return TranscriptWriter(
        output_format, _RENDERERS[output_format], output_dir
    )
