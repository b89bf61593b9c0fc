"""Small shared utilities (port of ``qasr_ijcnlp_tpu/utils.py``)."""

from __future__ import annotations

import sys
import zlib


def exact_div(x: int, y: int) -> int:
    assert x % y == 0
    return x // y


def compression_ratio(text: str) -> float:
    """zlib compression ratio; >2.4 flags degenerate/repetitive decodes."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    assert seconds >= 0, "non-negative timestamp expected"
    milliseconds = round(seconds * 1000.0)

    hours = milliseconds // 3_600_000
    milliseconds -= hours * 3_600_000
    minutes = milliseconds // 60_000
    milliseconds -= minutes * 60_000
    secs = milliseconds // 1_000
    milliseconds -= secs * 1_000

    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return (
        f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{milliseconds:03d}"
    )


def make_safe(string: str) -> str:
    """Replace characters the current stdout encoding can't represent."""
    system_encoding = sys.getdefaultencoding()
    if system_encoding != "utf-8":
        return string.encode(system_encoding, errors="replace").decode(
            system_encoding
        )
    return string


def str2bool(string: str) -> bool:
    str2val = {"True": True, "False": False}
    if string in str2val:
        return str2val[string]
    raise ValueError(f"Expected one of {set(str2val.keys())}, got {string}")


def get_device() -> str:
    """Reference-signature device helper: ``"cuda"`` when torch sees a card,
    else ``"cpu"``."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def get_start(segments):
    """Earliest word start, falling back to the first segment start."""
    return next(
        (w["start"] for s in segments for w in s.get("words", [])),
        segments[0]["start"] if segments else None,
    )


def get_end(segments):
    """Latest word end, falling back to the last segment end."""
    return next(
        (w["end"] for s in reversed(segments) for w in reversed(s.get("words", []))),
        segments[-1]["end"] if segments else None,
    )


def optional_int(string):
    return None if string == "None" else int(string)


def optional_float(string):
    return None if string == "None" else float(string)
