"""Small shared utilities (port of ``qasr_ijcnlp_tpu/utils.py``)."""

from __future__ import annotations

import zlib


def compression_ratio(text: str) -> float:
    """zlib compression ratio; >2.4 flags degenerate/repetitive decodes."""
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))
