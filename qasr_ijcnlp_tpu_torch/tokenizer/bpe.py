"""Byte-pair encoding engine over tiktoken-format rank files.

Port of ``qasr_ijcnlp_tpu/tokenizer/bpe.py`` (pure-Python merges; the C++
merge core of the JAX package is not carried over).  The rank tables are the
port's own copies in ``tokenizer/assets``, byte-identical to the JAX
package's (a test holds them so).

``regex`` (for the GPT-2 split pattern) is imported inside
:meth:`Encoding.encode`: decoding token ids to text needs no split pattern,
so the decode path runs where ``regex`` is not installed.
"""

from __future__ import annotations

import base64
import functools
import os
from typing import Dict, List, Optional

ASSETS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# The GPT-2 split pattern used by both Whisper encodings.
PAT_STR = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


def load_ranks(path: str) -> Dict[bytes, int]:
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            if not line.strip():
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def _bpe_merge(piece: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """Greedy lowest-rank pair merging; returns the token ids for one piece."""
    if piece in ranks:
        return [ranks[piece]]
    parts = [piece[i : i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_rank: Optional[int] = None
        best_i = -1
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_i = r, i
        if best_rank is None:
            break
        parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
    return [ranks[p] for p in parts]


class Encoding:
    """tiktoken-compatible encoding: regex split + rank-table BPE + specials."""

    def __init__(
        self,
        name: str,
        pat_str: str,
        mergeable_ranks: Dict[bytes, int],
        special_tokens: Dict[str, int],
    ):
        self.name = name
        self.pat_str = pat_str or PAT_STR
        self._pat = None
        self.ranks = mergeable_ranks
        self.special_tokens = dict(special_tokens)
        self.special_tokens_set = set(special_tokens)
        self._decoder: Dict[int, bytes] = {
            rank: token for token, rank in mergeable_ranks.items()
        }
        for text, rank in special_tokens.items():
            self._decoder[rank] = text.encode("utf-8")
        self.n_vocab = len(mergeable_ranks) + len(special_tokens)
        self.eot_token = special_tokens.get("<|endoftext|>")
        # Per-encoding memo for word pieces; Whisper text is highly repetitive.
        self._cache: Dict[bytes, List[int]] = {}

    def encode(self, text: str) -> List[int]:
        if self._pat is None:
            import regex

            self._pat = regex.compile(self.pat_str)
        ids: List[int] = []
        cache = self._cache
        for match in self._pat.finditer(text):
            piece = match.group().encode("utf-8")
            out = cache.get(piece)
            if out is None:
                out = _bpe_merge(piece, self.ranks)
                if len(cache) < 1 << 16:
                    cache[piece] = out
            ids.extend(out)
        return ids

    def encode_single_token(self, text: str) -> int:
        if text in self.special_tokens:
            return self.special_tokens[text]
        b = text.encode("utf-8")
        if b in self.ranks:
            return self.ranks[b]
        raise KeyError(text)

    def decode_bytes(self, ids) -> bytes:
        return b"".join(self._decoder[int(t)] for t in ids)

    def decode(self, ids) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")


@functools.lru_cache(maxsize=None)
def get_encoding(name: str = "gpt2", num_languages: int = 99) -> Encoding:
    """Build a Whisper encoding with its full special-token layout:
    endoftext, startoftranscript, one token per language, translate,
    transcribe, startoflm, startofprev, nospeech, notimestamps, then 1501
    timestamp tokens <|0.00|> .. <|30.00|> in 0.02 s steps."""
    from .languages import LANGUAGES

    ranks = load_ranks(os.path.join(ASSETS_DIR, f"{name}.tiktoken"))
    n_vocab = len(ranks)
    specials = [
        "<|endoftext|>",
        "<|startoftranscript|>",
        *[f"<|{lang}|>" for lang in list(LANGUAGES)[:num_languages]],
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
    ]
    special_tokens = {tok: n_vocab + i for i, tok in enumerate(specials)}
    return Encoding(
        name=f"{name}.tiktoken",
        pat_str=PAT_STR,
        mergeable_ranks=ranks,
        special_tokens=special_tokens,
    )
