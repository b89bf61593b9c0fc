"""Whisper tokenizer: BPE encodings plus the special-token convenience layer.

Port of ``qasr_ijcnlp_tpu/tokenizer``: the reference tokenizer's surface on
a pure-Python BPE engine.  Token ids are bit-identical to the reference,
which is required for reusing official checkpoints and prompts.
"""

from __future__ import annotations

import functools
import string
from typing import Dict, List, Optional, Tuple

from .bpe import Encoding, get_encoding
from .languages import LANGUAGES, TO_LANGUAGE_CODE

__all__ = [
    "LANGUAGES",
    "TO_LANGUAGE_CODE",
    "Encoding",
    "Tokenizer",
    "get_encoding",
    "get_tokenizer",
]


class Tokenizer:
    """Wraps an :class:`Encoding` with quick access to Whisper special tokens."""

    def __init__(
        self,
        encoding: Encoding,
        num_languages: int,
        language: Optional[str] = None,
        task: Optional[str] = None,
    ):
        self.encoding = encoding
        self.num_languages = num_languages
        self.language = language
        self.task = task
        self.special_tokens: Dict[str, int] = dict(encoding.special_tokens)

        sot = self.special_tokens["<|startoftranscript|>"]
        langs = tuple(LANGUAGES)[:num_languages]
        seq = [sot]
        if language is not None:
            seq.append(sot + 1 + langs.index(language))
        if task is not None:
            seq.append(
                self.special_tokens["<|transcribe|>"]
                if task == "transcribe"
                else self.special_tokens["<|translate|>"]
            )
        self.sot_sequence: Tuple[int, ...] = tuple(seq)

    # -- encode / decode ----------------------------------------------------

    def encode(self, text: str, **kwargs) -> List[int]:
        return self.encoding.encode(text)

    def decode(self, token_ids: List[int], **kwargs) -> str:
        token_ids = [t for t in token_ids if t < self.timestamp_begin]
        return self.encoding.decode(token_ids)

    def decode_with_timestamps(self, token_ids: List[int], **kwargs) -> str:
        """Like decode() but renders timestamp tokens as e.g. "<|1.08|>"."""
        return self.encoding.decode(token_ids)

    # -- special tokens -----------------------------------------------------

    @functools.cached_property
    def eot(self) -> int:
        return self.special_tokens["<|endoftext|>"]

    @functools.cached_property
    def transcribe(self) -> int:
        return self.special_tokens["<|transcribe|>"]

    @functools.cached_property
    def translate(self) -> int:
        return self.special_tokens["<|translate|>"]

    @functools.cached_property
    def sot(self) -> int:
        return self.special_tokens["<|startoftranscript|>"]

    @functools.cached_property
    def sot_lm(self) -> int:
        return self.special_tokens["<|startoflm|>"]

    @functools.cached_property
    def sot_prev(self) -> int:
        return self.special_tokens["<|startofprev|>"]

    @functools.cached_property
    def no_speech(self) -> int:
        return self.special_tokens["<|nospeech|>"]

    @functools.cached_property
    def no_timestamps(self) -> int:
        return self.special_tokens["<|notimestamps|>"]

    @functools.cached_property
    def timestamp_begin(self) -> int:
        return self.special_tokens["<|0.00|>"]

    @functools.cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("This tokenizer does not have language token configured")
        return self.to_language_token(self.language)

    def to_language_token(self, language: str) -> int:
        token = self.special_tokens.get(f"<|{language}|>")
        if token:
            return token
        raise KeyError(f"Language {language} not found in tokenizer.")

    @functools.cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(
            token_id
            for token, token_id in self.special_tokens.items()
            if token.strip("<|>") in LANGUAGES
        )[: self.num_languages]

    @functools.cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(
            self.decode_with_timestamps([t]).strip("<|>")
            for t in self.all_language_tokens
        )

    @functools.cached_property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    @functools.cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids of speaker-tag / annotation symbols to suppress.

        Same curated symbol set as the reference (whisper/tokenizer.py:242-275
        — the set is a behavioral parity target): bracket/annotation tokens
        and musical-note glyphs, keeping ordinary punctuation; " -" and " '"
        are suppressed only word-initially.
        """
        encode = self.encoding.encode

        def leading_ids(symbol: str, keep_multi_token: bool):
            # the id a transcript would start this symbol with, bare and
            # space-prefixed; multi-token renderings only count for glyphs
            # whose first piece is already the symbol (the note marks)
            for variant in (symbol, " " + symbol):
                ids = encode(variant)
                if len(ids) == 1 or keep_multi_token:
                    yield ids[0]

        annotations = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪"
        ).split()
        note_glyphs = "♩♪♫♬♭♮♯"

        ids = {encode(" -")[0], encode(" '")[0]}
        for sym in annotations:
            ids.update(leading_ids(sym, keep_multi_token=False))
        for sym in note_glyphs:
            ids.update(leading_ids(sym, keep_multi_token=True))
        return tuple(sorted(ids))

    # -- word splitting (for word-level timestamps) -------------------------

    def split_to_word_tokens(self, tokens: List[int]):
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            # No-space scripts: split wherever the byte stream forms valid
            # unicode codepoints instead of at spaces.
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: List[int]):
        """Regroup ``tokens`` into minimal runs whose bytes decode cleanly.

        BPE tokens can split multi-byte UTF-8 codepoints; a group is complete
        once its accumulated bytes no longer end in a truncated codepoint.  A
        U+FFFD that the FULL decode also shows at the same position is real
        content (invalid bytes in the stream), not truncation, and completes
        the group as well.  Works on the byte buffer incrementally — O(bytes)
        total instead of re-decoding the growing token prefix per token.
        """
        repl = "�"
        full_text = self.decode_with_timestamps(tokens)
        to_bytes = self.encoding.decode_bytes

        words: List[str] = []
        groups: List[List[int]] = []
        pending: List[int] = []
        buf = b""
        chars_done = 0
        for token in tokens:
            pending.append(token)
            buf += to_bytes([token])
            text = buf.decode("utf-8", errors="replace")
            cut = text.find(repl)
            if cut < 0 or full_text[chars_done + cut] == repl:
                words.append(text)
                groups.append(pending)
                pending, buf = [], b""
                chars_done += len(text)
        return words, groups

    def split_tokens_on_spaces(self, tokens: List[int]):
        """Merge unicode-complete subwords into space-delimited words: a
        subword STARTS a word iff it is a special token, begins with a space,
        or is bare punctuation; anything else glues onto the previous word."""
        words: List[str] = []
        groups: List[List[int]] = []
        for piece, ids in zip(*self.split_tokens_on_unicode(tokens)):
            starts_word = (
                not words
                or ids[0] >= self.eot
                or piece.startswith(" ")
                or piece.strip() in string.punctuation
            )
            if starts_word:
                words.append(piece)
                groups.append(list(ids))
            else:
                words[-1] += piece
                groups[-1] += ids
        return words, groups


@functools.lru_cache(maxsize=None)
def get_tokenizer(
    multilingual: bool,
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,
) -> Tokenizer:
    """Build the GPT-2 (English-only) or multilingual Whisper tokenizer."""
    if language is not None:
        language = language.lower()
        if language not in LANGUAGES:
            if language in TO_LANGUAGE_CODE:
                language = TO_LANGUAGE_CODE[language]
            else:
                raise ValueError(f"Unsupported language: {language}")

    if multilingual:
        encoding_name = "multilingual"
        language = language or "en"
        task = task or "transcribe"
    else:
        encoding_name = "gpt2"
        language = None
        task = None

    encoding = get_encoding(name=encoding_name, num_languages=num_languages)
    return Tokenizer(
        encoding=encoding, num_languages=num_languages, language=language, task=task
    )
