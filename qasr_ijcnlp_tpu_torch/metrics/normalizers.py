"""Text normalizers for WER/CER scoring.

A copy of ``qasr_ijcnlp_tpu/metrics/normalizers.py`` (pure Python; the port
keeps its own, with its own ``english_spelling.json``).  Behavioral parity
targets (verified by table-driven tests): the reference's
whisper/normalizers/basic.py:27-80 (symbol/diacritic
stripping) and english.py:12-550 (spelled-out-number standardization,
British->US spellings, contraction expansion).

The implementation is a fresh design: number words are classified once into a
token-kind table and folded left-to-right by an explicit accumulator state
machine (`_NumberFolder`) instead of a windowed-generator if/elif chain; the
basic cleaners are built on a single category-driven character translator.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from fractions import Fraction
from typing import Iterator, List, Optional, Union

# Letters whose NFKD decomposition does not reduce to ASCII.
_SPECIAL_LATIN = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def _translate_char(c: str, keep: str, drop_diacritics: bool) -> str:
    if c in keep:
        return c
    if drop_diacritics and c in _SPECIAL_LATIN:
        return _SPECIAL_LATIN[c]
    cat = unicodedata.category(c)
    if drop_diacritics and cat == "Mn":
        return ""
    if cat[0] in "MSP":
        return " "
    return c


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Markers/symbols/punctuation -> space; combining marks dropped."""
    return "".join(
        _translate_char(c, keep, True) for c in unicodedata.normalize("NFKD", s)
    )


def remove_symbols(s: str) -> str:
    """Markers/symbols/punctuation -> space; diacritics kept (NFKC)."""
    return "".join(
        _translate_char(c, "", False) for c in unicodedata.normalize("NFKC", s)
    )


_BRACKETS = re.compile(r"[<\[][^>\]]*[>\]]")
_PARENS = re.compile(r"\(([^)]+?)\)")
_WS = re.compile(r"\s+")


class BasicTextNormalizer:
    """Lowercase, strip bracketed/parenthesized spans and symbols."""

    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self._drop_diacritics = remove_diacritics
        self._split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = _PARENS.sub("", _BRACKETS.sub("", s.lower()))
        clean = (
            remove_symbols_and_diacritics if self._drop_diacritics else remove_symbols
        )
        s = clean(s).lower()
        if self._split_letters:
            try:
                import regex

                s = " ".join(regex.findall(r"\X", s, regex.U))
            except ImportError:  # grapheme split ~ char split for most text
                s = " ".join(s)
        return _WS.sub(" ", s)


# ---------------------------------------------------------------------------
# Spelled-out numbers -> arabic numerals
# ---------------------------------------------------------------------------

_ONES_WORDS = [
    "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
    "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
    "seventeen", "eighteen", "nineteen",
]
_TENS_WORDS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_SCALE_WORDS = {
    "hundred": 10**2, "thousand": 10**3, "million": 10**6, "billion": 10**9,
    "trillion": 10**12, "quadrillion": 10**15, "quintillion": 10**18,
    "sextillion": 10**21, "septillion": 10**24, "octillion": 10**27,
    "nonillion": 10**30, "decillion": 10**33,
}

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


def _ordinal_of(word: str, value: int) -> Optional[str]:
    special = {1: "first", 2: "second", 3: "third", 5: "fifth", 12: "twelfth"}
    if value in special:
        return special[value]
    return word + ("h" if word.endswith("t") else "th")


class _Vocab:
    """Classification tables for every number-ish word."""

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {w: i for i, w in enumerate(_ONES_WORDS, start=1)}
        self.tens = dict(_TENS_WORDS)
        self.scales = dict(_SCALE_WORDS)

        self.ones_sfx = {}
        self.ones_sfx["zeroth"] = (0, "th")
        for w, v in self.ones.items():
            self.ones_sfx["sixes" if w == "six" else w + "s"] = (v, "s")
            self.ones_sfx[_ordinal_of(w, v)] = (v, "th" if v not in (1, 2, 3) else
                                                {1: "st", 2: "nd", 3: "rd"}[v])
        # fifth/twelfth carry "th"
        self.ones_sfx["fifth"] = (5, "th")
        self.ones_sfx["twelfth"] = (12, "th")

        self.tens_sfx = {}
        for w, v in self.tens.items():
            self.tens_sfx[w[:-1] + "ies"] = (v, "s")
            self.tens_sfx[w[:-1] + "ieth"] = (v, "th")

        self.scales_sfx = {}
        for w, v in self.scales.items():
            self.scales_sfx[w + "s"] = (v, "s")
            self.scales_sfx[w + "th"] = (v, "th")

        self.sign_words = {"minus": "-", "negative": "-", "plus": "+", "positive": "+"}
        self.currency_words = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.symbols = set(self.sign_words.values()) | set(self.currency_words.values())
        self.unit_suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.connectors = {"and", "double", "triple", "point"}
        self.decimal_heads = self.zeros | set(self.ones) | set(self.tens)

        self.all_words = (
            self.zeros | set(self.ones) | set(self.ones_sfx) | set(self.tens)
            | set(self.tens_sfx) | set(self.scales) | set(self.scales_sfx)
            | set(self.sign_words) | set(self.currency_words)
            | set(self.unit_suffixers) | self.connectors
        )


_VOCAB = None


def _vocab() -> _Vocab:
    global _VOCAB
    if _VOCAB is None:
        _VOCAB = _Vocab()
    return _VOCAB


class _NumberFolder:
    """Left-to-right fold of a word list, accumulating number state.

    State: ``acc`` — None, an int (composable number), or a str (digit string
    being concatenated, e.g. decimals / nominal sequences); ``sign`` — pending
    prefix symbol applied to the next emission.
    """

    def __init__(self, words: List[str]):
        self.v = _vocab()
        self.words = words
        self.acc: Optional[Union[str, int]] = None
        self.sign: Optional[str] = None
        self.out: List[str] = []

    def emit(self, piece: Union[str, int]) -> None:
        piece = str(piece)
        if self.sign is not None:
            piece = self.sign + piece
            self.sign = None
        self.acc = None
        self.out.append(piece)

    def flush(self) -> None:
        if self.acc is not None:
            self.emit(self.acc)

    # -- folding rules, one method per token kind ---------------------------

    def _fold_digit_token(self, word: str, bare: str, signed: bool):
        frac = Fraction(bare)
        if self.acc is not None:
            if isinstance(self.acc, str) and self.acc.endswith("."):
                self.acc = self.acc + word  # decimal / dotted continuation
                return
            self.flush()
        if signed:
            self.sign = word[0]
        self.acc = frac.numerator if frac.denominator == 1 else bare

    def _fold_zero(self):
        self.acc = str(self.acc or "") + "0"

    def _combine_ones(self, n: int, prev: Optional[str]) -> Union[str, int]:
        v, acc = self.v, self.acc
        if acc is None:
            return n
        if isinstance(acc, str) or prev in v.ones:
            if prev in v.tens and n < 10:
                return str(acc)[:-1] + str(n)  # twenty + one -> 21
            return str(acc) + str(n)
        unit = 10 if n < 10 else 100
        if acc % unit == 0:
            return acc + n
        return str(acc) + str(n)

    def _combine_tens(self, n: int) -> Union[str, int]:
        acc = self.acc
        if acc is None:
            return n
        if isinstance(acc, str):
            return str(acc) + str(n)
        if acc % 100 == 0:
            return acc + n
        return str(acc) + str(n)

    def _apply_scale(self, mult: int):
        acc = self.acc
        if acc is None:
            return mult
        if isinstance(acc, str) or acc == 0:
            try:
                frac = Fraction(acc)
            except ValueError:
                frac = None
            if frac is not None and (frac * mult).denominator == 1:
                return (frac * mult).numerator
            self.flush()
            return mult
        return acc // 1000 * 1000 + acc % 1000 * mult

    # -- main fold ----------------------------------------------------------

    def run(self) -> Iterator[str]:
        v = self.v
        n = len(self.words)
        i = 0
        while i < n:
            word = self.words[i]
            prev = self.words[i - 1] if i > 0 else None
            nxt = self.words[i + 1] if i + 1 < n else None
            nxt_numeric = nxt is not None and _NUMERIC_RE.match(nxt)

            signed = word[:1] in v.symbols
            bare = word[1:] if signed else word

            if _NUMERIC_RE.match(bare):
                self._fold_digit_token(word, bare, signed)
            elif word not in v.all_words:
                self.flush()
                self.emit(word)
            elif word in v.zeros:
                self._fold_zero()
            elif word in v.ones:
                self.acc = self._combine_ones(v.ones[word], prev)
            elif word in v.ones_sfx:
                num, sfx = v.ones_sfx[word]
                combined = self._combine_ones(num, prev)
                self.emit(f"{combined}{sfx}")
            elif word in v.tens:
                self.acc = self._combine_tens(v.tens[word])
            elif word in v.tens_sfx:
                num, sfx = v.tens_sfx[word]
                self.emit(f"{self._combine_tens(num)}{sfx}")
            elif word in v.scales:
                self.acc = self._apply_scale(v.scales[word])
            elif word in v.scales_sfx:
                mult, sfx = v.scales_sfx[word]
                if self.acc is None:
                    self.emit(f"{mult}{sfx}")
                elif isinstance(self.acc, str):
                    try:
                        frac = Fraction(self.acc)
                    except ValueError:
                        frac = None
                    if frac is not None and (frac * mult).denominator == 1:
                        self.emit(f"{(frac * mult).numerator}{sfx}")
                    else:
                        self.flush()
                        self.emit(f"{mult}{sfx}")
                else:
                    total = self.acc // 1000 * 1000 + self.acc % 1000 * mult
                    self.emit(f"{total}{sfx}")
            elif word in v.sign_words:
                self.flush()
                if (nxt in v.all_words) or nxt_numeric:
                    self.sign = v.sign_words[word]
                else:
                    self.emit(word)
            elif word in v.currency_words:
                if self.acc is not None:
                    self.sign = v.currency_words[word]
                    self.flush()
                else:
                    self.emit(word)
            elif word in v.unit_suffixers:
                if self.acc is not None:
                    sfx = v.unit_suffixers[word]
                    if isinstance(sfx, dict):
                        if nxt in sfx:
                            self.emit(f"{self.acc}{sfx[nxt]}")
                            i += 1  # consumed the lookahead word
                        else:
                            self.flush()
                            self.emit(word)
                    else:
                        self.emit(f"{self.acc}{sfx}")
                else:
                    self.emit(word)
            elif word in v.connectors:
                i += self._fold_connector(word, prev, nxt, bool(nxt_numeric))
            i += 1

        self.flush()
        return iter(self.out)

    def _fold_connector(self, word, prev, nxt, nxt_numeric: bool) -> int:
        """Returns the number of extra (lookahead) words consumed."""
        v = self.v
        if nxt not in v.all_words and not nxt_numeric:
            self.flush()
            self.emit(word)
        elif word == "and":
            if prev not in v.scales:
                self.flush()
                self.emit(word)
        elif word in ("double", "triple"):
            if nxt in v.ones or nxt in v.zeros:
                reps = 2 if word == "double" else 3
                digit = str(v.ones.get(nxt, 0))
                self.acc = str(self.acc or "") + digit * reps
                return 1  # consumed the digit word
            self.flush()
            self.emit(word)
        elif word == "point":
            if nxt in v.decimal_heads or nxt_numeric:
                self.acc = str(self.acc or "") + "."
        return 0


class EnglishNumberNormalizer:
    """Spelled-out numbers -> digits, with suffix/currency/ordinal handling
    (reference english.py:12-447)."""

    def __init__(self):
        self.v = _vocab()

    def _pre(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five" when attachable
        chunks = re.split(r"\band\s+a\s+half\b", s)
        parts: List[str] = []
        for k, chunk in enumerate(chunks):
            if not chunk.strip():
                continue
            parts.append(chunk)
            if k != len(chunks) - 1:
                tail = chunk.rsplit(maxsplit=2)[-1]
                if tail in self.v.decimal_heads or tail in self.v.scales:
                    parts.append("point five")
                else:
                    parts.append("and a half")
        s = " ".join(parts)
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def _post(self, s: str) -> str:
        def join_cents(m):
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def cents_only(m):
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", join_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", cents_only, s)
        s = re.sub(r"\b1(s?)\b", r"one\1", s)  # keep literal "one(s)"
        return s

    def __call__(self, s: str) -> str:
        s = self._pre(s)
        folder = _NumberFolder(s.split())
        s = " ".join(w for w in folder.run() if w is not None)
        return self._post(s)


class EnglishSpellingNormalizer:
    """British -> American spellings (data table english_spelling.json)."""

    def __init__(self):
        path = os.path.join(os.path.dirname(__file__), "english_spelling.json")
        with open(path) as f:
            self.mapping = json.load(f)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(w, w) for w in s.split())


# Contraction / title expansions (reference english.py:468-522).
_REPLACERS = [
    (re.compile(p), r)
    for p, r in [
        (r"\bwon't\b", "will not"), (r"\bcan't\b", "can not"),
        (r"\blet's\b", "let us"), (r"\bain't\b", "aint"),
        (r"\by'all\b", "you all"), (r"\bwanna\b", "want to"),
        (r"\bgotta\b", "got to"), (r"\bgonna\b", "going to"),
        (r"\bi'ma\b", "i am going to"), (r"\bimma\b", "i am going to"),
        (r"\bwoulda\b", "would have"), (r"\bcoulda\b", "could have"),
        (r"\bshoulda\b", "should have"), (r"\bma'am\b", "madam"),
        (r"\bmr\b", "mister "), (r"\bmrs\b", "missus "),
        (r"\bst\b", "saint "), (r"\bdr\b", "doctor "),
        (r"\bprof\b", "professor "), (r"\bcapt\b", "captain "),
        (r"\bgov\b", "governor "), (r"\bald\b", "alderman "),
        (r"\bgen\b", "general "), (r"\bsen\b", "senator "),
        (r"\brep\b", "representative "), (r"\bpres\b", "president "),
        (r"\brev\b", "reverend "), (r"\bhon\b", "honorable "),
        (r"\basst\b", "assistant "), (r"\bassoc\b", "associate "),
        (r"\blt\b", "lieutenant "), (r"\bcol\b", "colonel "),
        (r"\bjr\b", "junior "), (r"\bsr\b", "senior "),
        (r"\besq\b", "esquire "),
        (r"'d been\b", " had been"), (r"'s been\b", " has been"),
        (r"'d gone\b", " had gone"), (r"'s gone\b", " has gone"),
        (r"'d done\b", " had done"), (r"'s got\b", " has got"),
        (r"n't\b", " not"), (r"'re\b", " are"), (r"'s\b", " is"),
        (r"'d\b", " would"), (r"'ll\b", " will"), (r"'t\b", " not"),
        (r"'ve\b", " have"), (r"'m\b", " am"),
    ]
]

_FILLERS = re.compile(r"\b(hmm|mm|mhm|mmm|uh|um)\b")


class EnglishTextNormalizer:
    """Full English scoring normalizer (reference english.py:465-550)."""

    def __init__(self):
        self.numbers = EnglishNumberNormalizer()
        self.spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = _BRACKETS.sub("", s)
        s = _PARENS.sub("", s)
        s = _FILLERS.sub("", s)
        s = re.sub(r"\s+'", "'", s)
        for pat, rep in _REPLACERS:
            s = pat.sub(rep, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.numbers(s)
        s = self.spellings(s)
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        return _WS.sub(" ", s)
