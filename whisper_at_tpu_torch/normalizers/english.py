"""English text normalization for word error rates.

Counterpart of `whisper_at_tpu/normalizers/english.py`, the same rules:
spelled-out numbers to digits (suffixes, currency, percent, "double" and
"triple", decimals), British to American spellings, contraction expansion
and symbol cleanup. The spelling table is the JAX package's
`normalizers/english.json`, read by path as the port reads its other
assets. Standard library only; used for evaluation, never in inference.
"""

import json
import os
import re
from fractions import Fraction
from typing import List, Optional, Union

from ..tokenizer import ASSETS
from .basic import remove_symbols_and_diacritics

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


def _fraction(s) -> Optional[Fraction]:
    try:
        return Fraction(s)
    except ValueError:
        return None


class EnglishNumberNormalizer:
    """Convert spelled-out numbers to arabic numerals.

    Handles suffixes (1960s, 274th, 32nd), currency words after numbers
    ($20 million -> 20000000 dollars -> $20000000), nominal digit sequences
    (one oh one -> 101), double/triple, point-decimals, percent, and keeps
    'one'/'ones' literal.
    """

    ZEROS = {"o", "oh", "zero"}
    ONES_NAMES = [
        "one", "two", "three", "four", "five", "six", "seven", "eight",
        "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
        "sixteen", "seventeen", "eighteen", "nineteen",
    ]
    TENS_NAMES = {
        "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
        "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
    }
    MULTIPLIER_NAMES = {
        "hundred": 10**2, "thousand": 10**3, "million": 10**6,
        "billion": 10**9, "trillion": 10**12, "quadrillion": 10**15,
        "quintillion": 10**18, "sextillion": 10**21, "septillion": 10**24,
        "octillion": 10**27, "nonillion": 10**30, "decillion": 10**33,
    }

    def __init__(self):
        self.ones = {name: i + 1 for i, name in enumerate(self.ONES_NAMES)}
        self.ones_suffixed = {}
        for name, value in self.ones.items():
            plural = "sixes" if name == "six" else name + "s"
            self.ones_suffixed[plural] = (value, "s")
        irregular_ordinals = {
            "zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
            "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th"),
        }
        self.ones_suffixed.update(irregular_ordinals)
        for name, value in self.ones.items():
            if value in (1, 2, 3, 5, 12):
                continue
            ordinal = name + ("h" if name.endswith("t") else "th")
            self.ones_suffixed[ordinal] = (value, "th")

        self.tens = dict(self.TENS_NAMES)
        self.tens_suffixed = {}
        for name, value in self.tens.items():
            self.tens_suffixed[name.replace("y", "ies")] = (value, "s")
            self.tens_suffixed[name.replace("y", "ieth")] = (value, "th")

        self.multipliers = dict(self.MULTIPLIER_NAMES)
        self.multipliers_suffixed = {}
        for name, value in self.multipliers.items():
            self.multipliers_suffixed[name + "s"] = (value, "s")
            self.multipliers_suffixed[name + "th"] = (value, "th")

        self.decimals = set(self.ones) | set(self.tens) | self.ZEROS

        self.preceding_prefixers = {
            "minus": "-", "negative": "-", "plus": "+", "positive": "+",
        }
        self.following_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = (
            self.ZEROS | set(self.ones) | set(self.ones_suffixed)
            | set(self.tens) | set(self.tens_suffixed)
            | set(self.multipliers) | set(self.multipliers_suffixed)
            | set(self.preceding_prefixers) | set(self.following_prefixers)
            | set(self.suffixers) | self.specials
        )

    # ------------------------------------------------------------------ #

    def _scan(self, words: List[str]) -> List[str]:
        """Token scanner with an accumulator (value, prefix)."""
        out: List[str] = []
        value: Optional[Union[str, int]] = None
        prefix: Optional[str] = None

        def flush(result=None):
            nonlocal value, prefix
            if result is None:
                result = value
            text = str(result)
            if prefix is not None:
                text = prefix + text
            out.append(text)
            value = None
            prefix = None

        i = 0
        n = len(words)
        while i < n:
            current = words[i]
            prev = words[i - 1] if i > 0 else None
            nxt = words[i + 1] if i + 1 < n else None
            next_is_numeric = nxt is not None and _NUMERIC_RE.match(nxt)

            has_prefix = current[0] in self.prefixes
            bare = current[1:] if has_prefix else current

            if _NUMERIC_RE.match(bare):
                # arabic number, possibly signed/currency-prefixed
                f = _fraction(bare)
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # decimal / ip-address continuation: "3." + "14"
                        value = str(value) + str(current)
                        i += 1
                        continue
                    flush()
                if has_prefix:
                    prefix = current[0]
                value = f.numerator if f.denominator == 1 else bare

            elif current not in self.words:
                if value is not None:
                    flush()
                flush(current)

            elif current in self.ZEROS:
                value = str(value or "") + "0"

            elif current in self.ones:
                value = self._append_ones(value, prev, self.ones[current])

            elif current in self.ones_suffixed:
                ones, suffix = self.ones_suffixed[current]
                if value is None:
                    flush(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        flush(str(value)[:-1] + str(ones) + suffix)
                    else:
                        flush(str(value) + str(ones) + suffix)
                elif ones < 10:
                    if value % 10 == 0:
                        flush(str(value + ones) + suffix)
                    else:
                        flush(str(value) + str(ones) + suffix)
                else:  # eleven..nineteen
                    if value % 100 == 0:
                        flush(str(value + ones) + suffix)
                    else:
                        flush(str(value) + str(ones) + suffix)
                value = None

            elif current in self.tens:
                tens = self.tens[current]
                if value is None:
                    value = tens
                elif isinstance(value, str):
                    value = str(value) + str(tens)
                elif value % 100 == 0:
                    value += tens
                else:
                    value = str(value) + str(tens)

            elif current in self.tens_suffixed:
                tens, suffix = self.tens_suffixed[current]
                if value is None:
                    flush(str(tens) + suffix)
                elif isinstance(value, str):
                    flush(str(value) + str(tens) + suffix)
                elif value % 100 == 0:
                    flush(str(value + tens) + suffix)
                else:
                    flush(str(value) + str(tens) + suffix)

            elif current in self.multipliers:
                multiplier = self.multipliers[current]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = _fraction(value)
                    p = f * multiplier if f is not None else None
                    if p is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        flush()
                        value = multiplier
                else:
                    before = value // 1000 * 1000
                    value = before + (value % 1000) * multiplier

            elif current in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[current]
                if value is None:
                    flush(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = _fraction(value)
                    p = f * multiplier if f is not None else None
                    if p is not None and p.denominator == 1:
                        flush(str(p.numerator) + suffix)
                    else:
                        flush()
                        flush(str(multiplier) + suffix)
                else:
                    before = value // 1000 * 1000
                    flush(str(before + (value % 1000) * multiplier) + suffix)
                value = None

            elif current in self.preceding_prefixers:
                # minus/plus become a sign prefix when a number follows
                if value is not None:
                    flush()
                if nxt in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    flush(current)

            elif current in self.following_prefixers:
                # currency words apply to a preceding number
                if value is not None:
                    prefix = self.following_prefixers[current]
                    flush()
                else:
                    flush(current)

            elif current in self.suffixers:
                if value is not None:
                    suffix = self.suffixers[current]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            flush(str(value) + suffix[nxt])
                            i += 1  # consume the suffix word
                        else:
                            flush()
                            flush(current)
                    else:
                        flush(str(value) + suffix)
                else:
                    flush(current)

            elif current in self.specials:
                if nxt not in self.words and not next_is_numeric:
                    if value is not None:
                        flush()
                    flush(current)
                elif current == "and":
                    # "and" is dropped after hundred/thousand/million/...
                    if prev not in self.multipliers:
                        if value is not None:
                            flush()
                        flush(current)
                elif current in ("double", "triple"):
                    if nxt in self.ones or nxt in self.ZEROS:
                        repeats = 2 if current == "double" else 3
                        digit = self.ones.get(nxt, 0)
                        value = str(value or "") + str(digit) * repeats
                        i += 1  # consume the digit word
                    else:
                        if value is not None:
                            flush()
                        flush(current)
                elif current == "point":
                    if nxt in self.decimals or next_is_numeric:
                        value = str(value or "") + "."

            i += 1

        if value is not None:
            flush()
        return out

    @staticmethod
    def _append_ones(value, prev, ones):
        ones_values = EnglishNumberNormalizer.ONES_NAMES
        if value is None:
            return ones
        prev_is_ones = prev in ones_values
        if isinstance(value, str) or prev_is_ones:
            tens_names = EnglishNumberNormalizer.TENS_NAMES
            if prev in tens_names and ones < 10:
                # "twenty one": replace the trailing zero with the digit
                return str(value)[:-1] + str(ones)
            return str(value) + str(ones)
        if ones < 10:
            return value + ones if value % 10 == 0 else str(value) + str(ones)
        # eleven..nineteen
        return value + ones if value % 100 == 0 else str(value) + str(ones)

    # ------------------------------------------------------------------ #

    def preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five"
        pieces = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if len(segment.strip()) == 0:
                continue
            pieces.append(segment)
            if i != len(segments) - 1:
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    pieces.append("point five")
                else:
                    pieces.append("and a half")
        s = " ".join(pieces)

        # split letter/digit boundaries, but re-join ordinal suffixes
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m):
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def extract_cents(m):
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # "$2 and ¢70" -> "$2.70"; "$0.36" -> "¢36"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)

        # keep "one(s)" literal for readability
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self._scan(s.split()) if w is not None)
        return self.postprocess(s)


class EnglishSpellingNormalizer:
    """British -> American spellings from the english.json data asset."""

    def __init__(self):
        mapping_path = os.path.join(os.path.dirname(ASSETS), "normalizers", "english.json")
        with open(mapping_path) as f:
            self.mapping = json.load(f)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


class EnglishTextNormalizer:
    """Full English normalization: fillers, contractions, numbers, spellings."""

    FILLERS = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
    CONTRACTIONS = {
        r"\bwon't\b": "will not",
        r"\bcan't\b": "can not",
        r"\blet's\b": "let us",
        r"\bain't\b": "aint",
        r"\by'all\b": "you all",
        r"\bwanna\b": "want to",
        r"\bgotta\b": "got to",
        r"\bgonna\b": "going to",
        r"\bi'ma\b": "i am going to",
        r"\bimma\b": "i am going to",
        r"\bwoulda\b": "would have",
        r"\bcoulda\b": "could have",
        r"\bshoulda\b": "should have",
        r"\bma'am\b": "madam",
        r"\bmr\b": "mister ",
        r"\bmrs\b": "missus ",
        r"\bst\b": "saint ",
        r"\bdr\b": "doctor ",
        r"\bprof\b": "professor ",
        r"\bcapt\b": "captain ",
        r"\bgov\b": "governor ",
        r"\bald\b": "alderman ",
        r"\bgen\b": "general ",
        r"\bsen\b": "senator ",
        r"\brep\b": "representative ",
        r"\bpres\b": "president ",
        r"\brev\b": "reverend ",
        r"\bhon\b": "honorable ",
        r"\basst\b": "assistant ",
        r"\bassoc\b": "associate ",
        r"\blt\b": "lieutenant ",
        r"\bcol\b": "colonel ",
        r"\bjr\b": "junior ",
        r"\bsr\b": "senior ",
        r"\besq\b": "esquire ",
        r"'d been\b": " had been",
        r"'s been\b": " has been",
        r"'d gone\b": " had gone",
        r"'s gone\b": " has gone",
        r"'d done\b": " had done",
        r"'s got\b": " has got",
        r"n't\b": " not",
        r"'re\b": " are",
        r"'s\b": " is",
        r"'d\b": " would",
        r"'ll\b": " will",
        r"'t\b": " not",
        r"'ve\b": " have",
        r"'m\b": " am",
    }

    def __init__(self):
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()

        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = re.sub(self.FILLERS, "", s)
        s = re.sub(r"\s+'", "'", s)  # drop space before apostrophes

        for pattern, replacement in self.CONTRACTIONS.items():
            s = re.sub(pattern, replacement, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # 1,000 -> 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # periods not in numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)

        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)
        return s
