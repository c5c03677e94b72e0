"""Language-agnostic text normalization for word error rates.

Counterpart of `whisper_at_tpu/normalizers/basic.py`: lowercase, drop
bracketed and parenthesized words, replace marks, symbols and punctuation
with spaces (and optionally strip diacritics), collapse whitespace, and
optionally split the text into its user-perceived characters.

The JAX package splits with `regex`'s `\\X`; the card's machine has no
`regex`, so `graphemes` is a standard-library segmenter of extended
grapheme clusters (Unicode Standard Annex #29, with the Indic conjunct
rule GB9c), its properties derived from `unicodedata` and the short lists
below. It is tested against `regex` on the rules' corner cases.
"""

import re
import unicodedata
from functools import lru_cache
from typing import List

# non-ASCII letters that NFKD does not decompose; mapped by hand
ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Drop nonspacing marks (diacritics after NFKD) and replace other
    marks, symbols and punctuation with spaces, except the characters of
    `keep`."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in ADDITIONAL_DIACRITICS:
            out.append(ADDITIONAL_DIACRITICS[c])
        else:
            cat = unicodedata.category(c)
            if cat != "Mn":
                out.append(" " if cat[0] in "MSP" else c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Replace marks, symbols and punctuation with spaces, keeping
    diacritics (NFKC)."""
    return "".join(" " if unicodedata.category(c)[0] in "MSP" else c
                   for c in unicodedata.normalize("NFKC", s))


# --------------------------------------------------------------------------- #
# extended grapheme clusters
# --------------------------------------------------------------------------- #

def _ranges(*spans) -> frozenset:
    out = set()
    for span in spans:
        lo, hi = span if isinstance(span, tuple) else (span, span)
        out.update(range(lo, hi + 1))
    return frozenset(out)


_PREPEND = _ranges((0x600, 0x605), 0x6DD, 0x70F, (0x890, 0x891), 0x8E2, 0xD4E, 0x110BD,
                   0x110CD, (0x111C2, 0x111C3), 0x1193F, 0x11941,
                   (0x11A84, 0x11A89), 0x11D46, 0x11F02)
# spacing marks (Mc) that extend as Grapheme_Extend, and Mc that are neither
_MC_EXTEND = _ranges(0x9BE, 0x9D7, 0xB3E, 0xB57, 0xBBE, 0xBD7, 0xCC2, (0xCD5, 0xCD6), 0xD3E,
                     0xD57, 0xDCF, 0xDDF, 0x1B35, (0x302E, 0x302F), 0x1133E, 0x11357,
                     0x114B0, 0x114BD, 0x115AF, 0x11930, 0x1D165, (0x1D16E, 0x1D172))
_MC_OTHER = _ranges((0x102B, 0x102C), 0x1038, (0x1062, 0x1064), (0x1067, 0x106D), 0x1083,
                    (0x1087, 0x108C), 0x108F, (0x109A, 0x109C), 0x1A61, (0x1A63, 0x1A64),
                    0xAA7B, 0xAA7D, (0x11720, 0x11721))
_OTHER_EXTEND = _ranges(0x200C, (0xFF9E, 0xFF9F), (0x1F3FB, 0x1F3FF), (0xE0020, 0xE007F))
_EXT_PICT = _ranges(
    0xA9, 0xAE, 0x203C, 0x2049, 0x2122, 0x2139, (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), 0x2328, 0x2388, 0x23CF, (0x23E9, 0x23F3), (0x23F8, 0x23FA), 0x24C2,
    (0x25AA, 0x25AB), 0x25B6, 0x25C0, (0x25FB, 0x25FE), (0x2600, 0x2605), (0x2607, 0x2612),
    (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712), 0x2714, 0x2716, 0x271D, 0x2721,
    0x2728, (0x2733, 0x2734), 0x2744, 0x2747, 0x274C, 0x274E, (0x2753, 0x2755), 0x2757,
    (0x2763, 0x2767), (0x2795, 0x2797), 0x27A1, 0x27B0, 0x27BF, (0x2934, 0x2935),
    (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), 0x2B50, 0x2B55, 0x3030, 0x303D, 0x3297, 0x3299,
    (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), 0x1F12F, (0x1F16C, 0x1F171), (0x1F17E, 0x1F17F),
    0x1F18E, (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), 0x1F21A, 0x1F22F,
    (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F), (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D),
    (0x1F546, 0x1F64F), (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F),
    (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF),
    (0x1FC00, 0x1FFFD))
# Indic conjuncts (GB9c): the viramas that link consonants, by script block
_LINKERS = {0x94D: 0x900, 0x9CD: 0x980, 0xACD: 0xA80, 0xB4D: 0xB00, 0xC4D: 0xC00,
            0xD4D: 0xD00}
_NOT_CONSONANT = ("LETTER A", "LETTER I", "LETTER U", "LETTER E", "LETTER O", "VOCALIC",
                  "CANDRA", "LETTER SHORT", "LETTER AI", "LETTER AU", "CHILLU", "KHANDA",
                  "VEDIC", "POLLU", "DOT REPH")


@lru_cache(maxsize=4096)
def _props(ch: str):
    """(cluster break class, extended pictographic, Indic conjunct class)."""
    cp = ord(ch)
    cat = unicodedata.category(ch)
    if cp == 0x0D:
        gcb = "CR"
    elif cp == 0x0A:
        gcb = "LF"
    elif cp == 0x200D:
        gcb = "ZWJ"
    elif 0x1F1E6 <= cp <= 0x1F1FF:
        gcb = "RI"
    elif cp in _PREPEND:
        gcb = "Prepend"
    elif cat in ("Mn", "Me") or cp in _OTHER_EXTEND or cp in _MC_EXTEND:
        gcb = "Extend"
    elif cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        gcb = "Control"
    elif (cat == "Mc" and cp not in _MC_OTHER) or cp in (0xE33, 0xEB3):
        gcb = "SpacingMark"
    elif 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        gcb = "L"
    elif 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        gcb = "V"
    elif 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        gcb = "T"
    elif 0xAC00 <= cp <= 0xD7A3:
        gcb = "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    else:
        gcb = "Other"
    if cp in _LINKERS:
        incb = "Linker"
    elif gcb in ("Extend", "ZWJ"):
        incb = "Extend"
    elif (cat == "Lo" and any(base <= cp < base + 0x80 for base in _LINKERS.values())
          and "LETTER" in unicodedata.name(ch, "")
          and not any(v in unicodedata.name(ch, "") for v in _NOT_CONSONANT)):
        incb = "Consonant"
    else:
        incb = None
    return gcb, cp in _EXT_PICT, incb


def graphemes(s: str) -> List[str]:
    """The extended grapheme clusters of s, as `regex.findall(r"\\X", s)`."""
    out: List[str] = []
    start = 0
    ri_run = 0            # regional indicators in a row before the boundary
    pict_zwj = False      # ExtPict Extend* ZWJ just before the boundary
    pict_open = False     # ExtPict Extend* just before the boundary
    conjunct = None       # GB9c: None, "consonant", "linked"
    for i, ch in enumerate(s):
        gcb, pict, incb = _props(ch)
        if i > 0:
            prev = _props(s[i - 1])[0]
            if prev == "CR" and gcb == "LF":
                join = True
            elif prev in ("Control", "CR", "LF") or gcb in ("Control", "CR", "LF"):
                join = False
            elif prev == "L" and gcb in ("L", "V", "LV", "LVT"):
                join = True
            elif prev in ("LV", "V") and gcb in ("V", "T"):
                join = True
            elif prev in ("LVT", "T") and gcb == "T":
                join = True
            elif gcb in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
                join = True
            elif conjunct == "linked" and incb == "Consonant":
                join = True
            elif pict_zwj and pict:
                join = True
            elif prev == "RI" and gcb == "RI":
                join = ri_run % 2 == 1
            else:
                join = False
            if not join:
                out.append(s[start:i])
                start = i
        # the state the next boundary reads
        ri_run = ri_run + 1 if gcb == "RI" else 0
        pict_zwj = pict_open and gcb == "ZWJ"
        pict_open = pict or (pict_open and gcb == "Extend")
        if incb == "Consonant":
            conjunct = "consonant"
        elif incb == "Linker" and conjunct is not None:
            conjunct = "linked"
        elif incb != "Extend":
            conjunct = None
    if s:
        out.append(s[start:])
    return out


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # bracketed words
        s = re.sub(r"\(([^)]+?)\)", "", s)  # parenthesized words
        s = self.clean(s).lower()
        if self.split_letters:
            s = " ".join(graphemes(s))
        s = re.sub(r"\s+", " ", s)
        return s
