"""Byte-pair encoding over tiktoken-format rank files, standard library only.

The GPT-2 pre-tokenizer is usually written as one regular expression with
Unicode classes (`\\p{L}`, `\\p{N}`) that the standard `re` module lacks.
`pretokenize` below is that expression as a hand-written scanner over
`unicodedata` categories; it tries the same alternatives in the same order:

    's 't 're 've 'm 'll 'd | ?letters | ?digits | ?others | spaces(?!non-space) | spaces

where letters are categories L*, digits N*, spaces the Unicode White_Space
set and others everything else. Each piece is then merged greedily by
lowest pair rank.
"""

import base64
import unicodedata
from typing import Dict, Iterable, Iterator, List, Optional

# the Unicode White_Space property
_SPACES = frozenset(map(chr, [
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000]))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")

_LETTER, _DIGIT, _SPACE, _OTHER = range(4)


def _kind(ch: str) -> int:
    if ch in _SPACES:
        return _SPACE
    major = unicodedata.category(ch)[0]
    if major == "L":
        return _LETTER
    if major == "N":
        return _DIGIT
    return _OTHER


def pretokenize(text: str) -> Iterator[str]:
    """Split text into GPT-2 pre-tokens (see the module docstring)."""
    kinds = [_kind(c) for c in text]
    n = len(text)
    i = 0
    while i < n:
        if text[i] == "'":
            tail = next((c for c in _CONTRACTIONS if text.startswith(c, i + 1)), None)
            if tail is not None:
                yield text[i:i + 1 + len(tail)]
                i += 1 + len(tail)
                continue
        start = i
        lead = 1 if text[i] == " " and i + 1 < n and kinds[i + 1] != _SPACE else 0
        kind = kinds[i + lead]
        if kind != _SPACE:
            # an optional space, then a run of one class
            j = i + lead
            while j < n and kinds[j] == kind:
                j += 1
            yield text[start:j]
            i = j
            continue
        j = i
        while j < n and kinds[j] == _SPACE:
            j += 1
        if j < n and j - i > 1:
            # leave the last space to lead the following piece
            j -= 1
        yield text[start:j]
        i = j


def load_ranks(path: str) -> Dict[bytes, int]:
    """Parse a tiktoken rank file: one `base64(token) rank` pair per line."""
    ranks = {}
    with open(path, "rb") as f:
        for line in f:
            fields = line.split()
            if len(fields) == 2:
                ranks[base64.b64decode(fields[0])] = int(fields[1])
    return ranks


def bpe_merge(ranks: Dict[bytes, int], piece: bytes) -> List[int]:
    """Token ids of one pre-token: repeatedly join the adjacent pair of
    lowest rank until no joined pair is in the vocabulary."""
    if piece in ranks:
        return [ranks[piece]]
    parts = [bytes([b]) for b in piece]
    while len(parts) > 1:
        pair_ranks = [ranks.get(a + b) for a, b in zip(parts, parts[1:])]
        candidates = [(r, k) for k, r in enumerate(pair_ranks) if r is not None]
        if not candidates:
            break
        _, k = min(candidates)
        parts[k:k + 2] = [parts[k] + parts[k + 1]]
    return [ranks[p] for p in parts]


class Encoding:
    """Rank table + special tokens: encode text to ids and ids back to text."""

    def __init__(self, name: str, ranks: Dict[bytes, int],
                 special_tokens: Dict[str, int],
                 explicit_n_vocab: Optional[int] = None):
        self.name = name
        self._ranks = ranks
        self._special = dict(special_tokens)
        self.n_vocab = len(ranks) + len(special_tokens)
        if explicit_n_vocab is not None and explicit_n_vocab != self.n_vocab:
            raise ValueError(f"vocabulary size {self.n_vocab} != {explicit_n_vocab}")
        self._bytes = {i: b for b, i in ranks.items()}
        self._bytes.update({i: s.encode("utf-8") for s, i in special_tokens.items()})
        self._memo: Dict[str, List[int]] = {}

    @property
    def special_tokens_set(self):
        return set(self._special)

    @property
    def eot_token(self) -> int:
        return self._special["<|endoftext|>"]

    def encode_single_token(self, text: str) -> int:
        if text in self._special:
            return self._special[text]
        return self._ranks[text.encode("utf-8")]

    def encode_ordinary(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in pretokenize(text):
            got = self._memo.get(piece)
            if got is None:
                got = self._memo[piece] = bpe_merge(self._ranks, piece.encode("utf-8"))
            ids.extend(got)
        return ids

    def encode(self, text: str, allowed_special=frozenset()) -> List[int]:
        """Ids of text; occurrences of the allowed special tokens ("all" for
        every one) map to their ids, everything else is ordinary text."""
        allowed = self.special_tokens_set if allowed_special == "all" else set(allowed_special)
        ids: List[int] = []
        pos = 0
        while allowed:
            hits = [(text.find(s, pos), -len(s), s) for s in allowed]
            hits = [h for h in hits if h[0] >= 0]
            if not hits:
                break
            at, _, special = min(hits)
            ids += self.encode_ordinary(text[pos:at])
            ids.append(self._special[special])
            pos = at + len(special)
        return ids + self.encode_ordinary(text[pos:])

    def decode_bytes(self, ids: Iterable[int]) -> bytes:
        return b"".join(self._bytes[int(i)] for i in ids)

    def decode(self, ids: Iterable[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")
