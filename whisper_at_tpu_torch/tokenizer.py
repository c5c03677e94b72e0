"""Whisper's text tokenizer: special-token layout, start-of-transcript
sequences and the non-speech suppression set, over `bpe.Encoding`.

Token layout after the BPE ranks: <|endoftext|>, <|startoftranscript|>, one
token per language of `languages.LANGUAGES` (in table order), <|translate|>,
<|transcribe|>, <|startoflm|>, <|startofprev|>, <|nospeech|>,
<|notimestamps|>, then 1501 timestamps <|0.00|> ... <|30.00|>.

The rank files are read by path from the JAX package's `assets/` folder,
which ships beside this package.
"""

import os
import string
from functools import cached_property, lru_cache
from typing import List, Optional, Sequence, Tuple

from .bpe import Encoding, load_ranks
from .languages import LANGUAGES, TO_LANGUAGE_CODE

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "whisper_at_tpu", "assets")

_TASK_TOKENS = ("<|translate|>", "<|transcribe|>", "<|startoflm|>",
                "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>")
N_TIMESTAMPS = 1501

# characters and strings a transcript should not start a word with; each
# suppresses its first token (with and without a leading space)
_NON_SPEECH_SYMBOLS = (
    list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
    + "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split())
_MUSIC_SIGNS = "♩♪♫♬♭♮♯"  # multi-token in UTF-8; their first byte token is unique


class Tokenizer:
    """Text <-> ids plus Whisper's special tokens for one language and task."""

    def __init__(self, encoding: Encoding, language: Optional[str] = None,
                 task: Optional[str] = None):
        self.encoding = encoding
        self.language = language
        self.task = task
        self.special_tokens = {s: encoding.encode_single_token(s)
                               for s in encoding.special_tokens_set}
        seq = [self.sot]
        if language is not None:
            seq.append(self.sot + 1 + tuple(LANGUAGES).index(language))
        if task is not None:
            seq.append(self.transcribe if task == "transcribe" else self.translate)
        self.sot_sequence: Tuple[int, ...] = tuple(seq)

    def _special(self, text: str) -> int:
        return self.special_tokens[text]

    # the special tokens by role
    eot = property(lambda self: self.encoding.eot_token)
    sot = property(lambda self: self._special("<|startoftranscript|>"))
    translate = property(lambda self: self._special("<|translate|>"))
    transcribe = property(lambda self: self._special("<|transcribe|>"))
    sot_lm = property(lambda self: self._special("<|startoflm|>"))
    sot_prev = property(lambda self: self._special("<|startofprev|>"))
    no_speech = property(lambda self: self._special("<|nospeech|>"))
    no_timestamps = property(lambda self: self._special("<|notimestamps|>"))
    timestamp_begin = property(lambda self: self._special("<|0.00|>"))

    def encode(self, text: str, **kwargs) -> List[int]:
        return self.encoding.encode(text, **kwargs)

    def decode(self, ids: Sequence[int]) -> str:
        """Text of the ids below the first timestamp token."""
        ts = self.timestamp_begin
        return self.encoding.decode([i for i in ids if i < ts])

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        return self.encoding.decode(ids)

    @cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("this tokenizer has no language")
        return self._special(f"<|{self.language}|>")

    @cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(LANGUAGES)

    @cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(self._special(f"<|{code}|>") for code in LANGUAGES)

    @cached_property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return self.sot_sequence + (self.no_timestamps,)

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Tokens to suppress so the decoder emits no speaker tags or
        bracketed annotations: the first token of each symbol, bare or after
        a space, where the symbol is a single token (always for the music
        signs); plus " -" and " '" so those only appear inside words."""
        enc = self.encoding.encode
        found = {enc(" -")[0], enc(" '")[0]}
        for symbol in _NON_SPEECH_SYMBOLS + list(_MUSIC_SIGNS):
            music = symbol in _MUSIC_SIGNS
            for ids in (enc(symbol), enc(" " + symbol)):
                if music or len(ids) == 1:
                    found.add(ids[0])
        return tuple(sorted(found))

    def split_to_word_tokens(self, tokens: List[int]) -> Tuple[List[str], List[List[int]]]:
        """(words, tokens of each word). Scripts written without spaces split
        at code-point boundaries, the others at spaces and punctuation."""
        if self.language in {"zh", "ja", "th", "lo", "my"}:
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: List[int]):
        """Cut after each token that completes a code point: a token whose
        decoded text ends in U+FFFD that the full text does not have there
        is the first byte of a character spread over several tokens."""
        decoded_full = self.decode_with_timestamps(tokens)
        replacement = "\ufffd"
        words, word_tokens, current = [], [], []
        offset = 0
        for token in tokens:
            current.append(token)
            decoded = self.decode_with_timestamps(current)
            if (replacement not in decoded
                    or decoded_full[offset + decoded.index(replacement)] == replacement):
                words.append(decoded)
                word_tokens.append(current)
                current = []
                offset += len(decoded)
        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: List[int]):
        """Join code-point pieces into words: a new word starts at a special
        token, a leading space or a punctuation mark."""
        words, word_tokens = [], []
        for subword, sub_tokens in zip(*self.split_tokens_on_unicode(tokens)):
            special = sub_tokens[0] >= self.eot
            with_space = subword.startswith(" ")
            punctuation = subword.strip() in string.punctuation
            if special or with_space or punctuation or not words:
                words.append(subword)
                word_tokens.append(sub_tokens)
            else:
                words[-1] += subword
                word_tokens[-1].extend(sub_tokens)
        return words, word_tokens


@lru_cache(maxsize=None)
def get_encoding(name: str = "gpt2") -> Encoding:
    ranks = load_ranks(os.path.join(ASSETS, f"{name}.tiktoken"))
    specials = (["<|endoftext|>", "<|startoftranscript|>"]
                + [f"<|{code}|>" for code in LANGUAGES]
                + list(_TASK_TOKENS)
                + [f"<|{i * 0.02:.2f}|>" for i in range(N_TIMESTAMPS)])
    first = len(ranks)
    return Encoding(f"{name}.tiktoken", ranks,
                    {s: first + k for k, s in enumerate(specials)})


@lru_cache(maxsize=None)
def get_tokenizer(multilingual: bool, *, language: Optional[str] = None,
                  task: Optional[str] = None) -> Tokenizer:
    if language is not None:
        language = language.lower()
        language = TO_LANGUAGE_CODE.get(language, language)
        if language not in LANGUAGES:
            raise ValueError(f"Unsupported language: {language}")
    if not multilingual:
        return Tokenizer(get_encoding("gpt2"))
    return Tokenizer(get_encoding("multilingual"), language=language or "en",
                     task=task or "transcribe")
