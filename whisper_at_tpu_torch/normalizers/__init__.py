"""Text normalizers for word error rates: `BasicTextNormalizer` (any
language) and `EnglishTextNormalizer` (numbers, spellings, contractions).
Counterpart of `whisper_at_tpu/normalizers`, without `regex`."""

from .basic import BasicTextNormalizer, graphemes
from .english import EnglishNumberNormalizer, EnglishSpellingNormalizer, EnglishTextNormalizer

__all__ = ["BasicTextNormalizer", "EnglishNumberNormalizer", "EnglishSpellingNormalizer",
           "EnglishTextNormalizer", "graphemes"]
