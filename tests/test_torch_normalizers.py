"""The port's text normalizers against the JAX package's, and its
standard-library grapheme splitter against `regex`'s `\\X`."""

import inspect
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

import test_normalizers as jax_cases
from whisper_at_tpu import normalizers as jax_norm
from whisper_at_tpu_torch import normalizers as port_norm
from whisper_at_tpu_torch.normalizers import graphemes

pytestmark = pytest.mark.quick

# pieces that exercise every rule of the splitter: combining marks, ZWJ
# emoji sequences with skin tones and variation selectors, flags (regional
# indicator pairs, odd runs), Hangul jamo and syllables, Indic conjuncts and
# spacing marks, Thai SARA AM, prepended marks, CR LF and other controls
PIECES = ["a", "Z", "9", " ", "é", "ṇ̃", "́", "é", "ß", "Ł",
          "\U0001F469‍\U0001F4BB", "\U0001F468\U0001F3FD‍\U0001F9B0", "‍",
          "❤️", "\U0001F44D\U0001F3FF", "\U0001F1FA\U0001F1F8", "\U0001F1EB",
          "\U0001F3F4\U000E0067\U000E0062\U000E0073\U000E0063\U000E0074\U000E007F",
          "각", "ᄀ", "ᅡ", "ᆨ", "각", "가", "한국어",
          "क्ष", "क", "्", "ि", "नमस्ते", "ক্ত", "ந்த", "ภาษาไทย", "ำ", "؀", "٣",
          "\r\n", "\r", "\n", "\t", "\x00", "‌", "­", "中文", "ｶﾞ", "️"]
STRINGS = [
    "Hello, World!", "[music] Hello (aside) there", "Café", "Łukasz", "abc",
    "Ça va? Très bien — merci!", "naïve façade Ærø", "São Paulo, 1999",
    "I ❤️ NY 👩‍💻 and 🇺🇸🇫🇷", "한국어 텍스트 처리", "नमस्ते दुनिया", "ภาษาไทย",
    "Mr. Park paid two dollars and seventy cents", "it's 10km, about 6 miles",
    "the colour of the centre", "line one\r\nline two\ttab", "",
]


def _number_inputs():
    """The inputs the JAX package's number normalizer test feeds it."""
    return re.findall(r'std\("([^"]*)"\)', inspect.getsource(jax_cases.test_number_normalizer))


@pytest.mark.parametrize("cls", ["EnglishNumberNormalizer", "EnglishTextNormalizer"])
def test_number_normalizer_matches_jax_on_the_jax_test_vectors(cls):
    ref, ours = getattr(jax_norm, cls)(), getattr(port_norm, cls)()
    jax_cases.test_number_normalizer(ours)
    assert len(_number_inputs()) > 40
    for s in _number_inputs():
        assert ours(s) == ref(s), s


@pytest.mark.parametrize("test", ["test_spelling_normalizer", "test_text_normalizer",
                                  "test_basic_normalizer", "test_basic_normalizer_split_letters"])
def test_jax_normalizer_tests_pass_on_the_port(monkeypatch, test):
    for name in ("BasicTextNormalizer", "EnglishNumberNormalizer",
                 "EnglishSpellingNormalizer", "EnglishTextNormalizer"):
        monkeypatch.setattr(jax_cases, name, getattr(port_norm, name))
    getattr(jax_cases, test)()


@pytest.mark.parametrize("options", [
    dict(), dict(remove_diacritics=True), dict(split_letters=True),
    dict(remove_diacritics=True, split_letters=True),
])
def test_basic_normalizer_matches_jax(options):
    ref, ours = jax_norm.BasicTextNormalizer(**options), port_norm.BasicTextNormalizer(**options)
    rng = np.random.default_rng(0)
    corpus = STRINGS + ["".join(rng.choice(PIECES, rng.integers(1, 12))) for _ in range(400)]
    for s in corpus:
        assert ours(s) == ref(s), repr(s)


@pytest.mark.parametrize("cls", ["EnglishTextNormalizer", "EnglishSpellingNormalizer",
                                 "EnglishNumberNormalizer"])
def test_english_normalizers_match_jax(cls):
    ref, ours = getattr(jax_norm, cls)(), getattr(port_norm, cls)()
    rng = np.random.default_rng(1)
    words = _number_inputs() + ["colour", "organise", "won't", "Mr.", "Dr", "hmm", "uh",
                                "$5", "5%", "point", "and", "a", "half", "double",
                                "1,000", "3.5", "ⅷ", "café", "[noise]", "(laughs)"]
    corpus = STRINGS + _number_inputs() + [
        " ".join(rng.choice(words, rng.integers(1, 8))) for _ in range(300)]
    for s in corpus:
        assert ours(s) == ref(s), repr(s)


@pytest.mark.parametrize("text", STRINGS + PIECES)
def test_graphemes_match_regex(text):
    assert graphemes(text) == regex.findall(r"\X", text, regex.U)


def test_graphemes_fuzz_matches_regex():
    rng = np.random.default_rng(2)
    for _ in range(3000):
        text = "".join(rng.choice(PIECES, rng.integers(0, 10)))
        assert graphemes(text) == regex.findall(r"\X", text, regex.U), repr(text)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(PIECES), max_size=12))
def test_graphemes_hypothesis_matches_regex(pieces):
    text = "".join(pieces)
    assert graphemes(text) == regex.findall(r"\X", text, regex.U)


def test_normalizers_import_and_run_without_regex():
    """With `regex` blocked, the port's normalizers import and give the
    outputs recorded here from the JAX package (which needs `regex`)."""
    cases = {s: (jax_norm.BasicTextNormalizer(split_letters=True)(s),
                 jax_norm.EnglishTextNormalizer()(s)) for s in STRINGS}
    code = ("import sys, json; sys.modules['regex'] = None\n"
            "from whisper_at_tpu_torch.normalizers import BasicTextNormalizer, "
            "EnglishTextNormalizer\n"
            "cases = json.loads(sys.stdin.read())\n"
            "b, e = BasicTextNormalizer(split_letters=True), EnglishTextNormalizer()\n"
            "bad = [s for s, (rb, re_) in cases.items() if (b(s), e(s)) != (rb, re_)]\n"
            "jax = [m for m in sys.modules if m.split('.')[0] in ('jax', 'whisper_at_tpu')]\n"
            "print(bad, jax); sys.exit(1 if bad or jax else 0)")
    proc = subprocess.run([sys.executable, "-c", code], input=json.dumps(cases),
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
