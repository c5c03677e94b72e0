"""The port's byte-pair merge (`whisper_at_tpu_torch.bpe.bpe_merge`, its only
merge) against the JAX package's C++ engine and its `regex` tokenizer: the
same ids on the tokenizer corpus of `test_torch_rules.py` and on the fuzz
texts of its pre-tokenizer test, the same merge of every pre-token, and no
compiler needed to encode."""

import numpy as np
import pytest

import whisper_at_tpu.bpe as jax_bpe
from test_torch_rules import SAMPLES
from whisper_at_tpu.native import native_bpe as jax_native_bpe
from whisper_at_tpu.tokenizer import get_encoding as jax_get_encoding
from whisper_at_tpu_torch import bpe
from whisper_at_tpu_torch.bpe import pretokenize
from whisper_at_tpu_torch.tokenizer import ASSETS, Tokenizer, get_encoding, get_tokenizer

pytestmark = pytest.mark.quick

# the alphabet of test_torch_rules.test_pretokenizer_fuzz_matches_regex
FUZZ_ALPHABET = list("ab Z9 '\n\t.,!?-") + ["'s", "'ll", "é", "中文", "٣", "½", "　", "\xa0",
                                            "  ", "'S", "€", "🙂", "x́"]
VOCABS = ["gpt2", "multilingual"]


def fuzz_texts(n: int = 2000):
    rng = np.random.default_rng(0)
    return ["".join(rng.choice(FUZZ_ALPHABET) for _ in range(rng.integers(0, 14)))
            for _ in range(n)]


def jax_engine(vocab: str):
    engine = jax_native_bpe(f"{ASSETS}/{vocab}.tiktoken")
    if engine is None:
        pytest.skip("the JAX package's C++ engine does not build here")
    return engine


@pytest.fixture(scope="module", params=VOCABS)
def encoders(request):
    """{tokenizer: encode(text) -> ids} over one vocabulary: the port's, the
    JAX package's on its C++ engine, and the JAX package's regex path."""
    vocab = request.param
    jax_native = jax_get_encoding(vocab)
    jax_regex = jax_bpe.Encoding(jax_native.name, jax_native._ranks, jax_native._special_tokens)
    return {"port": get_encoding(vocab).encode, "jax-native": jax_native.encode,
            "jax-regex": jax_regex.encode}


@pytest.mark.parametrize("corpus", ["samples", "fuzz"])
def test_tokenizers_give_the_same_ids(encoders, corpus):
    texts = SAMPLES if corpus == "samples" else fuzz_texts()
    for text in texts:
        ids = {name: encode(text) for name, encode in encoders.items()}
        assert len(set(map(tuple, ids.values()))) == 1, (text, ids)


@pytest.mark.parametrize("vocab", VOCABS)
def test_piece_merges_agree(vocab):
    """Every pre-token of the corpus, merged whole by the port's merge and by
    the JAX package's engine."""
    ranks = get_encoding(vocab)._ranks
    theirs = jax_engine(vocab)
    pieces = {p.encode("utf-8") for text in SAMPLES + fuzz_texts(300) for p in pretokenize(text)}
    for piece in sorted(pieces):
        assert bpe.bpe_merge(ranks, piece) == theirs.encode_piece(piece), piece


def test_empty_piece_merges_to_nothing():
    assert bpe.bpe_merge(get_encoding("gpt2")._ranks, b"") == []
    assert jax_engine("gpt2").encode_piece(b"") == []


def test_tokenizer_encodes_without_a_compiler(monkeypatch):
    """The port builds nothing to tokenize: with no compiler on PATH a new
    encoding gives the cached tokenizer's ids."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CXX", "no-such-compiler")
    tok = Tokenizer(get_encoding.__wrapped__("gpt2"))
    text = " ".join(SAMPLES)
    assert tok.encode(text) == get_tokenizer(False).encode(text)
