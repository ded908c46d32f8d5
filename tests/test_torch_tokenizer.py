"""The port's tokenizers (``nezha_tpu_torch/data/tokenizer.py``) against
the JAX package's: ids equal bitwise on a seeded corpus of ASCII,
accents, CJK, punctuation, whitespace runs and ``<|endoftext|>``, for a
BPE and a WordPiece vocab both learned by JAX's ``bpe_train``; decode,
pairs and segments, the loader's ``do_lower_case``, and the hand-written
GPT-2 pre-tokenizer against ``regex`` over every assigned code point."""

import json
import random
import unicodedata

import numpy as np
import pytest

from nezha_tpu.data import bpe_train as jax_bpe
from nezha_tpu.data import tokenizer as jax_tok
from nezha_tpu_torch.data import tokenizer as tok

regex = pytest.importorskip("regex")

PIECES = ["the", "quick", "brown", "fox", "jumps", "Über", "café", "naïve",
          "résumé", "中文", "字符", "日本語", "!", "?", "...", "--", "(x)",
          "'s", "'ll", "don't", "I'm", "42", "3.14", "٣", "Ⅻ", "  ", "\t",
          "\n\n", "   ", "<|endoftext|>", "def", "main(", "x_1", "$100",
          "a+b", "~", " ", "　", "\x1c", "emoji😀", "ß", "İ"]


def _corpus(seed: int, n_docs: int = 12, words: int = 60):
    r = random.Random(seed)
    docs = []
    for _ in range(n_docs):
        parts = []
        for _ in range(words):
            parts.append(r.choice(PIECES))
            parts.append(r.choice([" ", " ", "", "\n", "  "]))
        docs.append("".join(parts))
    return docs


@pytest.fixture(scope="module")
def vocabs(tmp_path_factory):
    """A BPE and a WordPiece vocab learned by the JAX package."""
    d = tmp_path_factory.mktemp("vocabs")
    corpus = _corpus(0)
    vocab, merges = jax_bpe.learn_bpe(corpus, 300)
    vocab["<|endoftext|>"] = len(vocab)
    jax_bpe.save_bpe_files(str(d / "bpe"), vocab, merges)
    jax_bpe.save_wordpiece_vocab(str(d / "wp"),
                                 jax_bpe.learn_wordpiece(corpus, 400))
    return d


@pytest.mark.parametrize("kind", ["bpe", "wp"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ids_equal_jax_bitwise(vocabs, kind, seed):
    mine = tok.load_tokenizer(str(vocabs / kind))
    ref = jax_tok.load_tokenizer(str(vocabs / kind))
    assert type(mine).__name__ == type(ref).__name__
    assert mine.vocab_size == ref.vocab_size
    for text in _corpus(seed):
        ids = tok.encode_plain(mine, text)
        assert ids == jax_tok.encode_plain(ref, text)
        assert mine.decode(ids) == ref.decode(ids)
    assert tok.default_eos_id(mine) == jax_tok.default_eos_id(ref)


def test_wordpiece_pairs_segments_and_specials(vocabs):
    mine = tok.load_tokenizer(str(vocabs / "wp"))
    ref = jax_tok.load_tokenizer(str(vocabs / "wp"))
    a, b = "Über café 中文!", "don't  stop"
    assert mine.encode(a) == ref.encode(a)
    assert mine.encode(a, b) == ref.encode(a, b)
    assert mine.encode(a, b, add_special_tokens=False) == ref.encode(
        a, b, add_special_tokens=False)
    assert mine.encode_with_segments(a, b) == ref.encode_with_segments(a, b)
    assert mine.tokenize(a) == ref.tokenize(a)
    assert mine.mask_token_id == ref.mask_token_id == 4
    ids = mine.encode(a, b)
    assert mine.decode(ids, skip_special_tokens=False) == ref.decode(
        ids, skip_special_tokens=False)


def test_do_lower_case_and_missing_files(vocabs, tmp_path):
    wp = tmp_path / "wp"
    wp.mkdir()
    (wp / "vocab.txt").write_text((vocabs / "wp" / "vocab.txt").read_text())
    (wp / "tokenizer_config.json").write_text(
        json.dumps({"do_lower_case": False}))
    mine, ref = tok.load_tokenizer(str(wp)), jax_tok.load_tokenizer(str(wp))
    assert mine.lowercase is ref.lowercase is False
    assert mine.encode("Über Café") == ref.encode("Über Café")
    with pytest.raises(FileNotFoundError):
        tok.load_tokenizer(str(tmp_path / "none"))
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "vocab.json").write_text(json.dumps({"a": 0}))
    (bad / "merges.txt").write_text("#version: 0.2\na b\n")
    with pytest.raises(ValueError, match="does not match"):
        tok.load_tokenizer(str(bad))


def test_char_classes_are_regex_on_every_assigned_code_point():
    space, letter, number = (regex.compile(p)
                             for p in (r"\s", r"\p{L}", r"\p{N}"))
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        if unicodedata.category(ch) == "Cn":
            continue     # unassigned in Python's Unicode tables
        want = ("s" if space.match(ch) else "L" if letter.match(ch)
                else "N" if number.match(ch) else "o")
        assert tok._char_class(ch) == want, hex(cp)


def test_pretokenize_equals_gpt2_pattern():
    pat = regex.compile(jax_tok.GPT2_PRETOKENIZE_PATTERN)
    r = random.Random(0)
    alphabet = list("ab Z9'\t\n\r\x1c\xa0　é中!?.,-_") + PIECES
    for _ in range(3000):
        s = "".join(r.choice(alphabet) for _ in range(r.randint(0, 25)))
        assert tok.pretokenize(s) == pat.findall(s), repr(s)


def test_byte_table_equals_jax():
    assert tok.bytes_to_unicode() == jax_tok._bytes_to_unicode()
    assert np.array_equal(sorted(tok.bytes_to_unicode()), np.arange(256))
