"""GPT-2 byte-level BPE and BERT WordPiece tokenizers (counterpart of
``nezha_tpu/data/tokenizer.py``): the same on-disk formats
(``vocab.json`` + ``merges.txt``, ``vocab.txt``), the same ids.

The JAX package splits text before BPE with GPT-2's pattern through the
``regex`` package (``\\p{L}``/``\\p{N}`` classes). The port needs no
package beyond torch and numpy, so this module walks the pattern by hand
(:func:`pretokenize`) over ``unicodedata`` categories: letters are the
``L*`` categories, numbers ``N*``, whitespace what ``regex`` calls
``\\s`` (``str.isspace`` less U+001C-U+001F). On every character that
Python's Unicode tables assign, these classes are ``regex``'s; a
character assigned only by a newer Unicode version counts as
punctuation here (``tests/test_torch_tokenizer.py`` holds both over
every code point).
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["GPT2BPETokenizer", "WordPieceTokenizer", "load_tokenizer",
           "encode_plain", "default_eos_id", "pretokenize"]

_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# regex's \s is Unicode White_Space: str.isspace() also takes the four
# ASCII separators U+001C-U+001F, which regex does not.
_NOT_REGEX_SPACE = frozenset("\x1c\x1d\x1e\x1f")


@functools.lru_cache(maxsize=65536)
def _char_class(ch: str) -> str:
    """"s" (whitespace), "L" (letter), "N" (number) or "o" (other)."""
    if ch.isspace() and ch not in _NOT_REGEX_SPACE:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


def pretokenize(text: str) -> List[str]:
    """``regex.findall`` of GPT-2's pattern, ``'s|'t|'re|'ve|'m|'ll|'d|
    ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``: at each
    position the first alternative that matches, each run greedy."""
    out: List[str] = []
    n, i = len(text), 0
    cls = [_char_class(c) for c in text]
    while i < n:
        ch = text[i]
        if ch == "'":
            c = next((c for c in _CONTRACTIONS
                      if text.startswith(c, i + 1)), None)
            if c is not None:
                out.append("'" + c)
                i += 1 + len(c)
                continue
        start = i
        if ch == " " and i + 1 < n and cls[i + 1] != "s":
            i += 1           # " ?" joins the run that follows
        k = cls[i]
        if k != "s":
            j = i + 1
            while j < n and cls[j] == k:
                j += 1
            out.append(text[start:j])
            i = j
            continue
        j = i + 1
        while j < n and cls[j] == "s":
            j += 1
        # \s+(?!\S): the whole run at the end of the text, else all but
        # its last character (which joins the next word), else \s+ alone.
        if j < n and j - i >= 2:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte <-> printable-character table: every byte maps to a
    character that survives a text file (control and whitespace bytes
    move above U+0100)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2BPETokenizer:
    """Byte-level BPE over ``vocab.json`` / ``merges.txt``: GPT-2's
    pre-tokenization (:func:`pretokenize`), the byte -> character map,
    then the lowest-rank merge first within each word."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "GPT2BPETokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        # A merge whose output is not in the vocab means the two files
        # come from different tokenizers: refuse here, not mid-corpus.
        missing = [a + b for a, b in merges if a + b not in vocab]
        if missing:
            raise ValueError(
                f"{merges_txt} does not match {vocab_json}: "
                f"{len(missing)} merge output(s) missing from the vocab "
                f"(first: {missing[0]!r}) — the two files must come from "
                f"the same tokenizer")
        return cls(vocab, merges)

    @classmethod
    def from_dir(cls, path: str) -> "GPT2BPETokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"))

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (word[i] == a and i < len(word) - 1
                        and word[i + 1] == b):
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        if len(self._cache) < 65536:
            self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        enc, benc = self.encoder, self.byte_encoder
        for tok in pretokenize(text):
            mapped = "".join(benc[b] for b in tok.encode("utf-8"))
            ids.extend(enc[p] for p in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids if i in self.decoder)
        return bytes(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII symbols split like punctuation (BERT's convention).
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """BERT's tokenizer: the basic split (clean, CJK characters apart,
    lowercase and accents stripped, punctuation apart), then the greedy
    longest match over ``vocab.txt`` (``##`` marks a continuation)."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", mask_token: str = "[MASK]",
                 pad_token: str = "[PAD]",
                 max_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.lowercase = lowercase
        self.unk_token, self.cls_token = unk_token, cls_token
        self.sep_token, self.mask_token = sep_token, mask_token
        self.pad_token = pad_token
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_files(cls, vocab_txt: str, lowercase: bool = True,
                   **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(vocab_txt, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        self = cls(vocab, lowercase=lowercase, **kw)
        missing = [t for t in (self.unk_token, self.cls_token,
                               self.sep_token) if t not in vocab]
        if missing:
            raise ValueError(
                f"{vocab_txt} is not a usable WordPiece vocab: missing "
                f"special token(s) {missing} — is this really a BERT "
                f"vocab.txt?")
        return self

    @classmethod
    def from_dir(cls, path: str, **kw) -> "WordPieceTokenizer":
        return cls.from_files(os.path.join(path, "vocab.txt"), **kw)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def mask_token_id(self) -> int:
        try:
            return self.vocab[self.mask_token]
        except KeyError:
            raise ValueError(
                f"this WordPiece vocab has no {self.mask_token!r} token, "
                f"so it cannot drive MLM masking — re-learn/re-download a "
                f"vocab with the BERT specials or pass an explicit mask "
                f"id") from None

    def basic_split(self, text: str) -> List[str]:
        """The words before WordPiece (the JAX package's ``_basic``)."""
        cleaned: List[str] = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in (
                    "Cc", "Cf"):
                if ch not in ("\t", "\n", "\r"):
                    continue
            if _is_cjk(cp):
                cleaned.append(f" {ch} ")
            elif ch.isspace():
                cleaned.append(" ")
            else:
                cleaned.append(ch)
        words: List[str] = []
        for w in "".join(cleaned).split():
            if self.lowercase:
                w = w.lower()
                w = "".join(c for c in unicodedata.normalize("NFD", w)
                            if unicodedata.category(c) != "Mn")
            cur = ""
            for ch in w:
                if _is_punctuation(ch):
                    if cur:
                        words.append(cur)
                        cur = ""
                    words.append(ch)
                else:
                    cur += ch
            if cur:
                words.append(cur)
        return words

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for w in self.basic_split(text):
            out.extend(self._wordpiece(w))
        return out

    def encode(self, text: str, text_pair: str | None = None,
               add_special_tokens: bool = True) -> List[int]:
        """-> ids, ``[CLS] a [SEP]`` (``[CLS] a [SEP] b [SEP]`` for a
        pair) with ``add_special_tokens``."""
        ids = [self.vocab[t] for t in self.tokenize(text)]
        if text_pair is None:
            if add_special_tokens:
                return ([self.vocab[self.cls_token]] + ids
                        + [self.vocab[self.sep_token]])
            return ids
        ids2 = [self.vocab[t] for t in self.tokenize(text_pair)]
        if not add_special_tokens:
            return ids + ids2
        return ([self.vocab[self.cls_token]] + ids
                + [self.vocab[self.sep_token]] + ids2
                + [self.vocab[self.sep_token]])

    def encode_with_segments(self, text: str, text_pair: str):
        """A pair -> (ids, segment ids): 0 through the first ``[SEP]``,
        1 after it."""
        a = [self.vocab[t] for t in self.tokenize(text)]
        b = [self.vocab[t] for t in self.tokenize(text_pair)]
        cls_, sep = self.vocab[self.cls_token], self.vocab[self.sep_token]
        ids = [cls_] + a + [sep] + b + [sep]
        segs = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        return ids, segs

    def decode(self, ids: Iterable[int],
               skip_special_tokens: bool = True) -> str:
        specials = {self.cls_token, self.sep_token, self.pad_token,
                    self.mask_token}
        toks = [self.ids_to_tokens[i] for i in ids
                if i in self.ids_to_tokens]
        if skip_special_tokens:
            toks = [t for t in toks if t not in specials]
        out: List[str] = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)


def load_tokenizer(path: str):
    """The tokenizer in directory ``path``: ``vocab.json`` +
    ``merges.txt`` -> GPT-2 BPE; ``vocab.txt`` -> WordPiece, lowercase
    unless ``tokenizer_config.json`` says ``do_lower_case: false``."""
    if os.path.isfile(os.path.join(path, "vocab.json")) and \
            os.path.isfile(os.path.join(path, "merges.txt")):
        return GPT2BPETokenizer.from_dir(path)
    if os.path.isfile(os.path.join(path, "vocab.txt")):
        lower = True
        cfgp = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(cfgp):
            try:
                with open(cfgp, encoding="utf-8") as f:
                    lower = bool(json.load(f).get("do_lower_case", True))
            except (OSError, ValueError):
                pass
        return WordPieceTokenizer.from_dir(path, lowercase=lower)
    raise FileNotFoundError(
        f"no tokenizer files in {path}: expected vocab.json+merges.txt "
        f"(GPT-2 BPE) or vocab.txt (BERT WordPiece)")


def encode_plain(tokenizer, text: str) -> List[int]:
    """Ids without special tokens, whatever the tokenizer: the packed
    stream's and the generation prompt's encoding."""
    if isinstance(tokenizer, WordPieceTokenizer):
        return tokenizer.encode(text, add_special_tokens=False)
    return tokenizer.encode(text)


def default_eos_id(tokenizer) -> "int | None":
    """The vocabulary's end-of-sequence id: GPT-2 BPE's
    ``<|endoftext|>``, WordPiece's ``[SEP]``; None when it has none."""
    if isinstance(tokenizer, GPT2BPETokenizer):
        return tokenizer.encoder.get("<|endoftext|>")
    if isinstance(tokenizer, WordPieceTokenizer):
        return tokenizer.vocab.get(tokenizer.sep_token)
    return None
