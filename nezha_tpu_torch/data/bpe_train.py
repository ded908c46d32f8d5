"""Learn a GPT-2 BPE or a BERT WordPiece vocabulary from a corpus, with
no network (counterpart of ``nezha_tpu/data/bpe_train.py``): given the
same ordered corpus, the files written are byte for byte the JAX
package's.

BPE: the word-frequency recipe over GPT-2's pre-tokenization and byte
map, merging the most frequent adjacent pair; WordPiece: over the
encoder's basic split, merging the pair of largest ``count(ab) /
(count(a) count(b))``. Pair counts are kept incrementally; ties break by
first-seen order (insertion-ordered dicts, so no hash seed enters).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Tuple

from nezha_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                            bytes_to_unicode, pretokenize)

__all__ = ["learn_bpe", "save_bpe_files", "learn_wordpiece",
           "save_wordpiece_vocab"]


def _word_counts(texts: Iterable[str]) -> Counter:
    benc = bytes_to_unicode()
    words: Counter = Counter()
    for text in texts:
        for tok in pretokenize(text):
            words[tuple(benc[b] for b in tok.encode("utf-8"))] += 1
    return words


def learn_bpe(texts: Iterable[str], num_merges: int
              ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """-> (vocab token->id, ordered merges). Vocab = the 256 byte symbols
    (sorted, matching the test/learner convention) + one entry per merge;
    ``vocab_size == 256 + num_merges`` (fewer if the corpus exhausts)."""
    words = dict(_word_counts(texts))
    # pair -> count, and pair -> set of words containing it (for
    # incremental updates); first_seen breaks count ties deterministically.
    pair_counts: Counter = Counter()
    # insertion-ORDERED dict-as-set: iteration order must not depend on
    # PYTHONHASHSEED, or first_seen tie-break ranks (assigned while
    # re-adding affected words) differ across interpreter runs.
    pair_words: Dict[Tuple[str, str], dict] = {}
    first_seen: Dict[Tuple[str, str], int] = {}

    def add_word(w: Tuple[str, ...], c: int) -> None:
        for i in range(len(w) - 1):
            p = (w[i], w[i + 1])
            pair_counts[p] += c
            pair_words.setdefault(p, {})[w] = None
            if p not in first_seen:
                first_seen[p] = len(first_seen)

    def drop_word(w: Tuple[str, ...], c: int) -> None:
        for i in range(len(w) - 1):
            p = (w[i], w[i + 1])
            pair_counts[p] -= c
            if pair_counts[p] <= 0:
                del pair_counts[p]
                pair_words.pop(p, None)
            else:
                s = pair_words.get(p)
                if s is not None:
                    s.pop(w, None)

    for w, c in words.items():
        add_word(w, c)

    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        if not pair_counts:
            break
        best = max(pair_counts,
                   key=lambda p: (pair_counts[p], -first_seen[p]))
        a, b = best
        merges.append(best)
        affected = list(pair_words.get(best, ()))
        for w in affected:
            c = words.pop(w, None)
            if c is None:
                continue
            drop_word(w, c)
            out: List[str] = []
            i = 0
            while i < len(w):
                if i < len(w) - 1 and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            nw = tuple(out)
            words[nw] = words.get(nw, 0) + c
            add_word(nw, c)

    benc = bytes_to_unicode()
    vocab = {ch: i for i, ch in enumerate(sorted(benc.values()))}
    for a, b in merges:
        vocab[a + b] = len(vocab)
    return vocab, merges


def save_bpe_files(path: str, vocab: Dict[str, int],
                   merges: List[Tuple[str, str]]) -> None:
    """Write the standard on-disk format (`load_tokenizer` reads it back)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")


def learn_wordpiece(texts: Iterable[str], vocab_size: int,
                    lowercase: bool = True,
                    specials: Tuple[str, ...] = ("[PAD]", "[UNK]", "[CLS]",
                                                 "[SEP]", "[MASK]")
                    ) -> List[str]:
    """Learn a BERT-style ``vocab.txt`` (ordered token list) from a corpus.

    WordPiece scoring (the BERT recipe): merge the pair maximizing
    ``count(ab) / (count(a) * count(b))`` — likelihood gain rather than
    raw frequency — over words from the SAME basic tokenization the
    WordPiece encoder applies (clean / CJK-space / optional lowercase+
    accent-strip / punct-split), so learned pieces match encode-time word
    boundaries. Continuation pieces get the ``##`` prefix. The vocab is
    specials + every single character (guaranteeing totality: any
    in-corpus word tokenizes without [UNK]) + merged pieces, until
    ``vocab_size``; a target smaller than specials+alphabet is refused
    (truncating characters would silently [UNK] real words). Pair and
    symbol counts are maintained incrementally (same structure as
    :func:`learn_bpe`). Deterministic for an ordered corpus (score ties
    break first-seen).
    """
    # The encoder's own basic split, so pieces meet encode-time words.
    basic = WordPieceTokenizer({}, lowercase=lowercase)
    words: Counter = Counter()
    for text in texts:
        for w in basic.basic_split(text):
            words[w] += 1

    # Symbol sequences: first char bare, continuations ## -prefixed.
    seqs: Dict[Tuple[str, ...], int] = {}
    for w, c in words.items():
        seq = tuple([w[0]] + [f"##{ch}" for ch in w[1:]])
        seqs[seq] = seqs.get(seq, 0) + c

    char_vocab = sorted({s for seq in seqs for s in seq})
    floor = len(specials) + len(char_vocab)
    if vocab_size < floor:
        raise ValueError(
            f"vocab_size {vocab_size} is below specials+alphabet "
            f"({floor}); truncating characters would silently [UNK] "
            f"real words — raise the target")
    vocab: List[str] = list(specials) + char_vocab
    vocab_set = set(vocab)

    pair_counts: Counter = Counter()
    # ordered dict-as-set; see learn_bpe's note on PYTHONHASHSEED.
    pair_seqs: Dict[Tuple[str, str], dict] = {}
    first_seen: Dict[Tuple[str, str], int] = {}
    sym_counts: Counter = Counter()

    def add_seq(seq: Tuple[str, ...], c: int) -> None:
        for s_ in seq:
            sym_counts[s_] += c
        for i in range(len(seq) - 1):
            p = (seq[i], seq[i + 1])
            pair_counts[p] += c
            pair_seqs.setdefault(p, {})[seq] = None
            if p not in first_seen:
                first_seen[p] = len(first_seen)

    def drop_seq(seq: Tuple[str, ...], c: int) -> None:
        for s_ in seq:
            sym_counts[s_] -= c
        for i in range(len(seq) - 1):
            p = (seq[i], seq[i + 1])
            pair_counts[p] -= c
            if pair_counts[p] <= 0:
                del pair_counts[p]
                pair_seqs.pop(p, None)
            else:
                ss = pair_seqs.get(p)
                if ss is not None:
                    ss.pop(seq, None)

    for seq, c in seqs.items():
        add_seq(seq, c)

    while len(vocab) < vocab_size:
        if not pair_counts:
            break
        best = max(pair_counts, key=lambda p: (
            pair_counts[p] / (sym_counts[p[0]] * sym_counts[p[1]]),
            -first_seen[p]))
        a, b = best
        merged = a + b[2:]  # b is always ##-prefixed: only position 0 of
        # a word is bare, and merges preserve that invariant.
        if merged not in vocab_set:  # distinct pairs can merge to the
            vocab.append(merged)     # same string (ab+##c vs a+##bc)
            vocab_set.add(merged)
        for seq in list(pair_seqs.get(best, ())):
            c = seqs.pop(seq, None)
            if c is None:
                continue
            drop_seq(seq, c)
            out: List[str] = []
            i = 0
            while i < len(seq):
                if i < len(seq) - 1 and seq[i] == a and seq[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            nseq = tuple(out)
            seqs[nseq] = seqs.get(nseq, 0) + c
            add_seq(nseq, c)
    return vocab


def save_wordpiece_vocab(path: str, vocab: List[str]) -> None:
    """Write ``vocab.txt`` (one token per line; `load_tokenizer` reads it
    back as a WordPiece tokenizer)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        for tok in vocab:
            f.write(tok + "\n")
