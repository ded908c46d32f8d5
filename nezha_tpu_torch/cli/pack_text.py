"""Pack text files into a flat binary token file for the train CLI's
``--data-dir`` (counterpart of ``nezha-pack-text``)::

    python -m nezha_tpu_torch.cli.pack_text docs/ --out D/train.tokens.u16
    python -m nezha_tpu_torch.cli.pack_text src/ --learn-bpe 2000 \\
        --save-tokenizer D --out D/train.tokens.u16
    python -m nezha_tpu_torch.cli.pack_text notes/ --tokenizer D \\
        --out D/val.tokens.u16
    python -m nezha_tpu_torch.cli.train --config gpt2_124m --data-dir D

Byte-level by default (vocab 256). ``--tokenizer DIR`` encodes with the
GPT-2 BPE (``vocab.json`` + ``merges.txt``) or BERT WordPiece
(``vocab.txt``) files there; ``--learn-bpe N`` / ``--learn-wordpiece V``
learn one from the sources first and save it to ``--save-tokenizer``.
The output's suffix must match the vocabulary's dtype (``.u16`` when
every id fits, else ``.i32``): the train CLI reads the dtype from the
name. A tokenized pack writes ``<out>.meta.json`` beside it (the
tokenizer's kind, directory, vocab size and ``[MASK]`` id, which the
train CLI's BERT path reads). For the same sources every file written is
byte for byte the JAX CLI's. Prints ``{"files", "tokens", "tokenizer",
"vocab_size"}`` as JSON on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

from nezha_tpu_torch.data import pack
from nezha_tpu_torch.data.bpe_train import (learn_bpe, learn_wordpiece,
                                            save_bpe_files,
                                            save_wordpiece_vocab)
from nezha_tpu_torch.data.tokenizer import load_tokenizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nezha_tpu_torch.cli.pack_text",
        description="Pack text files/trees into a flat binary token file "
                    "for the train CLI's --data-dir.")
    p.add_argument("src", nargs="+",
                   help="text files and/or directories (directories are "
                        "walked for --suffix files)")
    p.add_argument("--out", required=True,
                   help="output token file, e.g. corpus/train.tokens.u16")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer directory (vocab.json+merges.txt for "
                        "GPT-2 BPE, vocab.txt for BERT WordPiece); "
                        "default: byte-level vocab 256")
    p.add_argument("--learn-bpe", type=int, default=None, metavar="MERGES",
                   help="learn a byte-level BPE tokenizer (vocab "
                        "256+MERGES) from the sources, save it to "
                        "--save-tokenizer, and pack with it")
    p.add_argument("--learn-wordpiece", type=int, default=None,
                   metavar="VOCAB",
                   help="learn a BERT WordPiece vocab.txt of this size "
                        "from the sources, save it to --save-tokenizer, "
                        "and pack with it")
    p.add_argument("--save-tokenizer", default=None,
                   help="output directory for the learned tokenizer files "
                        "(required with --learn-bpe/--learn-wordpiece)")
    p.add_argument("--suffix", nargs="+", default=[".txt", ".md", ".py"],
                   help="file suffixes picked up under directory sources")
    return p


def run(args) -> dict:
    paths = []
    for s in args.src:
        if os.path.isdir(s):
            paths.extend(pack.collect_paths(s, args.suffix))
        elif os.path.isfile(s):
            paths.append(s)
        else:
            raise SystemExit(f"no such file or directory: {s}")
    if not paths:
        raise SystemExit("no input files matched")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    learning = [x for x in (args.learn_bpe, args.learn_wordpiece)
                if x is not None]
    if learning:
        if args.tokenizer or len(learning) > 1:
            raise SystemExit("pass ONE of --tokenizer / --learn-bpe / "
                             "--learn-wordpiece")
        if not args.save_tokenizer:
            raise SystemExit("--learn-bpe/--learn-wordpiece need "
                             "--save-tokenizer DIR (training and "
                             "generation must reuse the learned "
                             "vocabulary)")
        if learning[0] < 1:
            raise SystemExit(f"learned vocab/merge count must be >= 1, "
                             f"got {learning[0]}")
        texts = (Path(p).read_text(encoding="utf-8")
                 for p in sorted(paths))
        if args.learn_bpe is not None:
            vocab, merges = learn_bpe(texts, args.learn_bpe)
            save_bpe_files(args.save_tokenizer, vocab, merges)
            print(f"learned BPE: {len(merges)} merges, vocab "
                  f"{len(vocab)} -> {args.save_tokenizer}",
                  file=sys.stderr)
        else:
            try:
                wvocab = learn_wordpiece(texts, args.learn_wordpiece)
            except ValueError as e:
                raise SystemExit(str(e))
            save_wordpiece_vocab(args.save_tokenizer, wvocab)
            print(f"learned WordPiece: vocab {len(wvocab)} -> "
                  f"{args.save_tokenizer}", file=sys.stderr)
        args.tokenizer = args.save_tokenizer
    if args.tokenizer:
        tok = load_tokenizer(args.tokenizer)
        vocab_size = tok.vocab_size
        dtype = pack.token_dtype(vocab_size)
        want = ".u16" if dtype == np.uint16 else ".i32"
        if not args.out.endswith(want):
            raise SystemExit(
                f"--out must end in {want} for a vocab of {vocab_size} "
                f"(the train CLI infers dtype from the filename)")
        n = pack.pack_text_files_tokenized(paths, args.out, tok,
                                           dtype=dtype)
        kind = type(tok).__name__
        mask_id = (tok.vocab.get(tok.mask_token)
                   if hasattr(tok, "vocab") else None)
        with open(args.out + ".meta.json", "w", encoding="utf-8") as f:
            json.dump({"tokenizer_kind": kind,
                       "tokenizer_dir": os.path.abspath(args.tokenizer),
                       "vocab_size": vocab_size,
                       "mask_token_id": mask_id}, f)
    else:
        if not args.out.endswith(".u16"):
            raise SystemExit("--out must end in .u16 for byte-level "
                             "packing (the train CLI infers dtype from "
                             "the filename)")
        n = pack.pack_text_files(paths, args.out)
        kind, vocab_size = "byte-level", 256
    print(f"packed {len(paths)} files -> {args.out}: {n} tokens ({kind})",
          file=sys.stderr)
    return {"files": len(paths), "tokens": int(n), "tokenizer": kind,
            "vocab_size": vocab_size}


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
