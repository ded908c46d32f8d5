"""Pack text files into flat binary token files for the native
``TokenLoader`` (counterpart of ``nezha_tpu/data/pack.py``): byte-level
(vocab 256) or through a tokenizer of :mod:`nezha_tpu_torch.data.
tokenizer`. For the same files the output is byte for byte the JAX
package's.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from nezha_tpu_torch.data.tokenizer import encode_plain

# Directories no packer descends into.
PRUNE_DIRS = (".git", "__pycache__", ".pytest_cache")


def collect_paths(root: str, suffixes: Sequence[str]) -> list:
    """Every ``suffixes`` file under ``root``, pruning :data:`PRUNE_DIRS`."""
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in PRUNE_DIRS]
        for f in filenames:
            if any(f.endswith(s) for s in suffixes):
                paths.append(os.path.join(dirpath, f))
    return paths


def pack_text_files(paths: Iterable[str], out_path: str,
                    dtype=np.uint16) -> int:
    """Concatenate files (sorted) as raw bytes, each followed by a
    newline -> ``out_path``; returns the token count."""
    total = 0
    with open(out_path, "wb") as out:
        for p in sorted(str(p) for p in paths):
            data = Path(p).read_bytes() + b"\n"
            np.frombuffer(data, np.uint8).astype(dtype).tofile(out)
            total += len(data)
    return total


def pack_tree(root: str, out_path: str,
              suffixes: Sequence[str] = (".py", ".md"),
              dtype=np.uint16) -> int:
    """Pack every ``suffixes`` file under ``root``, byte-level."""
    return pack_text_files(collect_paths(root, suffixes), out_path,
                           dtype=dtype)


def token_dtype(vocab_size: int):
    """uint16 when every id fits (GPT-2's 50257 and BERT's 30522 do),
    else int32: the one rule the packers and the file-name check share."""
    return np.uint16 if vocab_size <= 65536 else np.int32


def pack_text_files_tokenized(paths: Iterable[str], out_path: str,
                              tokenizer, dtype=None) -> int:
    """Encode files (sorted) with ``tokenizer`` -> a flat token file;
    returns the token count. Each file is followed by a document
    boundary: ``[SEP]`` where the vocabulary has it (WordPiece drops a
    bare newline), else the encoded newline. ``dtype=None`` follows
    :func:`token_dtype`. One file in memory at a time."""
    sep_tok = getattr(tokenizer, "sep_token", None)
    if sep_tok is not None and sep_tok in getattr(tokenizer, "vocab", {}):
        boundary = [tokenizer.vocab[sep_tok]]
    else:
        boundary = encode_plain(tokenizer, "\n")
    if dtype is None:
        dtype = token_dtype(tokenizer.vocab_size)
    total = 0
    with open(out_path, "wb") as out:
        for p in sorted(str(p) for p in paths):
            ids = encode_plain(tokenizer,
                               Path(p).read_text(encoding="utf-8"))
            ids.extend(boundary)
            np.asarray(ids, dtype=dtype).tofile(out)
            total += len(ids)
    return total
