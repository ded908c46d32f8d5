"""KV-cache text generation — the port's counterpart of ``nezha-generate``.

    python -m nezha_tpu_torch.cli.generate --random-init --model-preset full \\
        --prompt-tokens 15496,995 --max-new-tokens 32 --temperature 0.8 \\
        --top-k 40
    python -m nezha_tpu_torch.cli.generate --ckpt-dir C --tokenizer D \\
        --prompt "def main(" --max-new-tokens 32 --temperature 0

Weights: ``--ckpt-dir`` (the newest checkpoint of either package's train
CLI that verifies: a dense npz, else a per-shard ``step_*.sharded``),
a Hugging Face ``GPT2LMHeadModel`` directory (``--hf-dir``: its config,
fp32, its tokenizer files the default ``--tokenizer``) or seeded random
(``--random-init``). As in JAX
the full preset decodes in bf16 and the tiny one in fp32;
``--ln-impl pallas`` runs every LayerNorm on the fused kernels.

Prompts: token ids (``--prompt-tokens 15496,995``), a binary token file
(``--prompt-file``, uint16, or int32 with ``--prompt-i32``), or text
(``--prompt``), encoded with ``--tokenizer`` (no special tokens) or else
byte-level (the vocab-256 encoding of ``data/pack.py``). Prints one JSON
object: ``prompt_len``, ``tokens``, ``text`` (decoded by the tokenizer,
with ``unknown_tokens`` counting ids outside its vocab; byte-level for a
text prompt without one, with ``non_byte_tokens``), ``eos_id`` when set
(default: the tokenizer's EOS), and with ``--num-samples N > 1`` the
``samples`` list of N sampled continuations of the one prompt, decoded
together as one batch. Runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from nezha_tpu_torch.cli.common import (add_model_args,
                                        load_gpt2_for_inference,
                                        load_tokenizer_arg, resolve_eos_id)
from nezha_tpu_torch.data.tokenizer import encode_plain
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models.generate import generate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nezha_tpu_torch.cli.generate",
                                description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--ln-impl", choices=["xla", "pallas"], default="xla",
                   help="LayerNorm: tensor ops, or the fused kernels")
    p.add_argument("--prompt-tokens", default=None,
                   help="comma-separated token ids, e.g. 15496,995")
    p.add_argument("--prompt", default=None,
                   help="text, encoded with --tokenizer (else "
                        "byte-level); the output decodes back to text")
    p.add_argument("--prompt-file", default=None,
                   help="binary token file (uint16 unless --prompt-i32)")
    p.add_argument("--prompt-i32", action="store_true")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=1.0,
                   help="0 = greedy argmax")
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None,
                   help="nucleus sampling: keep the smallest prefix of "
                        "descending-prob tokens with mass >= p")
    p.add_argument("--eos-id", type=int, default=None,
                   help="stop rows that emit this token (later positions "
                        "pad with it); -1 disables")
    p.add_argument("--num-samples", type=int, default=1,
                   help="decode N sampled continuations of ONE prompt in "
                        "a single batch (temperature > 0)")
    return p


def _prompt_ids(args, tokenizer=None) -> np.ndarray:
    given = [x is not None
             for x in (args.prompt_tokens, args.prompt, args.prompt_file)]
    if sum(given) != 1:
        raise SystemExit("pass exactly one of "
                         "--prompt-tokens/--prompt/--prompt-file")
    if args.prompt is not None:
        if not args.prompt:
            raise SystemExit("--prompt is empty")
        if tokenizer is not None:
            ids = np.asarray(encode_plain(tokenizer, args.prompt), np.int64)
            if ids.size == 0:
                raise SystemExit("--prompt encoded to zero tokens")
            return ids[None, :]
        ids = np.frombuffer(args.prompt.encode("utf-8"), np.uint8)
        return ids.astype(np.int64)[None, :]
    if args.prompt_tokens is not None:
        try:
            ids = [int(t) for t in args.prompt_tokens.split(",") if t.strip()]
        except ValueError:
            raise SystemExit(f"--prompt-tokens must be comma-separated ids, "
                             f"got {args.prompt_tokens!r}")
        if not ids:
            raise SystemExit("--prompt-tokens is empty")
        return np.asarray([ids], np.int64)
    dtype = np.int32 if args.prompt_i32 else np.uint16
    ids = np.fromfile(args.prompt_file, dtype=dtype).astype(np.int64)
    if ids.size == 0:
        raise SystemExit(f"{args.prompt_file} holds no tokens")
    return ids[None, :]


def run(args) -> dict:
    """Generate as the flags say, print the JSON result and return it.
    Raises NotPortedError for a refused flag."""
    model = load_gpt2_for_inference(args, ln_impl=args.ln_impl)
    tokenizer = load_tokenizer_arg(args)
    prompt = _prompt_ids(args, tokenizer)
    vocab = model.cfg.vocab_size
    if tokenizer is not None and tokenizer.vocab_size > vocab:
        raise SystemExit(
            f"tokenizer vocab {tokenizer.vocab_size} exceeds model vocab "
            f"{vocab}; wrong --tokenizer for this checkpoint?")
    if prompt.max() >= vocab or prompt.min() < 0:
        raise SystemExit(f"prompt ids must be in [0, {vocab}); "
                         f"got max {int(prompt.max())}")
    limit = model.cfg.max_positions - prompt.shape[1]
    if args.max_new_tokens > limit:
        raise SystemExit(f"prompt ({prompt.shape[1]} tokens) + "
                         f"--max-new-tokens {args.max_new_tokens} exceeds "
                         f"max_positions {model.cfg.max_positions}")
    if args.max_new_tokens < 1:
        raise SystemExit(f"--max-new-tokens must be >= 1, got "
                         f"{args.max_new_tokens}")
    if args.top_k is not None and not 1 <= args.top_k <= vocab:
        raise SystemExit(f"--top-k must be in [1, {vocab}] for this "
                         f"model's vocab, got {args.top_k}")
    if args.num_samples < 1:
        raise SystemExit(f"--num-samples must be >= 1, got "
                         f"{args.num_samples}")
    if args.num_samples > 1 and args.temperature == 0.0:
        raise SystemExit("--num-samples > 1 needs sampling (greedy "
                         "decoding is deterministic — every sample would "
                         "be identical); pass --temperature > 0")
    eos_id = resolve_eos_id(args.eos_id, tokenizer, vocab)
    if args.num_samples > 1:
        prompt = np.repeat(prompt, args.num_samples, axis=0)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(args.seed)
    out = generate(model, torch.from_numpy(prompt),
                   max_new_tokens=args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, generator=gen, eos_id=eos_id)
    rows = out[:, prompt.shape[1]:].cpu().tolist()

    def row_result(new_tokens: list) -> dict:
        result = {"tokens": new_tokens}
        if tokenizer is not None:
            # decode() skips ids outside the vocab: count them loudly.
            known = (tokenizer.decoder if hasattr(tokenizer, "decoder")
                     else tokenizer.ids_to_tokens)
            dropped = sum(t not in known for t in new_tokens)
            result["text"] = tokenizer.decode(new_tokens)
            if dropped:
                result["unknown_tokens"] = dropped
                print(f"warning: {dropped}/{len(new_tokens)} generated ids "
                      f"are outside this tokenizer's vocab "
                      f"({tokenizer.vocab_size}) — wrong --tokenizer for "
                      f"this checkpoint? \"text\" is partial",
                      file=sys.stderr)
        elif args.prompt is not None:
            # Byte-level round trip; ids >= 256 have no byte and are
            # counted, not silently dropped.
            dropped = sum(t >= 256 for t in new_tokens)
            result["text"] = bytes(t for t in new_tokens if t < 256).decode(
                "utf-8", errors="replace")
            if dropped:
                result["non_byte_tokens"] = dropped
                print(f"warning: {dropped}/{len(new_tokens)} generated ids "
                      f"are >= 256; \"text\" is partial", file=sys.stderr)
        return result

    samples = [row_result(r) for r in rows]
    result = {"prompt_len": int(prompt.shape[1]), **samples[0]}
    if eos_id is not None:
        result["eos_id"] = eos_id
    if args.num_samples > 1:
        result["num_samples"] = args.num_samples
        result["samples"] = samples
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    try:
        run(build_parser().parse_args(argv))
    except NotPortedError as e:
        raise SystemExit(f"nezha_tpu_torch.cli.generate: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
