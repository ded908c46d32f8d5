"""Serve GPT-2 from stdin JSONL — the port's counterpart of
``nezha-serve``'s stdio front end.

    python -m nezha_tpu_torch.cli.serve --random-init --model-preset full
    python -m nezha_tpu_torch.cli.serve --ckpt-dir C --tokenizer D

Weights come from ``--ckpt-dir`` (the newest checkpoint of either
package's train CLI that verifies: a dense npz, else a per-shard
``step_*.sharded``), from a Hugging Face ``GPT2LMHeadModel`` directory
(``--hf-dir``, fp32; its tokenizer files the default ``--tokenizer``) or
are seeded random (``--random-init``).
Each stdin line is one request object, with ``prompt_tokens`` or a text
``prompt`` (encoded with ``--tokenizer``, else byte-level)::

    {"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 8,
     "temperature": 0.8, "top_k": 40, "top_p": 0.9, "seed": 1,
     "eos_id": 50256, "deadline_s": 30, "priority": "batch",
     "tenant_id": "acme"}
    {"id": "b", "prompt": "def main(", "max_new_tokens": 8}

and each request gets one stdout line when it finishes, its tokens
decoded into ``text`` the same way::

    {"id": "a", "event": "done", "tokens": [...], "text": "...",
     "finish_reason": "length", "ttft_s": ..., "latency_s": ...}

``eos_id`` defaults to ``--eos-id``, else the tokenizer's EOS.

``priority`` (``interactive``, the default, ``batch`` or
``background``) picks the request's admission lane (``--priority-weights``
sets the lanes' shares) and ``tenant_id`` (default ``default``) the
tenant it counts against; past ``--tenant-queue-cap`` queued requests of
one tenant, a request gets ``{"id": ..., "event": "error", "error": ...,
"error_type": "tenant_over_limit"}``. ``--preemption on`` lets a
higher-priority arrival suspend a lower-priority decode, which resumes
later where it stood.

``--kv-layout dense`` keeps one worst-case reservation a slot instead of
the block pool. ``--speculative`` decodes through a draft: the target's
first ``--draft-layers`` blocks (default: all of them), or a draft from
``--draft-ckpt-dir`` / ``--draft-hf-dir``, proposing ``--draft-k`` tokens
a verify window.

A malformed line gets ``{"id": ..., "event": "error", "error": ...}``.
The server exits once stdin closes and every request has finished.

``--mesh M`` serves from a :class:`~nezha_tpu_torch.serve.ShardedEngine`
over M shards (the visible cards on ``cuda``; the CPU repeated on
``cpu``; ``--shard-device D`` puts every shard on D, e.g. M shards on
one card). With ``--ckpt-dir`` the training checkpoint is streamed onto
the mesh one leaf at a time (``reshard_checkpoint``: CRC-checked, never
gathered whole on one device); a corrupt or missing leaf is a refusal
to start. ``--prefill-mode sequence`` (with ``--mesh M``, M > 1) also
shards each prefill chunk's attention over the sequence, in the
``--seq-prefill-variant`` layout; ``--long-prefill-buckets`` adds chunk
widths above ``--max-prefill-len``. Speculative decoding under a mesh
is refused.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import torch

from nezha_tpu_torch.cli.common import (add_model_args, gpt2_for_preset,
                                        load_gpt2_for_inference,
                                        load_tokenizer_arg, resolve_eos_id)
from nezha_tpu_torch.data.tokenizer import encode_plain
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.parallel.mesh import make_mesh
from nezha_tpu_torch.serve import (Engine, QueueFull, Request, Scheduler,
                                   ServeConfig, ShardedEngine,
                                   SpeculativeConfig, TenantOverLimit)
from nezha_tpu_torch.serve.sharded import ReshardError, reshard_checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nezha_tpu_torch.cli.serve",
                                description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    add_model_args(p)
    p.add_argument("--max-batch-size", type=int, default=4)
    p.add_argument("--max-len", type=int, default=96,
                   help="per-slot KV capacity (prompt + generated)")
    p.add_argument("--max-prefill-len", type=int, default=32,
                   help="widest single prefill chunk; longer prompts (up "
                        "to --max-len) prefill in successive chunks")
    p.add_argument("--prefill-buckets", default=None,
                   help="comma-separated prompt pad widths (the last must "
                        "equal --max-prefill-len); default: powers of two "
                        "up to --max-prefill-len")
    p.add_argument("--decode-impl", choices=["auto", "kernel", "xla"],
                   default=None,
                   help="decode attention: auto/kernel = the flash-decode "
                        "kernels, xla = the composed masked path; default: "
                        "the model config's choice (auto)")
    p.add_argument("--long-prefill-buckets", default="",
                   help="comma-separated chunk widths above "
                        "--max-prefill-len (at most --max-len)")
    p.add_argument("--mesh", type=int, default=1,
                   help="tensor-parallel shards (>1: the sharded engine)")
    p.add_argument("--shard-device", default=None,
                   help="with --mesh: every shard on this device (M "
                        "shards on one card run one after another); "
                        "default: one visible card a shard on cuda, the "
                        "CPU on cpu")
    p.add_argument("--prefill-mode", choices=["replicated", "sequence"],
                   default="replicated",
                   help="sequence: shard each prefill chunk's attention "
                        "over the mesh too (needs --mesh M > 1)")
    p.add_argument("--seq-prefill-variant",
                   choices=["auto", "ulysses", "ring"], default="auto",
                   help="the sequence-sharded layout (auto: ulysses)")
    p.add_argument("--decode-horizon", type=int, default=1)
    p.add_argument("--kv-layout", choices=["paged", "dense"],
                   default="paged",
                   help="KV pool layout: paged = block-paged pool with "
                        "ref-counted blocks, lazy binding, and shared-"
                        "prefix prefill reuse (default); dense = the "
                        "classic worst-case per-slot reservation")
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--kv-num-blocks", type=int, default=None)
    p.add_argument("--prefix-cache", choices=["on", "off"], default="on")
    p.add_argument("--kv-eviction", choices=["lru", "none"], default="lru")
    p.add_argument("--cache-dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--kv-dtype", choices=["bf16", "int8"], default="bf16",
                   help="KV block storage: bf16 keeps --cache-dtype; int8 "
                        "stores int8 blocks with one fp32 scale per "
                        "(block, head), about 2x the resident blocks")
    p.add_argument("--speculative", action="store_true",
                   help="speculative decoding: a cheap DRAFT model "
                        "proposes --draft-k tokens per window, one "
                        "batched target forward verifies them all, and "
                        "the longest agreeing prefix is emitted (greedy "
                        "outputs unchanged; sampled by lossless rejection "
                        "sampling)")
    p.add_argument("--draft-k", type=int, default=4,
                   help="speculative: draft tokens proposed per verify "
                        "window (a window emits 1..draft_k+1 tokens)")
    p.add_argument("--draft-layers", type=int, default=None,
                   help="speculative: SELF-DRAFT depth — the draft is "
                        "the target's first N layers sharing its "
                        "weights; default: full depth (identity draft, "
                        "accept-rate ~1). Ignored with "
                        "--draft-ckpt-dir/--draft-hf-dir")
    p.add_argument("--draft-ckpt-dir", default=None,
                   help="speculative: load a SEPARATE draft model from "
                        "this train checkpoint dir (same tokenizer/vocab "
                        "as the target)")
    p.add_argument("--draft-hf-dir", default=None,
                   help="speculative: load the draft model from a "
                        "Hugging Face GPT2LMHeadModel directory")
    p.add_argument("--k-max", type=int, default=64)
    p.add_argument("--queue-capacity", type=int, default=16)
    p.add_argument("--priority-weights", default=None, metavar="SPEC",
                   help="WFQ admission-grant weights per priority lane "
                        "as 'interactive=4,batch=2,background=1' (the "
                        "default split): per 7 grants under full "
                        "backlog, 4 go interactive, 2 batch, 1 "
                        "background — lower lanes slow, never starve. "
                        "All three classes required, integer weights "
                        ">= 1")
    p.add_argument("--tenant-queue-cap", type=int, default=None,
                   help="max queued requests any ONE tenant may hold; "
                        "past it the tenant gets a typed "
                        "tenant_over_limit error while others keep "
                        "admitting (default: no per-tenant cap — only "
                        "the global --queue-capacity)")
    p.add_argument("--preemption", choices=["on", "off"], default="off",
                   help="under slot/block pressure, SUSPEND the lowest-"
                        "priority running decode — its KV blocks move "
                        "to the prefix trie (LRU-evictable) — and resume "
                        "it when pressure clears")
    p.add_argument("--preemption-budget", type=int, default=2,
                   help="times one request may be preempted before it "
                        "becomes unpreemptable (the anti-thrash bound)")
    p.add_argument("--max-new-tokens", type=int, default=32,
                   help="default and per-request cap")
    p.add_argument("--eos-id", type=int, default=None)
    return p


def _int_list(flag: str, value) -> tuple:
    try:
        return tuple(int(b) for b in str(value or "").split(",")
                     if b.strip())
    except ValueError:
        raise SystemExit(f"{flag} must be comma-separated ints, got "
                         f"{value!r}")


def _parse_priority_weights(spec):
    """'interactive=4,batch=2,background=1' -> dict (None passes through:
    ServeConfig then applies the default split)."""
    if spec is None:
        return None
    out = {}
    for part in str(spec).split(","):
        name, eq, val = part.partition("=")
        try:
            out[name.strip()] = int(val)
        except ValueError:
            raise SystemExit(f"--priority-weights must be 'class=int,...' "
                             f"pairs, got {part!r}")
        if not eq:
            raise SystemExit(f"--priority-weights must be 'class=int,...' "
                             f"pairs, got {part!r}")
    return out


def _draft_model(args):
    """``--speculative``'s explicit draft from ``--draft-ckpt-dir`` or
    ``--draft-hf-dir`` (None: the engine builds a self-draft), loaded as
    the target is."""
    if not (args.draft_ckpt_dir or args.draft_hf_dir):
        return None
    dargs = argparse.Namespace(**vars(args))
    dargs.ckpt_dir = args.draft_ckpt_dir
    dargs.hf_dir = args.draft_hf_dir
    dargs.random_init = False
    return load_gpt2_for_inference(dargs)


def build_scheduler(args) -> Scheduler:
    buckets = _int_list("--prefill-buckets", args.prefill_buckets)
    long_buckets = _int_list("--long-prefill-buckets",
                             args.long_prefill_buckets)
    if not args.speculative and (args.draft_ckpt_dir or args.draft_hf_dir):
        # A draft checkpoint without the knob would silently serve classic.
        raise SystemExit("--draft-ckpt-dir/--draft-hf-dir require "
                         "--speculative")
    if args.speculative and args.mesh > 1:
        raise SystemExit(f"--mesh {args.mesh} with --speculative: "
                         f"speculative decoding under a mesh is not ported "
                         f"(ROADMAP A6)")
    if args.prefill_mode == "sequence" and args.mesh < 2:
        # Refused before any model is built: a 1-shard mesh has no
        # sequence axis to shard over.
        raise SystemExit("--prefill-mode sequence requires --mesh M with "
                         "M > 1 (the chunk is sharded over the mesh's "
                         "sequence axis)")
    devices = ([args.shard_device] * args.mesh if args.shard_device
               else None)
    mesh = None
    if args.mesh > 1:
        # Refused before the model is built on a card that may not exist.
        try:
            mesh = make_mesh({"tp": args.mesh}, devices,
                             torch.device(args.device).type)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: too few CUDA cards: {e}")
    shards = None
    if mesh is not None and args.ckpt_dir:
        shards, model = reshard_onto(args, mesh)
    else:
        model = load_gpt2_for_inference(args)
    spec = draft = None
    if args.speculative:
        spec = SpeculativeConfig(draft_k=args.draft_k,
                                 draft_layers=args.draft_layers)
        draft = _draft_model(args)
    try:
        cfg = ServeConfig(
            max_batch_size=args.max_batch_size,
            max_len=min(args.max_len, model.cfg.max_positions),
            max_prefill_len=args.max_prefill_len,
            prefill_buckets=buckets,
            long_prefill_buckets=long_buckets,
            prefill_mode=args.prefill_mode,
            seq_prefill_variant=args.seq_prefill_variant,
            decode_horizon=args.decode_horizon,
            decode_impl=args.decode_impl,
            kv_layout=args.kv_layout,
            kv_block_size=args.kv_block_size,
            kv_num_blocks=args.kv_num_blocks,
            prefix_cache=args.prefix_cache == "on",
            kv_eviction=args.kv_eviction,
            cache_dtype=(torch.float32 if args.cache_dtype == "f32"
                         else torch.bfloat16),
            kv_dtype=args.kv_dtype,
            k_max=args.k_max, queue_capacity=args.queue_capacity,
            speculative=spec,
            priority_weights=_parse_priority_weights(args.priority_weights),
            tenant_queue_cap=args.tenant_queue_cap,
            preemption=args.preemption == "on",
            preemption_budget=args.preemption_budget)
    except ValueError as e:
        raise SystemExit(f"serve config: {e}")
    if args.mesh > 1:
        try:
            engine = ShardedEngine(model, cfg, mesh_devices=args.mesh,
                                   devices=mesh.devices, shards=shards)
        except ValueError as e:
            # Topology constraints (heads % mesh, bucket divisibility,
            # too few cards) as the CLI's typed refusal.
            raise SystemExit(f"--mesh {args.mesh}: {e}")
    else:
        try:
            engine = Engine(model, cfg, draft_model=draft)
        except ValueError as e:
            # The draft's checks (vocabulary, positions, depth).
            raise SystemExit(f"--speculative: {e}")
    return Scheduler(engine)


def reshard_onto(args, mesh):
    """``--mesh M --ckpt-dir``: the preset's model (its structure) and
    the checkpoint streamed onto ``mesh``; the topology is checked before
    the load, and a reshard fault exits typed."""
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    m = mesh.size
    model = gpt2_for_preset(args.model_preset, seed=args.seed,
                            device=args.device)
    if model.cfg.num_heads % m:
        raise SystemExit(f"--mesh {m}: num_heads={model.cfg.num_heads} "
                         f"not divisible by the mesh -- K/V pools shard "
                         f"on the head axis")
    try:
        shards, step = reshard_checkpoint(args.ckpt_dir, model, mesh)
    except ReshardError as e:
        raise SystemExit(f"--mesh {m}: reshard refused: {e}")
    print(f"resharded step {step} from {args.ckpt_dir} onto a 1x{m} "
          f"serve mesh", file=sys.stderr, flush=True)
    return shards, model


def parse_request(obj, args, vocab: int, tokenizer=None,
                  eos_id=None) -> Request:
    """One wire object -> Request. Raises ValueError on bad input."""
    if not isinstance(obj, dict):
        raise ValueError("request must be a JSON object")
    if ("prompt_tokens" in obj) == ("prompt" in obj):
        raise ValueError("pass exactly one of prompt_tokens / prompt")
    if "prompt_tokens" in obj:
        prompt = [int(t) for t in obj["prompt_tokens"]]
    else:
        text = obj["prompt"]
        if not isinstance(text, str) or not text:
            raise ValueError("prompt must be a non-empty string")
        prompt = (encode_plain(tokenizer, text) if tokenizer is not None
                  else list(text.encode("utf-8")))
    if not prompt:
        raise ValueError("prompt encoded to zero tokens")
    if max(prompt) >= vocab or min(prompt) < 0:
        raise ValueError(f"prompt ids must be in [0, {vocab})")

    def num(key, cast, default=None):
        v = obj.get(key, default)
        if v is None:
            return None
        try:
            return cast(v)
        except (TypeError, ValueError):
            raise ValueError(f"{key} must be a number, got {v!r}")

    priority = obj.get("priority", "interactive")
    if not isinstance(priority, str):
        raise ValueError(f"priority must be a string, got {priority!r}")
    tenant_id = obj.get("tenant_id", "default")
    if not isinstance(tenant_id, str):
        raise ValueError(f"tenant_id must be a string, got {tenant_id!r}")
    return Request(
        priority=priority, tenant_id=tenant_id,
        prompt=prompt,
        max_new_tokens=min(num("max_new_tokens", int, args.max_new_tokens),
                           args.max_new_tokens),
        temperature=num("temperature", float, 0.0),
        top_k=num("top_k", int), top_p=num("top_p", float),
        eos_id=num("eos_id", int, eos_id),
        seed=num("seed", int, args.seed),
        deadline_s=num("deadline_s", float),
        request_id=obj.get("id"))


def decode_text(tokens, tokenizer) -> str:
    """Tokens -> text: the tokenizer's decode, else byte-level (ids
    past 255 skipped)."""
    if tokenizer is not None:
        return tokenizer.decode(tokens)
    return bytes(t for t in tokens if t < 256).decode("utf-8",
                                                       errors="replace")


def run_stdio(scheduler: Scheduler, args, stdin=None, stdout=None,
              tokenizer=None) -> int:
    """A reader thread feeds the queue as lines arrive (waiting for room:
    stdin is the backpressure channel); this thread drives decoding."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    out_lock = threading.Lock()

    def emit(obj):
        with out_lock:
            stdout.write(json.dumps(obj) + "\n")
            stdout.flush()

    def on_finish(res):
        out = {"id": res.request_id, "event": "done", "tokens": res.tokens,
               "text": decode_text(res.tokens, tokenizer),
               "finish_reason": res.finish_reason, "ttft_s": res.ttft_s,
               "latency_s": res.latency_s}
        if res.error is not None:
            out["error"] = res.error
        emit(out)
        scheduler.results.pop(res.request_id, None)

    scheduler.on_finish = on_finish
    vocab = scheduler.engine.vocab
    eos_id = resolve_eos_id(args.eos_id, tokenizer, vocab)
    done_reading = threading.Event()

    def reader():
        try:
            for line in stdin:
                line = line.strip()
                if not line:
                    continue
                obj = None
                try:
                    obj = json.loads(line)
                    req = parse_request(obj, args, vocab, tokenizer,
                                        eos_id)
                except ValueError as e:
                    rid = obj.get("id") if isinstance(obj, dict) else None
                    emit({"id": rid, "event": "error", "error": str(e)})
                    continue
                while True:
                    if scheduler.queue_depth >= scheduler.queue_capacity:
                        time.sleep(0.005)
                        continue
                    try:
                        scheduler.submit(req)
                        break
                    except TenantOverLimit as e:
                        # Typed, as the reference's HTTP front end answers
                        # it: this tenant is over ITS cap, the queue is not
                        # full.
                        emit({"id": req.request_id, "event": "error",
                              "error": str(e),
                              "error_type": "tenant_over_limit"})
                        break
                    except QueueFull:
                        time.sleep(0.005)
                    except ValueError as e:
                        emit({"id": req.request_id, "event": "error",
                              "error": str(e)})
                        break
        finally:
            done_reading.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    while not done_reading.is_set() or scheduler.has_work():
        if not scheduler.step():
            time.sleep(0.002)
    t.join(timeout=5.0)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        scheduler = build_scheduler(args)
    except NotPortedError as e:
        raise SystemExit(f"nezha_tpu_torch.cli.serve: {e}")
    return run_stdio(scheduler, args, tokenizer=load_tokenizer_arg(args))


if __name__ == "__main__":
    sys.exit(main())
