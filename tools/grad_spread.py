"""The spread of flash against composed attention gradients on one CUDA
card, over several seeds: what ``chip_smoke.py``'s train checks
(TRAIN_GRAD_RTOL for GPT-2, BERT_LOSS_ATOL and BERT_GRAD_RTOL for
BERT) are set from.

    python3 tools/grad_spread.py [--config bert_base_zero1] \
        [--seeds 0 1 2 3 4 5]

For each seed, ``--config gpt2_124m`` (the default): GPT-2 124M at full
width with seeded random weights (bf16 compute, ``fused_loss_chunk=-1``,
as the train phase), one batch of ``synthetic_token_batches`` (B=8,
S=1024) from the same seed, and the loss and gradients of one step with
flash attention and with composed attention from the same weights and
batch. ``--config bert_base_zero1``: BERT-base as the train_bert phase
builds it (bf16, the fused MLM head), one batch of
``synthetic_mlm_batches`` (B=16, S=512) from the seed, the same
comparison on that batch and on it right-padded to the phase's lengths
(``kv_lengths``, labels -100 past them); then, on the first seed, two
controls that a check with these limits must catch: ``scores_fp8`` (the
composed path's bf16 scores rounded to float8 e4m3: 3 mantissa bits
against bf16's 7) and ``lengths_plus_one`` (on the right-padded batch,
the composed path attends one key past each length). ``--sp ring|ulysses`` (GPT-2): the sequence-parallel step at
``dp=1,sp=SP_M`` on the card repeated (``--sp-flash off``: the composed
attention) against the one-device flash step from the same weights and
batch, what ``chip_smoke.py``'s SP_GRAD_RTOL is set from; on the first
seed the control ``block_lse`` (ring only): each hop's backward reads
its own block's lse and output in place of the global ones. ``--graph``
(GPT-2): the graph engine's bf16 program (``--graph-bf16``: its loss
graph's gradients through ``torch.autograd.grad``) against the module
engine's flash step from the same weights and batch, what
``chip_smoke.py``'s GRAPH_GRAD_RTOL and GRAPH_LOSS_ATOL are set from; on
the first seed the control ``fp32_program``: the fp32 program against
the same bf16 module step. Prints per
run the loss difference and, over the parameters, the largest ``|g -
g_ref| / |g_ref|`` (norms), then the largest over the seeds. Needs the
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BERT_B, BERT_LR, BERT_PAD_LENGTHS, BERT_S,  # noqa
                        BERT_WD, SP_M, TRAIN_B, TRAIN_LR, TRAIN_S,
                        right_padded)
from nezha_tpu_torch.cli.common import gpt2_for_preset  # noqa: E402
from nezha_tpu_torch.data import (synthetic_mlm_batches,  # noqa: E402
                                  synthetic_token_batches)
from nezha_tpu_torch.models import bert as bert_mod  # noqa: E402
from nezha_tpu_torch.models.gpt2 import lm_loss  # noqa: E402
from nezha_tpu_torch.optim import adamw  # noqa: E402
from nezha_tpu_torch.train import make_train_step  # noqa: E402


def spread(model, ref, batch, loss_fn, lr, wd, ref_batch=None) -> dict:
    """One step's loss and gradients of ``model`` on ``batch`` and of
    ``ref`` on ``ref_batch`` (``batch`` when None), from the same
    weights: the loss difference and the gradients' relative norms."""
    results = []
    for m, b in ((model, batch), (ref, ref_batch or batch)):
        step = make_train_step(m, adamw(lr, weight_decay=wd), loss_fn)
        results.append(step.loss_and_grads(b))
    return compare(*results)


def compare(got, ref) -> dict:
    """(loss, gradients) against the reference's: the loss difference
    and the gradients' relative norms."""
    (loss, grads), (loss_r, grads_r) = got, ref
    loss, loss_r = loss.item(), loss_r.item()
    rel = {name: ((g - grads_r[name]).norm()
                  / grads_r[name].norm().clamp_min(1e-30)).item()
           for name, g in grads.items()}
    worst = max(rel, key=rel.get)
    return {"loss_err": abs(loss - loss_r),
            "max_grad_rel_err": rel[worst], "worst_param": worst,
            "median_grad_rel_err": sorted(rel.values())[len(rel) // 2]}


def one_seed(seed: int) -> dict:
    batch = next(synthetic_token_batches(TRAIN_B, seq_len=TRAIN_S,
                                         seed=seed))
    model = gpt2_for_preset("full", seed=seed, device="cuda",
                            fused_loss_chunk=-1)
    ref = gpt2_for_preset("full", seed=seed, device="cuda",
                          fused_loss_chunk=-1, attn_impl="xla")
    ref.load_state_dict(model.state_dict())
    return {"seed": seed, **spread(model, ref, batch, lm_loss, TRAIN_LR,
                                   0.1)}


def sp_seed(seed: int, impl: str, flash, control: bool) -> list:
    """The sp step (``impl``, ``sp_use_flash=flash``) at dp=1,sp=SP_M on
    the card repeated against the one-device flash step; with
    ``control`` also the ring whose hops read their own block's lse and
    output in the backward."""
    from nezha_tpu_torch.models.gpt2 import with_overrides
    from nezha_tpu_torch.ops.cuda.flash_attention import flash_block_fwd
    from nezha_tpu_torch.parallel import ring
    from nezha_tpu_torch.parallel.mesh import make_sp_mesh
    from nezha_tpu_torch.parallel.sequence_parallel import SPTrainStep

    batch = next(synthetic_token_batches(TRAIN_B, seq_len=TRAIN_S,
                                         seed=seed))
    model = gpt2_for_preset("full", seed=seed, device="cuda",
                            fused_loss_chunk=-1)
    opt = adamw(TRAIN_LR, weight_decay=0.1)
    one = make_train_step(model, opt, lm_loss).loss_and_grads(batch)
    step = SPTrainStep(with_overrides(model, attn_impl=impl,
                                      sp_use_flash=flash), opt,
                       make_sp_mesh({"dp": 1, "sp": SP_M},
                                    [torch.device("cuda", 0)] * SP_M))
    tag = {"seed": seed, "sp": impl, "sp_flash": flash}
    rows = [{**tag, **compare(step.loss_and_grads(batch), one)}]
    if control:
        plain = ring.flash_block_bwd

        def block_lse(q, k, v, o, lse, do, causal, scale=None):
            o, lse = flash_block_fwd(q, k, v, causal, scale)
            return plain(q, k, v, o, lse, do, causal, scale)

        ring.flash_block_bwd = block_lse
        try:
            rows.append({**tag, "control": "block_lse",
                         **compare(step.loss_and_grads(batch), one)})
        finally:
            ring.flash_block_bwd = plain
    return rows


def graph_seed(seed: int, control: bool) -> list:
    """The graph engine's bf16 GPT-2 program against the module engine's
    step (the config's first-step schedule), from the same weights and
    batch; with ``control`` also the fp32 program."""
    from chip_smoke import graph_grads, module_grads
    from nezha_tpu_torch.cli.train import GPT2_SCHEDULE
    from nezha_tpu_torch.graph import programs
    from nezha_tpu_torch.models.convert import _to_jax_path

    raw = next(synthetic_token_batches(TRAIN_B, seq_len=TRAIN_S,
                                       seed=seed))
    feed = programs.lm_shard_fn()(raw)
    model = gpt2_for_preset("full", seed=seed, device="cuda",
                            fused_loss_chunk=-1)
    params = programs.init_graph_gpt2_state(model)["params"]
    loss_m, grads_m, _ = module_grads(model, raw, GPT2_SCHEDULE(3))
    ref = (loss_m, {_to_jax_path(n): g for n, g in grads_m.items()})
    rows = []
    for tag, dtype in (("bf16", "bfloat16"),) + (
            (("fp32_program", "float32"),) if control else ()):
        row = {"seed": seed, "graph": dtype,
               **compare(graph_grads(model.cfg, params, feed, dtype), ref)}
        if tag != "bf16":
            row["control"] = tag
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def bert_pair(seed: int):
    """BERT-base as chip_smoke's train_bert builds it, seeded with
    ``seed``, flash and composed, the same weights."""
    def build(**kw):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return bert_mod.bert_base(fused_loss_chunk=-1, generator=gen, **kw)

    model, ref = build(), build(attn_impl="xla")
    ref.load_state_dict(model.state_dict())
    return model, ref


def fp8_scores_attention(q, k, v, mask=None, scale=None):
    """The composed attention with its bf16 scores rounded to float8
    e4m3 (the ``scores_fp8`` control)."""
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(
        torch.float8_e4m3fn).float() * scale
    if mask is not None:
        scores = scores + mask
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def bert_seed(seed: int, controls: bool) -> list:
    batch = next(synthetic_mlm_batches(BERT_B, seq_len=BERT_S, seed=seed))
    padded = right_padded(batch, BERT_PAD_LENGTHS)
    args = (bert_mod.mlm_loss, BERT_LR, BERT_WD)
    rows = []
    for tag, b in (("full", batch), ("right_padded", padded)):
        rows.append({"seed": seed, "batch": tag,
                     **spread(*bert_pair(seed), b, *args)})
        torch.cuda.empty_cache()
    if not controls:
        return rows
    plain = bert_mod.dot_product_attention
    bert_mod.dot_product_attention = fp8_scores_attention
    try:
        rows.append({"seed": seed, "batch": "full", "control": "scores_fp8",
                     **spread(*bert_pair(seed), batch, *args)})
    finally:
        bert_mod.dot_product_attention = plain
    longer = {**padded, "kv_lengths": (padded["kv_lengths"] + 1).clip(
        max=BERT_S)}
    rows.append({"seed": seed, "batch": "right_padded",
                 "control": "lengths_plus_one",
                 **spread(*bert_pair(seed), padded, *args, ref_batch=longer)})
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=["gpt2_124m", "bert_base_zero1"],
                   default="gpt2_124m")
    p.add_argument("--seeds", type=int, nargs="+",
                   default=[0, 1, 2, 3, 4, 5])
    p.add_argument("--sp", choices=["ring", "ulysses"], default=None,
                   help="gpt2_124m: the sp step against one device")
    p.add_argument("--sp-flash", choices=["auto", "off"], default="auto")
    p.add_argument("--graph", action="store_true",
                   help="gpt2_124m: the graph engine's bf16 program "
                        "against the module engine")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    rows = []
    for i, seed in enumerate(args.seeds):
        if args.config == "bert_base_zero1":
            new = bert_seed(seed, controls=i == 0)
        elif args.graph:
            new = graph_seed(seed, control=i == 0)
        elif args.sp:
            new = sp_seed(seed, args.sp, {"auto": None,
                                          "off": False}[args.sp_flash],
                          control=i == 0 and args.sp == "ring"
                          and args.sp_flash == "auto")
        else:
            new = [one_seed(seed)]
        for row in new:
            print(json.dumps(row), flush=True)
        rows += new
        torch.cuda.empty_cache()
    runs = [r for r in rows if "control" not in r]
    print(json.dumps({"config": args.config, "sp": args.sp,
                      "graph": args.graph,
                      "sp_flash": args.sp_flash, "seeds": len(args.seeds),
                      "max_grad_rel_err": max(r["max_grad_rel_err"]
                                              for r in runs),
                      "max_loss_err": max(r["loss_err"] for r in runs),
                      "controls": [r for r in rows if "control" in r]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
