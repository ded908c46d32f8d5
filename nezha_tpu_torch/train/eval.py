"""Evaluation: metric sums accumulated over a batch stream (counterpart
of ``nezha_tpu/train/eval.py``'s ``accuracy``, ``lm_token_stats``,
``mlm_token_stats``, ``make_eval_step`` and ``evaluate``).

The model runs in ``eval()`` mode under ``torch.no_grad()``, so
BatchNorm normalizes with its running statistics and nothing updates
them. The sums stay on the device; the host reads them once, at the end.
The port's modules carry their own weights, so the step and
``evaluate`` take no ``variables``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import math

import torch

from nezha_tpu_torch.ops.losses import lm_ce_from_fused
from nezha_tpu_torch.train.loop import batch_to_device

EvalStep = Callable[[dict, Optional[Dict[str, torch.Tensor]]],
                    Dict[str, torch.Tensor]]


def accuracy(logits: torch.Tensor, batch: dict) -> Dict[str, torch.Tensor]:
    """Top-1 against ``batch["label"]``: the count correct, and of all."""
    pred = logits.argmax(dim=-1)
    return {"correct": (pred == batch["label"]).sum(),
            "count": torch.tensor(pred.numel(), device=pred.device)}


def lm_token_stats(out, batch: dict) -> Dict[str, torch.Tensor]:
    """Next-token NLL summed over ``{"tokens": [B, S + 1]}``, and the
    count of targets (-> perplexity). ``out``: dense logits, the MoE
    logits dict (its NLL only: no aux in eval) or the fused-head dict."""
    targets = batch["tokens"][:, 1:].long()
    count = torch.tensor(targets.numel(), device=targets.device)
    if isinstance(out, dict) and "logits" in out:
        out = out["logits"]
    if isinstance(out, dict):
        return {"nll_sum": lm_ce_from_fused(out, targets) * count,
                "count": count}
    logp = torch.log_softmax(out.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])
    return {"nll_sum": nll.sum(), "count": count}


def mlm_token_stats(out, batch: dict) -> Dict[str, torch.Tensor]:
    """Masked-LM NLL summed over the predicted positions (labels not
    -100), and their count (-> masked perplexity). ``out``: dense logits
    (the model's eval-mode output) or the fused-head dict."""
    labels = batch["labels"].long()
    valid = labels != -100
    count = valid.sum()
    if isinstance(out, dict):
        mean_nll = lm_ce_from_fused(out, labels, ignore_index=-100)
        return {"nll_sum": mean_nll * count, "count": count}
    logp = torch.log_softmax(out.float(), dim=-1)
    safe = torch.where(valid, labels, 0)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return {"nll_sum": torch.where(valid, nll, 0.0).sum(), "count": count}


def make_eval_step(model: torch.nn.Module, stat_fn: Callable) -> EvalStep:
    """-> ``step(batch, acc) -> acc``: the model's eval-mode output on
    ``batch`` through ``stat_fn``, added to the sums ``acc`` (None at the
    start); floating sums fp32, integer ones int64."""
    device = next(model.parameters()).device

    def widen(v: torch.Tensor) -> torch.Tensor:
        return v.float() if v.is_floating_point() else v.long()

    @torch.no_grad()
    def step(batch: dict, acc):
        batch = batch_to_device(batch, device)
        training = model.training
        model.eval()
        try:
            stats = {k: widen(v)
                     for k, v in stat_fn(model(batch), batch).items()}
        finally:
            model.train(training)
        if acc is None:
            return stats
        return {k: acc[k] + stats[k] for k in stats}

    return step


def evaluate(model: torch.nn.Module, batches: Iterator[dict],
             stat_fn: Callable = accuracy,
             max_batches: Optional[int] = None,
             group=None) -> Dict[str, float]:
    """Run the model over ``batches`` (at most ``max_batches``) and read
    the sums: -> the sums as floats, ``accuracy`` when ``stat_fn`` gives
    ``correct`` and ``count``, ``perplexity`` when it gives ``nll_sum``
    and ``count``, and ``batches``.

    With ``group`` (a ``torch.distributed`` group), each rank's
    ``batches`` are its rows of the same global batches, some of them
    possibly empty; the sums are added over the group before they are
    read, so every rank returns the whole split's metrics."""
    step = make_eval_step(model, stat_fn)
    acc = None
    n = 0
    for batch in batches:
        if max_batches is not None and n >= max_batches:
            break
        n += 1
        if len(next(iter(batch.values()))):
            acc = step(batch, acc)
    out = {k: float(v) for k, v in (acc or {}).items()}
    if group is not None:
        import torch.distributed as dist

        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, out, group=group)
        out = {}
        for part in parts:
            for k, v in part.items():
                out[k] = out.get(k, 0.0) + v
    if not out:
        raise ValueError("no batches to evaluate")
    if "correct" in out and out.get("count"):
        out["accuracy"] = out["correct"] / out["count"]
    if "nll_sum" in out and out.get("count"):
        out["perplexity"] = math.exp(out["nll_sum"] / out["count"])
    out["batches"] = n
    return out
