"""The losses of GPT-2's objective and of the image and MLP configs
(counterpart of ``nezha_tpu/ops/losses.py``). Loss math runs in fp32
whatever the policy. The LM losses' ``ignore_index`` and ``bias`` serve
BERT's MLM head: positions labelled ``ignore_index`` leave the mean, and
the per-vocab output bias is added to the compute-dtype logits.
"""

from __future__ import annotations

from typing import Optional

import torch

from nezha_tpu_torch.errors import NotPortedError


def softmax_cross_entropy_with_integer_labels(
        logits: torch.Tensor, labels: torch.Tensor,
        ignore_index: Optional[int] = None,
        label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over integer labels, from fp32 log-softmax. Positions whose
    label is ``ignore_index`` are left out of the mean (a mean over none
    is 0). ``label_smoothing=eps`` trains against ``(1 - eps) * one_hot +
    eps / V``, computed as ``(1 - eps) * picked + eps * mean(logp)``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    kept = None if ignore_index is None else labels != ignore_index
    safe = labels if kept is None else torch.where(kept, labels, 0)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    if label_smoothing:
        eps = label_smoothing
        picked = (1.0 - eps) * picked + eps * logp.mean(dim=-1)
    if kept is None:
        return -picked.mean()
    mask = kept.float()
    return -(picked * mask).sum() / mask.sum().clamp_min(1.0)


def lm_cross_entropy_from_hidden(hidden: torch.Tensor, emb: torch.Tensor,
                                 targets: torch.Tensor,
                                 ignore_index: Optional[int] = None,
                                 bias: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Tied-head LM CE: logits ``hidden @ emb.T`` in the compute dtype
    (bf16 under the bf16 policy), plus ``bias`` cast to that dtype,
    upcast to fp32 only inside the logsumexp; the picked logit is upcast
    on its own. Positions whose target is ``ignore_index`` leave the
    mean, which is taken over the kept ones (a mean over none is 0)."""
    logits = hidden @ emb.to(hidden.dtype).t()
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    lse = torch.logsumexp(logits.float(), dim=-1)
    targets = targets.long()
    if ignore_index is None:
        picked = logits.gather(-1, targets[..., None])[..., 0]
        return (lse - picked.float()).mean()
    kept = targets != ignore_index
    safe = torch.where(kept, targets, 0)
    picked = logits.gather(-1, safe[..., None])[..., 0]
    mask = kept.float()
    return ((lse - picked.float()) * mask).sum() / mask.sum().clamp_min(1.0)


def lm_ce_from_fused(out: dict, targets: torch.Tensor,
                     ignore_index: Optional[int] = None) -> torch.Tensor:
    """CE from a fused-head model output ``{"hidden", "wte", "chunk"}``,
    with an optional ``"bias"`` (BERT's ``mlm_bias``). ``chunk == -1`` is
    the dense compute-dtype logit path; the sequence-chunked scan
    (``chunk > 0``) is not ported."""
    if out["chunk"] != -1:
        raise NotPortedError(
            f"fused_loss_chunk={out['chunk']}: only -1 (dense bf16 logits, "
            f"fp32 logsumexp) is ported; the chunked scan is not")
    return lm_cross_entropy_from_hidden(out["hidden"], out["wte"], targets,
                                        ignore_index=ignore_index,
                                        bias=out.get("bias"))


def lm_objective(out, targets: torch.Tensor) -> torch.Tensor:
    """Next-token CE for any GPT-2 forward output: dense logits, the MoE
    ``{"logits", "aux_loss"}`` dict, or the fused-head dict (with or
    without ``"aux_loss"``); the pre-weighted MoE load-balance loss is
    added when present."""
    if isinstance(out, dict):
        aux = out.get("aux_loss", 0.0)
        if "logits" in out:
            return softmax_cross_entropy_with_integer_labels(
                out["logits"], targets) + aux
        return lm_ce_from_fused(out, targets) + aux
    return softmax_cross_entropy_with_integer_labels(out, targets)
