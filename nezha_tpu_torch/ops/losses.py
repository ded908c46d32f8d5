"""The losses of GPT-2's objective and of the image and MLP configs
(counterpart of ``nezha_tpu/ops/losses.py``). Loss math runs in fp32
whatever the policy. The LM losses' ``ignore_index`` and ``bias`` serve
BERT's MLM head: positions labelled ``ignore_index`` leave the mean, and
the per-vocab output bias is added to the compute-dtype logits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt


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


def _fp32_logits(hidden: torch.Tensor, emb: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``hidden @ emb.T`` with fp32 products and sums of the operands'
    own values (JAX's ``preferred_element_type=float32`` dot: a bf16
    product is exact in fp32), plus ``bias`` in fp32."""
    logits = hidden.float() @ emb.float().t()
    if bias is not None:
        logits = logits + bias.float()
    return logits


def _slice_nll(hidden: torch.Tensor, emb: torch.Tensor,
               targets: torch.Tensor, bias: Optional[torch.Tensor],
               ignore_index: Optional[int]):
    """One slice's (summed NLL, counted positions) from its fp32 logits
    and fp32 log-softmax."""
    logp = torch.log_softmax(_fp32_logits(hidden, emb, bias), dim=-1)
    if ignore_index is None:
        picked = logp.gather(-1, targets[..., None])[..., 0]
        return -picked.sum(), torch.tensor(float(picked.numel()),
                                           device=picked.device)
    kept = targets != ignore_index
    picked = logp.gather(-1, torch.where(kept, targets, 0)[..., None])[..., 0]
    mask = kept.float()
    return -(picked * mask).sum(), mask.sum()


def chunked_lm_cross_entropy(hidden: torch.Tensor, emb: torch.Tensor,
                             targets: torch.Tensor, chunk: int = 128,
                             ignore_index: Optional[int] = None,
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Tied-head LM CE that never holds the whole ``[B, S, V]`` logits:
    the sequence runs in slices of ``chunk`` positions, each slice's
    logits ``[B, chunk, V]`` computed from ``emb`` cast to the hidden
    state's dtype with fp32 products and sums, its log-softmax in fp32,
    folded into the NLL sum and freed; the backward recomputes each slice
    (``torch.utils.checkpoint``, non-reentrant), so one slice's logits
    are live at a time in both directions. ``hidden [B, S, H]``, ``emb
    [V, H]``, ``targets [B, S]``; positions whose target is
    ``ignore_index`` leave the mean; ``bias [V]`` is added to the logits.
    ``S <= chunk`` takes the dense path (one slice is cheaper); a ragged
    ``S`` raises ``ValueError`` (JAX's) rather than materialize the
    logits. -> the mean CE (fp32)."""
    s = hidden.shape[1]
    # Rounded to the compute dtype, held once in fp32 for every slice.
    emb = emb.to(hidden.dtype).float()
    targets = targets.long()
    if s <= chunk:
        return softmax_cross_entropy_with_integer_labels(
            _fp32_logits(hidden, emb, bias), targets,
            ignore_index=ignore_index)
    if s % chunk:
        raise ValueError(
            f"sequence length {s} not divisible by loss chunk {chunk}; "
            f"pick a divisor (or <= {chunk} positions for the dense path)")
    total = count = None
    for c0 in range(0, s, chunk):
        nll, n = _ckpt.checkpoint(
            _slice_nll, hidden[:, c0:c0 + chunk], emb,
            targets[:, c0:c0 + chunk], bias, ignore_index,
            use_reentrant=False)
        total = nll if total is None else total + nll
        count = n if count is None else count + n
    return total / count.clamp_min(1.0)


def lm_ce_from_fused(out: dict, targets: torch.Tensor,
                     ignore_index: Optional[int] = None) -> torch.Tensor:
    """CE from a fused-head model output ``{"hidden", "wte", "chunk"}``,
    with an optional ``"bias"`` (BERT's ``mlm_bias``): ``chunk == -1`` is
    the dense compute-dtype logit path, ``chunk > 0`` the sequence-chunked
    one (:func:`chunked_lm_cross_entropy`)."""
    if out["chunk"] == -1:
        return lm_cross_entropy_from_hidden(out["hidden"], out["wte"],
                                            targets,
                                            ignore_index=ignore_index,
                                            bias=out.get("bias"))
    return chunked_lm_cross_entropy(out["hidden"], out["wte"], targets,
                                    chunk=out["chunk"],
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
