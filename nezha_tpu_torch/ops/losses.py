"""The losses GPT-2's objective reaches (counterpart of
``nezha_tpu/ops/losses.py``). Loss math runs in fp32 whatever the policy.
The JAX functions' ``ignore_index``, ``label_smoothing`` and ``bias``
serve BERT and the image configs, which are not ported yet.
"""

from __future__ import annotations

import torch

from nezha_tpu_torch.errors import NotPortedError


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor
                                              ) -> torch.Tensor:
    """Mean CE over integer labels, from fp32 log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def lm_cross_entropy_from_hidden(hidden: torch.Tensor, emb: torch.Tensor,
                                 targets: torch.Tensor) -> torch.Tensor:
    """Tied-head LM CE: logits ``hidden @ emb.T`` in the compute dtype
    (bf16 under the bf16 policy), upcast to fp32 only inside the
    logsumexp; the picked logit is upcast on its own."""
    logits = hidden @ emb.to(hidden.dtype).t()
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - picked.float()).mean()


def lm_ce_from_fused(out: dict, targets: torch.Tensor) -> torch.Tensor:
    """CE from a fused-head model output ``{"hidden", "wte", "chunk"}``.
    ``chunk == -1`` is the dense compute-dtype logit path; the
    sequence-chunked scan (``chunk > 0``) is not ported."""
    if out["chunk"] != -1:
        raise NotPortedError(
            f"fused_loss_chunk={out['chunk']}: only -1 (dense bf16 logits, "
            f"fp32 logsumexp) is ported; the chunked scan is not")
    return lm_cross_entropy_from_hidden(out["hidden"], out["wte"], targets)


def lm_objective(out, targets: torch.Tensor) -> torch.Tensor:
    """Next-token CE for a GPT-2 forward output: dense logits or the
    fused-head dict (the JAX function also takes the MoE outputs, which
    are not ported)."""
    if isinstance(out, dict):
        return lm_ce_from_fused(out, targets)
    return softmax_cross_entropy_with_integer_labels(out, targets)
