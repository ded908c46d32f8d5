"""The spread of flash against composed attention gradients on one CUDA
card, over several seeds: what ``chip_smoke.py``'s train check
(TRAIN_GRAD_RTOL) is set from.

    python3 tools/grad_spread.py [--seeds 0 1 2 3 4 5]

For each seed: GPT-2 124M at full width with seeded random weights
(bf16 compute, ``fused_loss_chunk=-1``, as the train phase), one batch of
``synthetic_token_batches`` (B=8, S=1024) from the same seed, and the
loss and gradients of one step with flash attention and with composed
attention from the same weights and batch. Prints per seed the loss
difference and, over the parameters, the largest ``|g - g_ref| /
|g_ref|`` (norms), then the largest over the seeds. Needs the card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import TRAIN_B, TRAIN_LR, TRAIN_S  # noqa: E402
from nezha_tpu_torch.cli.common import gpt2_for_preset  # noqa: E402
from nezha_tpu_torch.data import synthetic_token_batches  # noqa: E402
from nezha_tpu_torch.models.gpt2 import lm_loss  # noqa: E402
from nezha_tpu_torch.optim import adamw  # noqa: E402
from nezha_tpu_torch.train import make_train_step  # noqa: E402


def one_seed(seed: int) -> dict:
    batch = next(synthetic_token_batches(TRAIN_B, seq_len=TRAIN_S,
                                         seed=seed))
    model = gpt2_for_preset("full", seed=seed, device="cuda",
                            fused_loss_chunk=-1)
    ref = gpt2_for_preset("full", seed=seed, device="cuda",
                          fused_loss_chunk=-1, attn_impl="xla")
    ref.load_state_dict(model.state_dict())
    results = []
    for m in (model, ref):
        step = make_train_step(m, adamw(TRAIN_LR, weight_decay=0.1),
                               lm_loss)
        loss, grads = step.loss_and_grads(batch)
        results.append((loss.item(), grads))
    (loss, grads), (loss_r, grads_r) = results
    rel = {name: ((g - grads_r[name]).norm()
                  / grads_r[name].norm().clamp_min(1e-30)).item()
           for name, g in grads.items()}
    worst = max(rel, key=rel.get)
    return {"seed": seed, "loss_err": abs(loss - loss_r),
            "max_grad_rel_err": rel[worst], "worst_param": worst,
            "median_grad_rel_err": sorted(rel.values())[len(rel) // 2]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+",
                   default=[0, 1, 2, 3, 4, 5])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    rows = []
    for seed in args.seeds:
        rows.append(one_seed(seed))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"seeds": len(rows),
                      "max_grad_rel_err": max(r["max_grad_rel_err"]
                                              for r in rows),
                      "max_loss_err": max(r["loss_err"] for r in rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
