"""The spread of ResNet-50's bf16 step against its fp32 step (TF32 off)
on one CUDA card, over several seeds, and two lower-precision controls:
what ``chip_smoke.py``'s image check (IMAGE_* limits) is set from.

    python3 tools/image_check_spread.py [--seeds 0 1 2 3] [--out FILE]

For each seed: ``chip_smoke.image_step_errors`` on one batch of
``synthetic_image_batches`` (B=IMG_CHECK_B, 224 px) from that seed, with
the weights of ``chip_smoke.image_check_models(seed)``: the loss's
relative error, the whole gradient's and the worst tensor's distance and
cosine, and the worst BatchNorm layer's batch mean (in units of its
standard deviation) and batch variance (relative). Then the same for
two controls, each a BatchNorm that does in bf16 what the port does in
fp32, patched into the bf16 model for the run:

- ``bf16_stats``: the statistics reduced in bf16, one pass
  (``mean(x * x) - mean(x) ** 2``, each a bf16 result);
- ``bf16_state``: the fp32 statistics, but the running buffers rounded
  to bf16 after the update (state kept in the compute dtype).

Prints one JSON line per run, then the largest reading over the seeds,
the limits, and for each control the limits it breaks; exits 1 if a
control run breaks none. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from chip_smoke import IMG_CHECK_B, IMG_SIZE  # noqa: E402
from chip_smoke import image_check_failures, image_step_errors  # noqa: E402
from nezha_tpu_torch.data import synthetic_image_batches  # noqa: E402
from nezha_tpu_torch.nn.layers import BatchNorm  # noqa: E402

PORT_FORWARD = BatchNorm.forward


def _normalize(self, x, mean, var):
    """The port's update and normalization from given statistics."""
    m = self.momentum
    with torch.no_grad():
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)
    scale = self.scale.float() * torch.rsqrt(var + self.eps)
    shift = self.bias.float() - mean * scale
    per_channel = (-1,) + (1,) * (x.dim() - 2)
    y = torch.addcmul(shift.to(x.dtype).view(per_channel), x,
                      scale.to(x.dtype).view(per_channel))
    return self.policy.cast_output(y)


def bf16_stats_forward(self, x):
    if not self.training or x.dtype == torch.float32:
        return PORT_FORWARD(self, x)
    reduce = (0,) + tuple(range(2, x.dim()))
    mean = x.mean(dim=reduce)
    var = (x * x).mean(dim=reduce) - mean * mean
    return _normalize(self, x, mean.float(), var.float())


def bf16_state_forward(self, x):
    y = PORT_FORWARD(self, x)
    if self.training and x.dtype != torch.float32:
        with torch.no_grad():
            for buf in (self.mean, self.var):
                buf.copy_(buf.to(x.dtype))
    return y


CONTROLS = {"bf16_stats": bf16_stats_forward,
            "bf16_state": bf16_state_forward}
READINGS = ("loss_rel_err", "grad_rel_err_whole", "batch_mean_err_worst",
            "batch_var_rel_err_worst")


def run(seed: int, control: str = "") -> dict:
    batch = next(synthetic_image_batches(IMG_CHECK_B, IMG_SIZE, seed=seed))
    BatchNorm.forward = CONTROLS.get(control, PORT_FORWARD)
    try:
        errs = image_step_errors(batch, seed)
    finally:
        BatchNorm.forward = PORT_FORWARD
        torch.cuda.empty_cache()
    errs["control"] = control or None
    errs["breaks"] = image_check_failures(errs)
    return errs


def reading(errs: dict, key: str) -> float:
    v = errs[key]
    return v[0] if isinstance(v, list) else v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    lines = []

    def emit(obj):
        line = json.dumps(obj)
        lines.append(line)
        print(line, flush=True)

    runs = [run(seed) for seed in args.seeds]
    for errs in runs:
        emit(errs)
    worst = {k: max(reading(e, k) for e in runs) for k in READINGS}
    worst["grad_cos_worst_tensor"] = min(
        e["grad_cos_worst_tensor"][0] for e in runs)
    limits = {name: getattr(chip_smoke, name) for name in (
        "IMAGE_LOSS_RTOL", "IMAGE_GRAD_RTOL", "IMAGE_GRAD_COS",
        "IMAGE_MEAN_TOL", "IMAGE_VAR_RTOL")}
    emit({"over_seeds": args.seeds, "worst": worst, "limits": limits,
          "card": card})
    controls = [run(seed, control) for control in CONTROLS
                for seed in args.seeds[:2]]
    for errs in controls:
        emit(errs)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0 if all(e["breaks"] for e in controls) else 1


if __name__ == "__main__":
    sys.exit(main())
