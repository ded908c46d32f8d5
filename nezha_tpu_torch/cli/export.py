"""Export a training checkpoint as Hugging Face weights (counterpart of
``nezha-export``).

    python -m nezha_tpu_torch.cli.export --config gpt2_124m --ckpt-dir C \\
        --out gpt2_hf.npz
    python -m nezha_tpu_torch.cli.export --config bert_base_zero1 \\
        --ckpt-dir C --format torch --out pytorch_model.bin

The checkpoint is the newest of either package's train CLI in ``C``: a
dense npz that verifies, else a per-shard ``step_*.sharded`` (the
variables read whole); a ``--scan-layers`` trunk is sliced into the
unrolled layers and a graph-engine checkpoint read params-only, as JAX's
export reads them. ``--model-preset`` must be the one the
run trained. GPT-2 is written in ``GPT2LMHeadModel``'s keys, BERT in
``BertForMaskedLM``'s, every array fp32:

- ``--format npz`` (default): one ``.npz`` of HF-keyed arrays (the
  suffix is added when missing);
- ``--format torch``: a ``torch.save`` state dict, which
  ``GPT2LMHeadModel``/``BertForMaskedLM`` ``load_state_dict`` takes.

Prints one JSON line, ``{"keys", "format", "out"}``. The weights are
restored onto ``--device`` (default ``cuda``; ``cpu`` needs no card).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from nezha_tpu_torch.cli.common import (TINY_BERT_KW, gpt2_for_preset,
                                        restore_variables_any)
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import convert
from nezha_tpu_torch.models.bert import Bert, BertConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nezha_tpu_torch.cli.export",
                                description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True,
                   choices=["gpt2_124m", "bert_base_zero1"],
                   help="the trained architecture (GPT-2 -> "
                        "GPT2LMHeadModel keys, BERT -> BertForMaskedLM "
                        "keys)")
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint dir of either package's train CLI "
                        "(npz or per-shard)")
    p.add_argument("--model-preset", choices=["full", "tiny"],
                   default="full",
                   help="the preset the checkpoint was trained with")
    p.add_argument("--out", required=True, help="output file path")
    p.add_argument("--format", choices=["npz", "torch"], default="npz")
    p.add_argument("--device", default="cuda",
                   help="torch device to restore onto (default cuda)")
    return p


def run(args) -> dict:
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise SystemExit("no CUDA device: pass --device cpu to export on "
                         "the CPU")
    if args.config == "gpt2_124m":
        model = gpt2_for_preset(args.model_preset, device=args.device)
        restore_variables_any(args.ckpt_dir, model)
        state_dict = convert.gpt2_params_to_hf(model.state_dict(),
                                               model.cfg.num_layers)
    else:
        cfg = (BertConfig(**TINY_BERT_KW) if args.model_preset == "tiny"
               else BertConfig())
        model = Bert(cfg, device=args.device)
        restore_variables_any(args.ckpt_dir, model)
        state_dict = convert.bert_params_to_hf(
            model.state_dict(), cfg.num_layers, cfg.hidden_size)
    state_dict = {k: np.asarray(v, np.float32)
                  for k, v in state_dict.items()}
    out_path = args.out
    if args.format == "npz":
        # np.savez appends .npz itself: name the file it writes.
        if not out_path.endswith(".npz"):
            out_path += ".npz"
        np.savez(out_path, **state_dict)
    else:
        torch.save({k: torch.tensor(v) for k, v in state_dict.items()},
                   out_path)
    result = {"keys": len(state_dict), "format": args.format,
              "out": out_path}
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    try:
        run(build_parser().parse_args(argv))
    except NotPortedError as e:
        raise SystemExit(f"nezha_tpu_torch.cli.export: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
