"""Real images -> NZR1 records for the train CLI (counterpart of
``nezha-pack-images``).

The dataset-prep half of the image input path: decode/resize once here,
then the C++ record loader (csrc/dataloader.cpp, ``data/native.py``)
streams the fixed-size records with train-time augmentation. Usage::

    python -m nezha_tpu_torch.cli.pack_images /data/imagenet \
        --out-dir /data/imagenet-nzr --size 256
    python -m nezha_tpu_torch.cli.train --config resnet50_imagenet \
        --data-dir /data/imagenet-nzr --crop 224 --eval

Accepts ``src/train/<class>/`` + ``src/val/<class>/`` (packed as-is) or
flat ``src/<class>/`` (seeded stratified val split, ``--val-fraction``).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nezha_tpu_torch.cli.pack_images",
        description="Pack an ImageFolder-style directory into NZR1 records "
                    "(train.nzr / val.nzr / classes.txt) for the train "
                    "CLI's --data-dir.")
    p.add_argument("src", help="dataset root: train/<class>/ + val/<class>/ "
                               "subdirs, or flat <class>/ subdirs")
    p.add_argument("--out-dir", required=True,
                   help="output directory for train.nzr/val.nzr/classes.txt")
    p.add_argument("--size", type=int, default=256,
                   help="stored record size: short-side resize + center crop "
                        "to SIZE x SIZE (default 256; train with --crop 224)")
    p.add_argument("--val-fraction", type=float, default=0.1,
                   help="val split per class when src has no train/+val/ "
                        "layout (default 0.1; 0 disables)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for the stratified val split")
    p.add_argument("--workers", type=int, default=8,
                   help="decode threads (default 8)")
    return p


def run(args) -> dict:
    from nezha_tpu_torch.data.images import pack_image_folder

    if args.size <= 0:
        raise SystemExit(f"--size must be positive, got {args.size}")
    if not 0 <= args.val_fraction < 1:
        raise SystemExit(f"--val-fraction must be in [0, 1), got "
                         f"{args.val_fraction}")
    try:
        summary = pack_image_folder(args.src, args.out_dir, size=args.size,
                                    val_fraction=args.val_fraction,
                                    seed=args.seed, workers=args.workers)
    except (ValueError, OSError) as e:
        raise SystemExit(f"nezha_tpu_torch.cli.pack_images: {e}")
    print(f"packed {summary['num_train']} train + {summary['num_val']} val "
          f"records ({summary['num_classes']} classes, "
          f"{summary['size']}x{summary['size']}) -> {args.out_dir}",
          file=sys.stderr)
    return summary


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
