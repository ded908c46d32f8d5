"""Put a training checkpoint onto a serve mesh (counterpart of
``nezha-reshard``).

    python -m nezha_tpu_torch.cli.reshard --ckpt-dir C --mesh 4 \\
        --model-preset tiny --out S --verify --device cpu

Loads the newest (or ``--step``) checkpoint in ``C`` of either package's
train CLI, a dense npz (each leaf CRC32-checked against its manifest,
read one leaf at a time) or a per-shard save (each shard's part read from
the stored shards that overlap it), and places GPT-2's parameters on a
1xM ``tp`` mesh as ``serve --mesh M`` runs it: qkv and fc split by whole
heads, the projections by rows, the rest replicated
(``serve/sharded/reshard.py``). With ``--out S`` the placed parameters
are written as a serve-topology per-shard checkpoint under the JAX
package's keys (either package reads it onto any mesh size), and
``--verify`` reads it back and proves the round trip bitwise.

The mesh is the visible cards on ``cuda`` (one a shard), the CPU on
``cpu``; ``--shard-device D`` puts every shard on D (a mesh of M shards
on one card). A corrupt or missing leaf is refused (exit 1, ``REFUSED``
on stderr). Prints one line, or the report as JSON with ``--json``:
``step``, ``mesh_devices``, ``params_bytes`` (each split leaf summed over
shards, each replicated one once), ``params_bytes_per_device`` (shard 0,
which holds every replicated leaf), ``seconds`` (the reshard's),
``peak_host_rss_bytes`` (the process's peak resident memory, libraries
and the device context included) beside ``host_rss_before_bytes`` (that
peak just before the reshard), and ``out`` and ``roundtrip_ok`` with
``--out``.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import torch

from nezha_tpu_torch.cli.common import gpt2_for_preset
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.parallel.mesh import make_mesh
from nezha_tpu_torch.serve.sharded import (ReshardError, reshard_checkpoint,
                                           save_serve_checkpoint,
                                           serve_tp_rules, verify_roundtrip)
from nezha_tpu_torch.serve.sharded.reshard import rule_for


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nezha_tpu_torch.cli.reshard",
                                description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--ckpt-dir", required=True,
                   help="training checkpoint dir (npz or per-shard)")
    p.add_argument("--mesh", type=int, required=True,
                   help="serve mesh size M (1xM tensor-parallel; "
                        "num_heads must divide by it)")
    p.add_argument("--model-preset", choices=["full", "tiny"],
                   default="full")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: newest)")
    p.add_argument("--out", default=None,
                   help="write the placed parameters as a serve-topology "
                        "per-shard checkpoint here")
    p.add_argument("--verify", action="store_true",
                   help="with --out: read it back and prove the round "
                        "trip bitwise")
    p.add_argument("--json", action="store_true",
                   help="print the report as JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--shard-device", default=None,
                   help="every shard on this device (M shards on one "
                        "card); default: one visible card a shard on "
                        "cuda, the CPU on cpu")
    return p


def _peak_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run(args) -> int:
    if args.mesh < 1:
        raise SystemExit(f"--mesh must be >= 1, got {args.mesh}")
    device_type = torch.device(args.device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to reshard on "
                         "the CPU")
    try:
        mesh = make_mesh({"tp": args.mesh}, [args.shard_device] * args.mesh
                         if args.shard_device else None, device_type)
    except ValueError as e:
        raise SystemExit(f"--mesh {args.mesh}: {e}")
    model = gpt2_for_preset(args.model_preset, device=mesh.devices[0])
    if model.cfg.num_heads % args.mesh:
        # The parameters would place, but no engine could serve them.
        raise SystemExit(
            f"--mesh {args.mesh}: num_heads={model.cfg.num_heads} not "
            f"divisible by the mesh -- no engine can serve this topology "
            f"(K/V pools shard on the head axis)")
    rules = serve_tp_rules(model.cfg, args.mesh)
    rss_before = _peak_rss_bytes()
    t0 = time.perf_counter()
    try:
        shards, step = reshard_checkpoint(args.ckpt_dir, model, mesh,
                                          step=args.step, rules=rules)
    except ReshardError as e:
        print(f"nezha_tpu_torch.cli.reshard: REFUSED: {e}", file=sys.stderr)
        return 1
    if mesh.devices[0].type == "cuda":
        torch.cuda.synchronize(mesh.devices[0])
    seconds = time.perf_counter() - t0

    def nbytes(t):
        return t.numel() * t.element_size()

    total = sum(sum(nbytes(s[n]) for s in shards)
                if rule_for(n, rules).axis is not None else nbytes(t)
                for n, t in shards[0].items())
    per_device = sum(nbytes(t) for t in shards[0].values())
    report = {"ckpt_dir": args.ckpt_dir, "step": step,
              "mesh_devices": args.mesh, "params_bytes": total,
              "params_bytes_per_device": per_device, "seconds": seconds,
              "host_rss_before_bytes": rss_before,
              "peak_host_rss_bytes": _peak_rss_bytes()}
    if args.out:
        report["out"] = save_serve_checkpoint(args.out, shards, step, rules)
        if args.verify:
            bad = verify_roundtrip(args.out, shards, step, rules)
            report["roundtrip_ok"] = not bad
            if bad:
                print(f"nezha_tpu_torch.cli.reshard: round-trip mismatch "
                      f"on {len(bad)} leaf/leaves: {bad[:5]}",
                      file=sys.stderr)
                return 1
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(f"resharded step {step} onto a 1x{args.mesh} mesh: "
              f"{total / 2**20:.2f} MiB total, "
              f"{per_device / 2**20:.2f} MiB/device"
              + (f" -> {report['out']}" if args.out else "")
              + (" round-trip OK" if report.get("roundtrip_ok") else ""))
    return 0


def main(argv=None) -> int:
    try:
        return run(build_parser().parse_args(argv))
    except NotPortedError as e:
        raise SystemExit(f"nezha_tpu_torch.cli.reshard: {e}")


if __name__ == "__main__":
    sys.exit(main())
