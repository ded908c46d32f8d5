"""``nezha-telemetry`` of the port (counterpart of
``nezha_tpu/cli/telemetry.py``): render the report of a ``--run-dir``
capture.

    python -m nezha_tpu_torch.cli.train --config mlp_mnist --steps 100 \
        --run-dir /tmp/run
    python -m nezha_tpu_torch.cli.telemetry /tmp/run [--check]

Reads the artifacts the run sink wrote (``metrics.jsonl``,
``spans.jsonl``, ``summary.json``; a crashed run may have only the
streams) and prints step-rate percentiles, per-chip throughput, the
per-collective payload table and the slowest spans. ``--json`` prints
the raw summary instead, for scripting.

``--trace`` switches to the distributed-trace view: walk this run dir
and the per-replica subdirectories a ``--replicas`` serve run writes,
stitch every replica's span fragments by trace id, and render the
per-request timelines: the TTFT decomposition (router queue, prefill
wait, prefill compute, migration transfer, decode wait, first token)
and the slowest requests with their critical path.

``--slo`` renders the SLO and watchdog view: per-SLO compliance and
error-budget burn recomputed from the typed ``events.jsonl`` records
(``slo.eval``), and the watchdog's event log.

``--check`` also validates the artifacts against the frozen telemetry
schema (``nezha_tpu_torch.analysis.telemetry_schema.check_run_dir``):
each violation on stderr and exit 1, else ``schema: OK``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nezha-telemetry",
        description="Render the telemetry report for a train or serve "
                    "--run-dir capture.")
    p.add_argument("run_dir", help="run directory (holds metrics.jsonl / "
                                   "spans.jsonl / summary.json)")
    p.add_argument("--json", action="store_true",
                   help="print the raw summary.json (recomputed from the "
                        "streams when the file is missing) instead of the "
                        "rendered report; with --trace, the stitched "
                        "timelines as JSON")
    p.add_argument("--trace", action="store_true",
                   help="stitch the run's distributed trace fragments "
                        "(this dir + per-replica subdirs) into "
                        "per-request timelines and render the TTFT "
                        "decomposition + slowest-requests table instead "
                        "of the metrics report")
    p.add_argument("--slo", action="store_true",
                   help="render the SLO/watchdog view from the run's "
                        "events.jsonl (this dir + per-replica subdirs): "
                        "per-SLO compliance and error-budget burn rate, "
                        "plus the watchdog event log; with --json, the "
                        "raw rows")
    p.add_argument("--check", action="store_true",
                   help="also validate the artifacts against the frozen "
                        "telemetry schema (exit 1 on drift; the port's "
                        "copy of the schema checks)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.run_dir):
        print(f"no such run directory: {args.run_dir}", file=sys.stderr)
        return 2
    # Deferred so `--help` stays instant (repo convention for CLI entries).
    from nezha_tpu_torch.obs.report import (load_fleet_events, load_run,
                                            render_report,
                                            render_slo_report,
                                            render_trace_report, slo_rows,
                                            stitch_run_dir,
                                            summarize_streams)

    if args.slo:
        if args.json:
            events = load_fleet_events(args.run_dir)
            print(json.dumps({"slos": slo_rows(events),
                              "events": events},
                             indent=2, sort_keys=True))
        else:
            print(render_slo_report(args.run_dir))
    elif args.trace:
        # The fleet view: walk this dir plus the per-replica subdirs a
        # --replicas run writes, stitch fragments by trace id, render
        # per-request timelines.
        if args.json:
            print(json.dumps(stitch_run_dir(args.run_dir), indent=2,
                             sort_keys=True))
        else:
            print(render_trace_report(args.run_dir))
    elif args.json:
        run = load_run(args.run_dir)
        summary = run["summary"]
        if summary is None:
            summary = summarize_streams(run["metrics"], run["spans"])
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(render_report(args.run_dir))
    if args.check:
        from nezha_tpu_torch.analysis.telemetry_schema import check_run_dir
        errors = check_run_dir(args.run_dir)
        if errors:
            for e in errors:
                print(f"schema: {e}", file=sys.stderr)
            return 1
        print("schema: OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
