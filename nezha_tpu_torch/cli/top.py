"""``nezha-top`` of the port (counterpart of ``nezha_tpu/cli/top.py``):
a live terminal fleet view over a ``/metrics`` endpoint.

    python -m nezha_tpu_torch.cli.serve --random-init --replicas 2 \
        --http 8700 ... &
    python -m nezha_tpu_torch.cli.top http://127.0.0.1:8700

Polls the front end's (or a single replica's) Prometheus-text
``/metrics`` every ``--interval`` seconds, parses the window-labelled
samples (``obs.timeseries.parse_prometheus``), and renders a one-screen
fleet dashboard: live replicas, queue depth, admission and token rates,
TTFT/TPOT quantiles and error counters, over the rolling window picked
with ``--window`` (the 10s/60s/300s views ``Registry.windows`` serves).
``--iterations`` bounds the loop for scripts and tests; the default
polls until interrupted.

The fleet numbers are the front end's merged-sketch roll-up
(``obs.merge_window_payloads``), so quantiles are fleet-exact, not
averages of replica quantiles.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nezha-top",
        description="Live terminal fleet view over a nezha /metrics "
                    "endpoint (router front-end or single replica).")
    p.add_argument("url", help="base URL serving /metrics, e.g. "
                               "http://127.0.0.1:8700")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between polls (default 2)")
    p.add_argument("--iterations", type=int, default=0,
                   help="stop after N polls (default 0 = run until "
                        "interrupted)")
    p.add_argument("--window", default="60s",
                   choices=("10s", "60s", "300s"),
                   help="rolling window the rates/quantiles are read "
                        "from (default 60s)")
    p.add_argument("--no-clear", action="store_true",
                   help="append frames instead of redrawing in place "
                        "(for logs / non-TTY output)")
    return p


def fetch_metrics_text(url: str, timeout: float = 5.0) -> str:
    """GET ``<url>/metrics`` and return the exposition text."""
    from urllib.request import urlopen
    target = url.rstrip("/") + "/metrics"
    with urlopen(target, timeout=timeout) as resp:
        return resp.read().decode("utf-8", errors="replace")


# Display rows: (label, exposition name, kind). Kinds: "rate" reads the
# windowed counter rate, "last" the windowed gauge last-value, "hist"
# the windowed p50/p99 pair, "total" the cumulative unlabeled sample.
_ROWS = (
    ("replicas live", "nezha_router_replicas_live", "total"),
    ("queue depth", "nezha_serve_queue_depth_last", "last"),
    ("batch occupancy", "nezha_serve_batch_occupancy_last", "last"),
    ("admitted/s", "nezha_serve_admitted_total_rate", "rate"),
    ("tokens/s", "nezha_serve_tokens_total_rate", "rate"),
    ("rejected/s", "nezha_serve_rejected_total_rate", "rate"),
    ("errors/s", "nezha_serve_errors_total_rate", "rate"),
    ("ttft (s)", "nezha_serve_ttft_s", "hist"),
    ("tpot (s)", "nezha_serve_tpot_s", "hist"),
    ("route (s)", "nezha_router_route_s", "hist"),
    ("replica restarts", "nezha_router_replica_restarts_total", "total"),
    ("max burn rate", "nezha_slo_burn_rate_max", "total"),
    ("watchdog events", "nezha_watchdog_events_total", "total"),
)


def render_top(samples, window: str, url: str = "") -> str:
    """One dashboard frame from parsed ``/metrics`` samples — pure, so
    tests can feed it ``parse_prometheus(render_prometheus(...))``."""
    from nezha_tpu_torch.obs.timeseries import metric_value
    lines = [f"nezha-top  {url}  window={window}".rstrip()]
    lines.append(f"  {'metric':<20}{'value':>12}{'p99':>12}")
    shown = 0
    for label, name, kind in _ROWS:
        if kind == "hist":
            p50 = metric_value(samples, name, window=window,
                               quantile="p50")
            p99 = metric_value(samples, name, window=window,
                               quantile="p99")
            if p50 is None and p99 is None:
                continue
            lines.append(f"  {label:<20}{_num(p50):>12}{_num(p99):>12}")
        else:
            if kind == "total":
                v = metric_value(samples, name)
            else:
                v = metric_value(samples, name, window=window)
            if v is None:
                continue
            lines.append(f"  {label:<20}{_num(v):>12}")
        shown += 1
    if not shown:
        lines.append("  (no recognized samples — is this a nezha "
                     "/metrics endpoint with windows installed?)")
    return "\n".join(lines)


def _num(v) -> str:
    if v is None:
        return "-"
    if float(v) == int(v) and abs(v) < 1e9:
        return str(int(v))
    return f"{v:.4f}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Deferred so `--help` stays instant (repo convention for CLI
    # entries).
    from nezha_tpu_torch.obs.timeseries import parse_prometheus

    polls = 0
    errors = 0
    while True:
        frame = None
        try:
            text = fetch_metrics_text(args.url)
            frame = render_top(parse_prometheus(text), args.window,
                               url=args.url)
            errors = 0
        except KeyboardInterrupt:
            return 0
        except Exception as e:  # connection refused, timeout, bad body
            errors += 1
            print(f"nezha-top: fetch failed ({e})", file=sys.stderr)
            if errors >= 5:
                print("nezha-top: 5 consecutive failures, giving up",
                      file=sys.stderr)
                return 1
        if frame is not None:
            if not args.no_clear and sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            print(frame, flush=True)
        polls += 1
        if args.iterations and polls >= args.iterations:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
