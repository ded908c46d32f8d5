"""Run-report rendering for ``nezha-telemetry`` (counterpart of
``nezha_tpu/obs/report.py``: the same text from the same run dir).

Reads the three run-dir artifacts the sink writes (metrics.jsonl,
spans.jsonl, summary.json — any subset may be missing for a crashed run)
and renders the operator's first-read view: step-rate percentiles,
per-chip throughput, the per-collective payload/bandwidth table, compile-
cache behavior, and the slowest spans. Pure stdlib + the JSONL reader, so
the report works on any machine the run dir is copied to.

This module also owns DISTRIBUTED-TRACE stitching (``--trace``): walk a
run dir plus the per-replica subdirectories a multi-replica serve run
writes, group every replica's span fragments by their ``trace_id``, and
rebuild each request's cross-fleet timeline — the TTFT decomposition
over :data:`TRACE_SEGMENTS` whose pieces tile the measured TTFT exactly,
plus partial-trace accounting for requests whose fragments a killed
replica took with it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from nezha_tpu_torch.obs.metrics import read_metrics
from nezha_tpu_torch.obs.registry import (UNFOLDED_METRIC_KEYS, percentile_of,
                                    values_summary)
from nezha_tpu_torch.obs.sink import (EVENTS_FILE, METRICS_FILE, SPANS_FILE,
                                SUMMARY_FILE)


def load_run(run_dir: str) -> dict:
    """-> {"metrics": [...], "spans": [...], "summary": dict|None}."""
    out: Dict[str, Any] = {"metrics": [], "spans": [], "summary": None}
    mpath = os.path.join(run_dir, METRICS_FILE)
    if os.path.isfile(mpath):
        out["metrics"] = read_metrics(mpath)
    spath = os.path.join(run_dir, SPANS_FILE)
    if os.path.isfile(spath):
        out["spans"] = read_metrics(spath)  # same JSONL shape
    jpath = os.path.join(run_dir, SUMMARY_FILE)
    if os.path.isfile(jpath):
        with open(jpath) as f:
            out["summary"] = json.load(f)
    return out


def summarize_streams(metrics: List[dict], spans: List[dict]) -> dict:
    """Best-effort summary for a run that died before ``end_run()`` wrote
    summary.json: numeric metric histograms and span aggregates recomputed
    from the JSONL streams. Counter-backed sections (collectives, compile
    cache) lived only in the process registry and cannot be recovered, so
    they are absent; ``recomputed`` marks the dict as this partial form."""
    series: Dict[str, List[float]] = {}
    for m in metrics:
        for k, v in m.items():
            if (k not in UNFOLDED_METRIC_KEYS
                    and isinstance(v, (int, float))
                    and not isinstance(v, bool)):
                series.setdefault(f"metric.{k}", []).append(float(v))

    slowest = sorted(spans, key=lambda sp: -sp.get("dur_s", 0.0))[:10]
    return {"schema_version": 1, "recomputed": True,
            "histograms": {k: values_summary(v)
                           for k, v in series.items()},
            "num_spans": len(spans), "slowest_spans": slowest}


def _percentiles(values: List[float]) -> Optional[dict]:
    if not values:
        return None
    s = sorted(values)
    return {"n": len(s), "mean": sum(s) / len(s), "min": s[0],
            "p10": percentile_of(s, 10), "p50": percentile_of(s, 50),
            "p90": percentile_of(s, 90), "max": s[-1]}


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def render_serving_section(summary: Optional[dict]) -> List[str]:
    """The serving block (present only for serve/benchmark runs —
    detected by the pre-registered ``serve.*`` instruments): request
    counters, TTFT/TPOT percentiles, throughput, batch occupancy."""
    if not summary:
        return []
    counters = summary.get("counters", {})
    if "serve.admitted_total" not in counters:
        return []
    gauges = summary.get("gauges", {})
    hists = summary.get("histograms", {})
    lines = ["serving:"]
    lines.append(
        "  requests: "
        f"{counters.get('serve.admitted_total', 0)} admitted  "
        f"{counters.get('serve.rejected_total', 0)} rejected  "
        f"{counters.get('serve.expired_total', 0)} expired  "
        f"{counters.get('serve.retired_total', 0)} retired")
    if "serve.errors_total" in counters:
        # Resilience accounting (absent only in earlier captures):
        # errored requests, bounded step retries, and how many faults
        # the chaos plan injected (0 on a clean run).
        lines.append(
            "  errors: "
            f"{counters.get('serve.errors_total', 0):.0f} errored  "
            f"{counters.get('serve.step_retries_total', 0):.0f} "
            f"step retries  "
            f"{counters.get('faults.injected_total', 0):.0f} "
            f"faults injected")
    for key, label in (("serve.ttft_s", "ttft"), ("serve.tpot_s", "tpot")):
        h = hists.get(key)
        if h and h.get("count"):
            lines.append(
                f"  {label}: p50 {h['p50'] * 1e3:.1f} ms  "
                f"p90 {h['p90'] * 1e3:.1f} ms  "
                f"p99 {h['p99'] * 1e3:.1f} ms  (n={h['count']})")
    # Per-priority-class TTFT split: rendered only for classes
    # that saw traffic, and only when MORE than one class did — a
    # single-class run (the default wire) collapses to the line above.
    split = [(p, hists.get(f"serve.ttft_s.{p}"))
             for p in ("interactive", "batch", "background")]
    split = [(p, h) for p, h in split if h and h.get("count")]
    if len(split) > 1:
        for p, h in split:
            lines.append(
                f"    ttft[{p}]: p50 {h['p50'] * 1e3:.1f} ms  "
                f"p90 {h['p90'] * 1e3:.1f} ms  "
                f"p99 {h['p99'] * 1e3:.1f} ms  (n={h['count']})")
    if counters.get("serve.preemptions_total") or counters.get(
            "serve.tenant_over_limit_total"):
        # Multi-tenant scheduling view: suspends/resumes and
        # typed per-tenant sheds — all 0 (line absent) on FIFO runs.
        lines.append(
            "  preemption: "
            f"{counters.get('serve.preemptions_total', 0):.0f} "
            f"preempted  "
            f"{counters.get('serve.resumes_total', 0):.0f} resumed  "
            f"{counters.get('serve.tenant_over_limit_total', 0):.0f} "
            f"tenant-capped")
    hg = hists.get("serve.host_gap_s")
    if hg and hg.get("count"):
        # The decode-horizon view: host time between consecutive step
        # dispatches (the overhead a horizon > 1 amortizes over H
        # tokens) and the tokens-per-dispatch ceiling the blocks ran at
        # (absent in pre-horizon captures).
        dh = hists.get("serve.decode.horizon") or {}
        hz = (f"  horizon p50 {dh['p50']:.0f}"
              if dh.get("count") else "")
        lines.append(
            f"  host gap: p50 {hg['p50'] * 1e3:.2f} ms  "
            f"p90 {hg['p90'] * 1e3:.2f} ms  "
            f"p99 {hg['p99'] * 1e3:.2f} ms  (n={hg['count']}){hz}")
    if "serve.kv.prefix_hits_total" in counters:
        # Paged-KV view (absent only in pre-paged captures): the KV
        # storage dtype (from the quant_bits gauge; absent in
        # pre-quantization captures), blocks + bytes resident at run
        # end, prefix-cache hits (requests that took block references
        # instead of re-prefilling), copy-on-write block copies, and —
        # on int8 runs — the sampled per-block dequant error p99.
        bits = gauges.get("serve.kv.quant_bits")
        dtype = {8: "int8", 16: "bf16", 32: "f32"}.get(
            int(bits) if bits else 0)
        parts = ["  kv: "]
        if dtype:
            parts.append(f"dtype {dtype}  ")
        parts.append(
            f"{gauges.get('serve.kv.blocks_used', 0):.0f} blocks "
            f"resident")
        if "serve.kv.bytes_resident" in gauges:
            parts.append(
                f" ({gauges['serve.kv.bytes_resident'] / 1024:.1f} "
                f"KiB)")
        parts.append(
            f"  "
            f"{counters.get('serve.kv.prefix_hits_total', 0):.0f} "
            f"prefix hits  "
            f"{counters.get('serve.kv.cow_copies_total', 0):.0f} "
            f"cow copies")
        qe = hists.get("serve.kv.quant_error")
        if qe and qe.get("count"):
            parts.append(f"  quant err p99 {qe['p99']:.2e}")
        lines.append("".join(parts))
        demoted = counters.get("serve.kv.demotions_total", 0)
        promoted = counters.get("serve.kv.promotions_total", 0)
        host_used = gauges.get("serve.kv.host_blocks_used", 0)
        if demoted or promoted or host_used:
            # Host spill tier (absent when kv_host_blocks is 0 or the
            # run never churned): blocks currently parked in host RAM,
            # and the demote/promote traffic — a healthy churn load
            # shows promotions tracking demotions (returning users hit
            # the tier) rather than demotions alone (a write-only
            # spill buys nothing).
            lines.append(
                f"  kv host tier: {host_used:.0f} blocks resident "
                f"({gauges.get('serve.kv.host_bytes_resident', 0) / 1024:.1f} "
                f"KiB)  {demoted:.0f} demoted  {promoted:.0f} promoted")
        fleet = counters.get("serve.kv.fleet_hits_total", 0)
        pulled = counters.get("serve.kv.pull_bytes", 0)
        if fleet or pulled:
            # Fleet-wide KV reuse (absent on single-replica /
            # affinity-off runs which report 0s): the three-tier hit
            # split — a healthy affinity fleet shows device hits
            # dominating (the scorer landed revisits on their owner)
            # with peer hits covering owner churn/saturation.
            lines.append(
                f"  fleet kv: {fleet:.0f} hits (device "
                f"{counters.get('serve.kv.fleet_hits_device_total', 0):.0f}"
                f" / host "
                f"{counters.get('serve.kv.fleet_hits_host_total', 0):.0f}"
                f" / peer "
                f"{counters.get('serve.kv.fleet_hits_peer_total', 0):.0f})"
                f"  {pulled / 1024:.1f} KiB pulled")
    mesh = gauges.get("serve.mesh.devices", 0)
    if mesh and mesh >= 2:
        # Tensor-sharded serving (absent on single-device runs): mesh
        # size, the per-shard share of resident KV, and the trace-shape
        # collective-payload estimate the mesh moved.
        parts = [f"  mesh: {mesh:.0f} devices (head-sharded KV)"]
        if "serve.kv.bytes_resident" in gauges:
            per_shard = gauges["serve.kv.bytes_resident"] / mesh / 1024
            parts.append(f"  {per_shard:.1f} KiB/shard resident")
        cb = counters.get("serve.mesh.collective_bytes", 0)
        if cb:
            parts.append(f"  collectives ~{cb / 2**20:.2f} MiB "
                         f"(trace-shape est.)")
        lines.append("".join(parts))
    al = hists.get("serve.spec.accepted_len")
    if al and al.get("count"):
        # Speculative decoding (absent when the knob is off — the
        # histogram only fills on speculative runs): accepted-prefix
        # length percentiles per verify window, the realized accept
        # rate (accepted / proposed draft tokens), and the headline
        # tokens-per-verify (accepted-len p50 + 1 for the t0 column).
        drafted = counters.get("serve.spec.draft_tokens_total", 0)
        accepted = counters.get("serve.spec.accepted_total", 0)
        rate = accepted / drafted if drafted else 0.0
        lines.append(
            f"  speculation: accept-rate p50 {al['p50']:.0f}"
            f"/{drafted / al['count']:.0f} drafts  "
            f"({rate:.0%} of {drafted:.0f} proposed)  "
            f"tokens/verify {al['mean'] + 1:.2f}")
    ph = hists.get("serve.prefill.bucket_len")
    if ph and ph.get("count"):
        # Bucket occupancy: how wide the static prefill programs
        # actually ran (p50/max widths + chunk count — a max stuck at
        # the top bucket under short-prompt traffic means the bucket set
        # is too coarse).
        chunks = counters.get("serve.prefill.chunks_total", ph["count"])
        # Active prefill impl: the engine pins the gauge to 1
        # when chunks dispatch through the Pallas flash-prefill kernel;
        # an int8 pool additionally counts the per-layer block writes
        # the kernel epilogue fused in place of the gather/requant
        # round-trip.
        impl = ("kernel"
                if gauges.get("serve.prefill.kernel_active") else "xla")
        # Sequence-sharded prefill: the seq_shards gauge is M
        # when chunks shard over the mesh's sequence axis, 0 in
        # replicated mode — the report labels the line's parallelism
        # mode from it alone (ring hops additionally show the
        # ppermute-variant traffic).
        shards = gauges.get("serve.prefill.seq_shards", 0)
        mode = f"seq x{shards:.0f}" if shards else "replicated"
        fused = counters.get("serve.prefill.fused_writes_total", 0)
        fused_part = f"  fused writes {fused:.0f}" if fused else ""
        hops = counters.get("serve.prefill.ring_hops_total", 0)
        hops_part = f"  ring hops {hops:.0f}" if hops else ""
        lines.append(
            f"  prefill[{impl}, {mode}]: {chunks:.0f} chunk(s)  "
            f"bucket len p50 {ph['p50']:.0f}  p90 {ph['p90']:.0f}  "
            f"max {ph['max']:.0f}{fused_part}{hops_part}")
    tokens = counters.get("serve.tokens_total", 0)
    wall = (summary.get("run") or {}).get("wall_seconds")
    if tokens and wall:
        lines.append(f"  throughput: {tokens} tokens in {wall:.1f}s "
                     f"({tokens / wall:.1f} tok/s)")
    elif tokens:
        lines.append(f"  throughput: {tokens} tokens")
    occ = gauges.get("serve.batch_occupancy")
    occ_h = hists.get("metric.batch_occupancy")
    if occ_h and occ_h.get("count"):
        lines.append(f"  batch occupancy: mean {occ_h['mean']:.2f}  "
                     f"p50 {occ_h['p50']:.2f}  max {occ_h['max']:.2f}")
    elif occ is not None:
        lines.append(f"  batch occupancy: {occ:.2f} (final)  "
                     f"queue depth: {gauges.get('serve.queue_depth', 0):.0f}")
    return lines


def render_replicas_section(summary: Optional[dict]) -> List[str]:
    """The multi-replica block (present only for router runs —
    detected by the pre-registered ``router.*`` instruments): live
    replica count, restart/failover/retry ledger, and route-latency
    percentiles."""
    if not summary:
        return []
    counters = summary.get("counters", {})
    if "router.retries_total" not in counters:
        return []
    gauges = summary.get("gauges", {})
    hists = summary.get("histograms", {})
    lines = ["replicas:"]
    lines.append(
        f"  live: {gauges.get('router.replicas_live', 0):.0f} (final)  "
        f"{counters.get('router.replica_restarts_total', 0):.0f} "
        f"restarts  "
        f"{counters.get('router.failovers_total', 0):.0f} failovers  "
        f"{counters.get('router.retries_total', 0):.0f} retries")
    h = hists.get("router.route_s")
    if h and h.get("count"):
        lines.append(
            f"  route: p50 {h['p50'] * 1e3:.1f} ms  "
            f"p90 {h['p90'] * 1e3:.1f} ms  "
            f"p99 {h['p99'] * 1e3:.1f} ms  (n={h['count']})")
    # Fleet-wide KV reuse: affinity overrides of the least-
    # loaded pick (present only when the scorer actually won any).
    aff = counters.get("router.affinity_wins_total", 0)
    if aff:
        lines.append(f"  affinity: {aff:.0f} wins over least-loaded")
    # Disaggregated tiers: migration volume and the per-tier queueing
    # split (present only when the run actually migrated / split).
    mig = counters.get("serve.kv.migrations_total", 0)
    if mig:
        lines.append(
            f"  migration: {mig:.0f} pulls  "
            f"{counters.get('serve.kv.migration_bytes', 0) / 2**20:.2f} "
            f"MiB moved  "
            f"{counters.get('router.migrate_fallbacks_total', 0):.0f} "
            f"fallbacks")
    pw, dw = (hists.get("router.prefill_wait_s"),
              hists.get("router.decode_wait_s"))
    if pw and pw.get("count") and dw and dw.get("count"):
        lines.append(
            f"  queue split: prefill wait p50 {pw['p50'] * 1e3:.1f} ms  "
            f"decode wait p50 {dw['p50'] * 1e3:.1f} ms")
    return lines


# ------------------------------------------------- distributed traces
# The stitched-timeline segments of the TTFT decomposition, in wall
# order. Each is the interval between two consecutive milestones of a
# request's cross-replica lifecycle, so for a complete trace they TILE
# [router arrival, first token] exactly — the segment sum IS the
# end-to-end TTFT (tests pin this).
TRACE_SEGMENTS = ("router_queue", "prefill_wait", "prefill_compute",
                  "migration_transfer", "decode_wait", "first_token")


def load_fleet_spans(run_dir: str) -> List[dict]:
    """Every span record reachable from ``run_dir`` — its own
    spans.jsonl plus any immediate subdirectory's (the per-replica
    ``replica<N>/`` layout ``nezha-serve --replicas --run-dir`` writes,
    and the per-horizon ``h<N>/`` layout of bench sweeps) — each tagged
    with its source directory under ``_src`` so stitched timelines can
    say which replica a fragment came from."""
    sources = [(".", run_dir)]
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        names = []
    for name in names:
        sub = os.path.join(run_dir, name)
        if os.path.isdir(sub):
            sources.append((name, sub))
    out: List[dict] = []
    for src, d in sources:
        path = os.path.join(d, SPANS_FILE)
        if not os.path.isfile(path):
            continue
        for rec in read_metrics(path):
            if isinstance(rec, dict):
                rec = dict(rec)
                rec["_src"] = src
                out.append(rec)
    return out


def stitch_traces(spans: List[dict]) -> Dict[str, List[dict]]:
    """Group span fragments by ``trace_id`` (records without one are
    not part of any request timeline), each trace's fragments sorted by
    start time — all fragments carry epoch wall clocks, so one host's
    replicas order correctly across processes."""
    traces: Dict[str, List[dict]] = {}
    for rec in spans:
        tid = rec.get("trace_id")
        if isinstance(tid, str) and tid:
            traces.setdefault(tid, []).append(rec)
    for frags in traces.values():
        frags.sort(key=lambda r: (r.get("t0", 0.0), r.get("t1", 0.0)))
    return traces


def trace_timeline(trace_id: str, frags: List[dict]) -> dict:
    """One stitched per-request timeline: the TTFT decomposition
    (:data:`TRACE_SEGMENTS`) computed from the trace's milestone
    boundaries. Milestones are clamped monotone, so for a ``complete``
    timeline ``sum(segments) == ttft_s`` EXACTLY — no gap hides between
    segments. A trace missing milestones (killed replica mid-migration,
    request still in flight at capture end, expired in queue) comes
    back ``complete=False`` with the absent pieces named in
    ``missing`` — partial timelines render, they just don't decompose.
    """
    by_name: Dict[str, List[dict]] = {}
    for f in frags:
        by_name.setdefault(str(f.get("name")), []).append(f)

    def attrs_of(f) -> dict:
        a = f.get("attrs")
        return a if isinstance(a, dict) else {}

    root = (by_name.get("router.request") or [None])[0]
    qws = by_name.get("serve.queue_wait", [])
    prefills = by_name.get("serve.prefill", [])
    # Only SUCCESSFUL installs count as a migration: a failed pull
    # (source lost mid-transfer, kv blocks exhausted) records its
    # serve.kv_install fragment with an ``error`` attr and the router
    # degrades — retry on another replica or local decode on the
    # source. Counting it would report migrated=true with a positive
    # transfer segment for a migration that never delivered, masking
    # exactly the degradation this report exists to surface.
    pulls = [p for p in by_name.get("serve.kv_install", [])
             if "error" not in attrs_of(p)]
    # The LAST decode fragment wins: a resumed (local-decode fallback)
    # request parks one aborted residency behind the real one.
    decodes = by_name.get("serve.decode", [])
    decode = decodes[-1] if decodes else None

    request_id = None
    for f in frags:
        rid = attrs_of(f).get("request_id")
        if rid:
            request_id = rid
            break

    qw0 = qws[0] if qws else None
    pull_t0 = pulls[0].get("t0") if pulls else None
    pre = [p for p in prefills
           if pull_t0 is None or p.get("t0", 0.0) <= pull_t0]
    first_token = attrs_of(decode).get("first_token") if decode else None

    milestones = [
        ("router.request", root.get("t0") if root else
         (qw0.get("t0") if qw0 else None)),
        ("serve.queue_wait", qw0.get("t0") if qw0 else None),
        ("admitted", qw0.get("t1") if qw0 else None),
        ("prefill done", max((p.get("t1", 0.0) for p in pre),
                             default=None) if pre else None),
        ("migration done", max((p.get("t1", 0.0) for p in pulls),
                               default=None) if pulls
         else (max((p.get("t1", 0.0) for p in pre), default=None)
               if pre else None)),
        ("serve.decode", decode.get("t0") if decode else None),
        ("first token", float(first_token)
         if first_token is not None else None),
    ]
    missing = [name for name, t in milestones if t is None]
    out = {
        "trace_id": trace_id,
        "request_id": request_id,
        "fragments": len(frags),
        "span_names": sorted(by_name),
        "replicas": sorted({str(f.get("_src", ".")) for f in frags}),
        "complete": not missing,
        "missing": missing,
        "migrated": bool(pulls),
        "t0": milestones[0][1],
    }
    if decode is not None:
        a = attrs_of(decode)
        out["finish_reason"] = a.get("finish_reason")
        out["tokens"] = a.get("tokens")
    if missing:
        return out
    # Clamp monotone, then difference: consecutive intervals tile
    # [arrival, first token], so the segment sum equals ttft_s exactly.
    times = []
    run = None
    for _, t in milestones:
        run = t if run is None else max(run, t)
        times.append(run)
    out["segments"] = {seg: times[i + 1] - times[i]
                       for i, seg in enumerate(TRACE_SEGMENTS)}
    out["ttft_s"] = times[-1] - times[0]
    return out


def stitch_run_dir(run_dir: str) -> List[dict]:
    """-> every stitched timeline of a (possibly multi-replica) run
    dir, slowest-complete first, partial timelines at the tail."""
    traces = stitch_traces(load_fleet_spans(run_dir))
    timelines = [trace_timeline(tid, frags)
                 for tid, frags in traces.items()]
    timelines.sort(key=lambda t: (not t["complete"],
                                  -(t.get("ttft_s") or 0.0)))
    return timelines


def trace_summary(run_dir: str) -> Optional[dict]:
    """The per-segment percentile record of a run's stitched traces —
    the ``trace`` block a serving benchmark record embeds, so each piece
    of the TTFT decomposition can be gated, not just the total. None
    when the run produced no traces at all."""
    timelines = stitch_run_dir(run_dir)
    if not timelines:
        return None
    complete = [t for t in timelines if t["complete"]]
    out = {"count": len(timelines), "complete": len(complete),
           "partial": len(timelines) - len(complete)}

    def pcts(vals: List[float]) -> dict:
        s = sorted(vals)
        return {"n": len(s), "p50": percentile_of(s, 50),
                "p90": percentile_of(s, 90),
                "p99": percentile_of(s, 99)}

    if complete:
        out["ttft_s"] = pcts([t["ttft_s"] for t in complete])
        out["segments"] = {
            seg: pcts([t["segments"][seg] for t in complete])
            for seg in TRACE_SEGMENTS}
    return out


def _critical_path(timeline: dict) -> str:
    segs = timeline.get("segments") or {}
    if not segs:
        return "-"
    seg, dur = max(segs.items(), key=lambda kv: kv[1])
    total = sum(segs.values())
    share = dur / total if total else 0.0
    return f"{seg} {share:.0%}"


def render_trace_report(run_dir: str, top: int = 10) -> str:
    """The ``nezha-telemetry RUN_DIR --trace`` view: the fleet's
    stitched per-request timelines — TTFT decomposition percentiles per
    segment, the slowest requests with critical-path attribution, and
    the partial traces (a killed replica mid-migration leaves exactly
    this shape) listed rather than silently dropped."""
    timelines = stitch_run_dir(run_dir)
    lines = [f"trace report: {os.path.abspath(run_dir)}"]
    if not timelines:
        lines.append("(no trace fragments found — was the run captured "
                     "with --run-dir and tracing not sampled out?)")
        return "\n".join(lines)
    complete = [t for t in timelines if t["complete"]]
    partial = [t for t in timelines if not t["complete"]]
    lines.append(f"traces: {len(timelines)} stitched "
                 f"({len(complete)} complete, {len(partial)} partial)")
    if complete:
        lines.append("")
        lines.append(f"ttft decomposition over {len(complete)} "
                     f"complete request(s):")
        lines.append(f"  {'segment':<20}{'p50 ms':>10}{'p90 ms':>10}"
                     f"{'p99 ms':>10}")
        seg_series = {seg: sorted(t["segments"][seg] for t in complete)
                      for seg in TRACE_SEGMENTS}
        for seg in TRACE_SEGMENTS:
            s = seg_series[seg]
            lines.append(
                f"  {seg:<20}"
                f"{percentile_of(s, 50) * 1e3:>10.1f}"
                f"{percentile_of(s, 90) * 1e3:>10.1f}"
                f"{percentile_of(s, 99) * 1e3:>10.1f}")
        totals = sorted(t["ttft_s"] for t in complete)
        lines.append(
            f"  {'total (ttft)':<20}"
            f"{percentile_of(totals, 50) * 1e3:>10.1f}"
            f"{percentile_of(totals, 90) * 1e3:>10.1f}"
            f"{percentile_of(totals, 99) * 1e3:>10.1f}")
        lines.append("")
        lines.append(f"slowest requests (top {min(top, len(complete))}):")
        lines.append(f"  {'ttft ms':>10}  {'request':<20}"
                     f"{'replicas':<20}  critical path")
        for t in complete[:top]:
            lines.append(
                f"  {t['ttft_s'] * 1e3:>10.1f}  "
                f"{str(t.get('request_id') or t['trace_id']):<20}"
                f"{','.join(t['replicas']):<20}  "
                f"{_critical_path(t)}")
    if partial:
        lines.append("")
        lines.append(f"partial traces ({len(partial)} — request still "
                     f"in flight at capture end, expired unadmitted, "
                     f"or a replica died holding its fragments):")
        for t in partial[:top]:
            lines.append(
                f"  {str(t.get('request_id') or t['trace_id']):<22}"
                f"{t['fragments']} fragment(s) from "
                f"{','.join(t['replicas'])}; missing "
                f"{', '.join(t['missing'])}")
    return "\n".join(lines)


def render_report(run_dir: str) -> str:
    """The full plain-text report for a run directory."""
    run = load_run(run_dir)
    metrics, spans, summary = run["metrics"], run["spans"], run["summary"]
    lines: List[str] = [f"telemetry report: {os.path.abspath(run_dir)}"]

    if summary and "run" in summary:
        meta = summary["run"]
        parts = [f"{k}={meta[k]}" for k in sorted(meta)
                 if k not in ("run_dir", "started_at")]
        if parts:
            lines.append("run: " + " ".join(parts))
    if not (metrics or spans or summary):
        lines.append("(no telemetry artifacts found — was the run started "
                     "with --run-dir?)")
        return "\n".join(lines)

    # ------------------------------------------------------- step rates
    rates = [m["steps_per_sec"] for m in metrics
             if isinstance(m.get("steps_per_sec"), (int, float))]
    p = _percentiles(rates)
    lines.append("")
    if p is not None:
        lines.append(f"step rate (steps/sec over {p['n']} windows): "
                     f"mean {p['mean']:.3f}  p10 {p['p10']:.3f}  "
                     f"p50 {p['p50']:.3f}  p90 {p['p90']:.3f}")
    else:
        lines.append("step rate: no steps_per_sec records")
    for key in ("examples_per_sec_per_chip", "tokens_per_sec_per_chip"):
        vals = [m[key] for m in metrics
                if isinstance(m.get(key), (int, float))]
        pk = _percentiles(vals)
        if pk is not None:
            lines.append(f"{key}: mean {pk['mean']:.1f}  "
                         f"p50 {pk['p50']:.1f}  p90 {pk['p90']:.1f}")
    losses = [m["loss"] for m in metrics
              if isinstance(m.get("loss"), (int, float))]
    if losses:
        lines.append(f"loss: first {losses[0]:.4f} -> last {losses[-1]:.4f} "
                     f"({len(losses)} records)")

    # ------------------------------------------------------ collectives
    coll = (summary or {}).get("collectives", {})
    lines.append("")
    if coll:
        lines.append("collectives:")
        lines.append(f"  {'op':<22}{'calls':>8}{'payload':>12}"
                     f"{'bus GB/s (p50)':>16}")
        for op in sorted(coll):
            row = coll[op]
            bw = row.get("bus_gbps")
            bw_s = f"{bw['p50']:.2f}" if isinstance(bw, dict) else "-"
            lines.append(f"  {op:<22}{row.get('calls', 0):>8}"
                         f"{_fmt_bytes(row.get('payload_bytes', 0)):>12}"
                         f"{bw_s:>16}")
    else:
        lines.append("collectives: none recorded")

    # ---------------------------------------------------------- serving
    serving = render_serving_section(summary)
    if serving:
        lines.append("")
        lines.extend(serving)

    # --------------------------------------------------------- replicas
    replicas = render_replicas_section(summary)
    if replicas:
        lines.append("")
        lines.extend(replicas)

    # ---------------------------------------------------- compile cache
    cc = (summary or {}).get("compile_cache")
    if cc is not None:
        hits, misses = cc.get("hits", 0), cc.get("misses", 0)
        total = hits + misses
        ratio = f"{hits / total:.1%}" if total else "n/a"
        secs = cc.get("compile_seconds", {})
        lines.append(f"compile cache: {hits} hits / {misses} misses "
                     f"(hit ratio {ratio}; "
                     f"{secs.get('sum', 0.0):.2f}s compiling)")

    # ------------------------------------------------------------ spans
    slowest = (summary or {}).get("slowest_spans")
    if slowest is None:
        slowest = sorted(spans, key=lambda s: -s.get("dur_s", 0.0))[:10]
    lines.append("")
    if slowest:
        lines.append("slowest spans:")
        for s in slowest[:10]:
            attrs = s.get("attrs") or {}
            a = (" " + " ".join(f"{k}={v}" for k, v in sorted(
                attrs.items()))) if attrs else ""
            lines.append(f"  {s.get('dur_s', 0.0):>9.4f}s  "
                         f"{s.get('name', '?')}{a}")
    else:
        lines.append("spans: none recorded")
    return "\n".join(lines)


# ------------------------------------------------------------------ SLO view


def load_fleet_events(run_dir: str) -> List[dict]:
    """Every typed event record reachable from ``run_dir`` — its own
    events.jsonl plus any immediate subdirectory's (the per-replica
    ``replica<N>/`` layout), each tagged with its source directory under
    ``_src``, sorted by timestamp so the fleet event log interleaves
    correctly across replicas."""
    sources = [(".", run_dir)]
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        names = []
    for name in names:
        sub = os.path.join(run_dir, name)
        if os.path.isdir(sub):
            sources.append((name, sub))
    out: List[dict] = []
    for src, d in sources:
        path = os.path.join(d, EVENTS_FILE)
        if not os.path.isfile(path):
            continue
        for rec in read_metrics(path):  # same JSONL shape
            if isinstance(rec, dict):
                rec = dict(rec)
                rec["_src"] = src
                out.append(rec)
    out.sort(key=lambda r: r.get("ts", 0.0))
    return out


def slo_rows(events: List[dict]) -> List[dict]:
    """Per-SLO compliance/burn rows recomputed from ``slo.eval`` event
    records (the offline twin of the live tracker — see
    :func:`nezha_tpu_torch.obs.slo.summarize_slo_events`)."""
    from nezha_tpu_torch.obs.slo import summarize_slo_events
    rows = summarize_slo_events(events)
    return [rows[name] for name in sorted(rows)]


def render_slo_report(run_dir: str) -> str:
    """Plain-text SLO/watchdog view for a run directory: the per-SLO
    compliance + error-budget burn table recomputed from the run's
    ``slo.eval`` events, then the watchdog alert log."""
    events = load_fleet_events(run_dir)
    lines: List[str] = [f"SLO report: {os.path.abspath(run_dir)}"]
    if not events:
        lines.append("(no events.jsonl captured — was the run started with "
                     "--run-dir and --slo/--watchdog-interval?)")
        return "\n".join(lines)

    rows = slo_rows(events)
    lines.append("")
    if rows:
        lines.append("SLOs:")
        lines.append(f"  {'slo':<40}{'evals':>7}{'good':>7}{'bad':>6}"
                     f"{'compliance':>12}{'burn':>8}")
        for row in rows:
            comp = row.get("compliance")
            burn = row.get("burn_rate")
            comp_s = f"{comp:.1%}" if isinstance(comp, float) else "-"
            burn_s = f"{burn:.2f}" if isinstance(burn, float) else "-"
            lines.append(f"  {row['slo']:<40}"
                         f"{row.get('evaluations', 0):>7}"
                         f"{row.get('good', 0):>7}{row.get('bad', 0):>6}"
                         f"{comp_s:>12}{burn_s:>8}")
    else:
        lines.append("SLOs: no slo.eval records (run without --slo?)")

    alerts = [e for e in events
              if isinstance(e.get("kind"), str)
              and e["kind"].startswith("watchdog.")]
    lines.append("")
    if alerts:
        lines.append(f"watchdog events ({len(alerts)}):")
        for e in alerts[-20:]:
            detail = e.get("detail") or {}
            d = (" " + " ".join(f"{k}={v}" for k, v in sorted(
                detail.items()))) if detail else ""
            lines.append(f"  [{e.get('severity', '?'):<8}] "
                         f"{e.get('_src', '.')}: {e.get('kind', '?')}{d}")
    else:
        lines.append("watchdog events: none")
    return "\n".join(lines)
