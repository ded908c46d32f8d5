"""Frozen-schema validation for telemetry: pinned names and run-dir
checks (counterpart of ``nezha_tpu/analysis/telemetry_schema.py``, whose
names and checks it keeps; stdlib only).

:func:`check_run_dir` validates a captured run directory
(metrics.jsonl / spans.jsonl / summary.json / events.jsonl) against
schema v1; ``python -m nezha_tpu_torch.cli.telemetry RUN_DIR --check``
calls it. The pinned sets below are also what the JAX package's source
lint checks instrument names against, so the port's names stay those.

The run-dir contract (obs/sink.py) is an interface other tooling reads
— dashboards, the ``nezha-telemetry`` report, downstream analysis — so
drift must fail fast. Schema v1:

    metrics.jsonl   one JSON object per line; "step" int >= 0, "ts"
                    float; other values JSON scalars
    spans.jsonl     one JSON object per line; "name" str, "t0"/"t1"
                    floats with t1 >= t0, "dur_s" float, "attrs" object;
                    optionally the trace record fields "trace_id"/
                    "span_id"/"parent_id" (non-empty strings — the
                    distributed-tracing stitch key)
    summary.json    schema_version == 1; counters/gauges/histograms/
                    collectives objects; compile_cache with int
                    hits/misses; slowest_spans list of span records

This module also pins the LIVE ``GET /stats`` payload
(:func:`check_stats_payload`, stats schema v1): the replica shape
(``obs.stats_snapshot()``) and the router's fleet aggregate.
"""

from __future__ import annotations

import json
import os
import re
from typing import List

SCHEMA_VERSION = 1
_HIST_KEYS = {"count", "sum", "min", "max", "mean", "p50", "p90", "p99"}
_SUMMARY_KEYS = {"schema_version", "counters", "gauges", "histograms",
                 "collectives", "compile_cache", "num_spans",
                 "slowest_spans"}

# Serving-run schema (nezha-serve): the scheduler
# pre-registers this full instrument set, so a summary that carries the
# marker counter must carry ALL of them — dashboards key on the names
# (ttft, tpot, queue_depth, batch_occupancy, rejected_total, errors, ...).
_SERVE_MARKER = "serve.admitted_total"
_SERVE_COUNTERS = {"serve.admitted_total", "serve.rejected_total",
                   "serve.expired_total", "serve.retired_total",
                   "serve.tokens_total", "serve.prefill.chunks_total",
                   "serve.errors_total", "serve.step_retries_total",
                   "faults.injected_total",
                   # Paged-KV pool: requests that took cached
                   # prefix references instead of re-prefilling, and
                   # copy-on-write block copies. Layout-invariant: a
                   # dense-layout run reports 0s, never omits them.
                   "serve.kv.prefix_hits_total",
                   "serve.kv.cow_copies_total",
                   # Cross-replica KV migration (disaggregated
                   # prefill/decode tiers): committed installs and
                   # their int8-wire bytes. Topology-invariant: a
                   # homogeneous run reports 0s, never omits them.
                   "serve.kv.migrations_total",
                   "serve.kv.migration_bytes",
                   # Tiered KV host spill: trie blocks demoted
                   # to host RAM on eviction / promoted back on a
                   # returning prefix hit. Knob-invariant: runs with
                   # no host tier report 0s, never omit them.
                   "serve.kv.demotions_total",
                   "serve.kv.promotions_total",
                   # Fleet-wide KV reuse (serve/fleetcache):
                   # requests that reused cached prefix blocks, split
                   # by tier of origin (own device trie / own host
                   # tier / a sibling's peer pull), plus the wire
                   # bytes peer pulls installed. Knob-invariant:
                   # single-replica and affinity-off runs report 0s,
                   # never omit them.
                   "serve.kv.fleet_hits_total",
                   "serve.kv.fleet_hits_device_total",
                   "serve.kv.fleet_hits_host_total",
                   "serve.kv.fleet_hits_peer_total",
                   "serve.kv.pull_bytes",
                   # Speculative decoding: draft tokens
                   # proposed and accepted across all verify windows.
                   # Knob-invariant: a non-speculative run reports 0s,
                   # never omits them.
                   "serve.spec.draft_tokens_total",
                   "serve.spec.accepted_total",
                   # Tensor-sharded serving: trace-shape
                   # estimate of the cross-shard collective payload the
                   # mesh moved. Topology-invariant: single-device runs
                   # report 0, never omit it.
                   "serve.mesh.collective_bytes",
                   # Flash-prefill kernel: per-layer int8 K/V
                   # block writes fused into the kernel epilogue
                   # instead of the gather/requant round-trip. 0 on
                   # the XLA prefill path or a non-int8 pool.
                   "serve.prefill.fused_writes_total",
                   # Sequence-sharded prefill: ppermute hops
                   # the ring variant's chunks paid. Mode-invariant:
                   # replicated and ulysses runs report 0, never omit
                   # it.
                   "serve.prefill.ring_hops_total",
                   # Multi-tenant scheduling: decodes suspended
                   # to the trie/host tier for a higher-priority
                   # admission, suspends re-admitted, and per-tenant
                   # typed queue-cap sheds (also counted into
                   # rejected_total — that counter stays the ALL-sheds
                   # ledger). Knob-invariant: preemption-off runs
                   # report 0s, never omit them.
                   "serve.preemptions_total",
                   "serve.resumes_total",
                   "serve.tenant_over_limit_total"}
_SERVE_GAUGES = {"serve.queue_depth", "serve.batch_occupancy",
                 "serve.kv.blocks_used",
                 # KV quantization: device bytes the resident KV
                 # holds and the storage width in bits (8 = int8 blocks
                 # + per-block scales, 16/32 = plain bf16/f32 pools).
                 # Layout/dtype-invariant: every serving run reports
                 # them.
                 "serve.kv.bytes_resident", "serve.kv.quant_bits",
                 # Tiered KV host spill: occupancy of the
                 # host-side LRU of demoted blocks (0 without a tier).
                 "serve.kv.host_blocks_used",
                 "serve.kv.host_bytes_resident",
                 # Tensor-sharded serving: the mesh size this
                 # engine spans (1 = classic single-device engine).
                 "serve.mesh.devices",
                 # Flash-prefill kernel: 1 when paged prefill
                 # chunks dispatch through the Pallas kernel, 0 on the
                 # composed XLA path — dashboards label the prefill
                 # line with the active impl from this alone.
                 "serve.prefill.kernel_active",
                 # Sequence-sharded prefill: the mesh shards
                 # each prefill chunk spans — 0 in replicated mode, M
                 # in sequence mode on a 1xM mesh. Dashboards label
                 # the prefill line's parallelism mode from this
                 # alone.
                 "serve.prefill.seq_shards",
                 # Multi-tenant scheduling: requests currently
                 # suspended awaiting resume (0 with preemption off).
                 "serve.preempted_live"}
_SERVE_HISTOGRAMS = {"serve.ttft_s", "serve.tpot_s",
                     "serve.prefill.bucket_len",
                     # Decode-horizon instruments: host time
                     # between consecutive step dispatches, and the
                     # tokens-per-dispatch ceiling each block ran at.
                     "serve.host_gap_s", "serve.decode.horizon",
                     # Per-block max-abs dequant error sampled at each
                     # prefill-chunk write (count 0 on bf16 runs).
                     "serve.kv.quant_error",
                     # Speculative decoding: accepted-prefix
                     # length per verify window, in DRAFT tokens
                     # (tokens-per-verify = value + 1; count 0 on
                     # non-speculative runs).
                     "serve.spec.accepted_len",
                     # Multi-tenant scheduling: the per-
                     # priority-class TTFT split (every first token
                     # lands in serve.ttft_s AND its class's
                     # histogram) — the view that shows interactive
                     # latency holding while batch absorbs preemption.
                     "serve.ttft_s.interactive", "serve.ttft_s.batch",
                     "serve.ttft_s.background"}

# Router-run schema (nezha-serve --replicas N): the supervisor/router
# pair pre-registers this full set, so a summary carrying the marker
# counter must carry ALL of it — a run with zero failovers still reports
# failovers_total = 0.
_ROUTER_MARKER = "router.retries_total"
_ROUTER_COUNTERS = {"router.retries_total", "router.failovers_total",
                    "router.replica_restarts_total",
                    # Disaggregated topologies: local-decode (and
                    # no-prefill-tier) degradations — typed fallbacks,
                    # 0 on homogeneous runs.
                    "router.migrate_fallbacks_total",
                    # Fleet-wide KV reuse: admissions where
                    # the affinity scorer overrode the least-loaded
                    # pick (coverage win or cold consistent-hash
                    # placement). 0 with affinity routing off.
                    "router.affinity_wins_total"}
_ROUTER_GAUGES = {"router.replicas_live",
                  # Elastic autoscale: the replica count the
                  # supervisor's control loop is steering toward
                  # (equal to the configured size when autoscale is
                  # off).
                  "router.autoscale_target"}
_ROUTER_HISTOGRAMS = {"router.route_s",
                      # The queueing-delay split of the disaggregated
                      # pipeline: time to the parked prefill answer vs
                      # the decode replica's TTFT for the migrated
                      # request (both empty on homogeneous runs).
                      "router.prefill_wait_s", "router.decode_wait_s"}

# Dist-run schema: any run that touched the coordinator (any dist.*
# counter present — join() pre-registers the pair) must carry the full
# failure-accounting set, so a world that never retried still reports
# join_retries_total = 0.
_DIST_COUNTERS = {"dist.join_retries_total", "dist.heartbeat_lost_total"}

# Checkpoint-layer counters: pinned for the SOURCE rule only (run-dir
# summaries carry them ad hoc — a training run that never saw a corrupt
# checkpoint reports nothing, so there is no marker-counter contract to
# validate in a capture).
_CHECKPOINT_COUNTERS = {"checkpoint.corrupt_total"}

# Watchdog/SLO self-instrumentation: pinned for the SOURCE rule
# only — they appear only in runs that started a watchdog thread, so
# there is no marker-counter contract in captures.
_OBS_COUNTERS = {"watchdog.checks_total", "watchdog.events_total",
                 "watchdog.check_errors_total",
                 "slo.evaluations_total", "slo.violations_total"}
_OBS_GAUGES = {"slo.burn_rate_max"}

# Span-name registry for the namespaces this module owns: spans under
# serve./checkpoint./dist./router. are an interface (reports and
# dashboards key on them), so an unknown name in those namespaces is
# drift — add new spans HERE (and to the emitting layer's docs)
# deliberately.
_PINNED_SPAN_PREFIXES = ("serve.", "checkpoint.", "dist.", "router.")
_PINNED_SPANS = {
    "serve.prefill", "serve.decode_attention", "serve.drain",
    "checkpoint.save", "checkpoint.verify",
    "dist.join", "dist.barrier", "dist.failure", "dist.leave",
    "router.drain",
    # One span per disaggregated-pipeline orchestration: prefill
    # dispatch -> KV migration -> decode answer (attrs carry src/dst
    # rids, wire bytes, and any degradation taken).
    "router.migrate",
    # Distributed request tracing: the per-request lifecycle
    # fragments nezha-telemetry --trace stitches into one timeline.
    # Every one carries trace_id/span_id (and usually a request_id
    # attr); emitted ONLY for traced requests, so volume follows
    # --trace-sample.
    "router.request",        # the root fragment, minted at the router
    "serve.queue_wait",      # submit -> admission
    "serve.prefill.chunk",   # one per prefill bucket dispatch
    "serve.park",            # prefill_only park -> ack/resume/TTL/drain
    "serve.kv_export",       # source side of the migration pull
    "serve.kv_install",      # decode side: export POST+install+ACK
    "serve.decode_window",   # one per decode dispatch the request rode
    "serve.decode",          # decode residency + first-token milestone
    # Tensor-sharded serving: the train->serve checkpoint
    # resharding window (nezha-reshard / nezha-serve --mesh startup) —
    # attrs carry source format, step, and mesh size.
    "serve.reshard_s",
    # Tiered KV host spill: one span per host->device
    # promotion — the async-copy window dispatched ahead of the
    # bucketed prefill (attrs carry the block count).
    "serve.kv.promote_s",
    # Fleet-wide KV reuse: one span per near-miss peer pull
    # the router orchestrated — brackets the whole forward-with-
    # pull_from hop (attrs carry src/dst rids, blocks, wire bytes,
    # and whether the replica degraded to a cold prefill).
    "router.kv_pull_s",
    # Flash-prefill kernel: brackets one chunk's dispatch
    # through the Pallas prefill program (attrs carry the bucket
    # width). Absent entirely on the XLA prefill path.
    "serve.prefill.kernel_s",
    # Sequence-sharded prefill: brackets one whole prefill()
    # under prefill_mode=sequence — every chunk of the prompt sharded
    # over the mesh's sequence axis. Absent entirely in replicated
    # mode.
    "serve.prefill.seq_s",
    # Multi-tenant scheduling: brackets one preemption — trie
    # indexing of the victim's bound blocks through slot release
    # (attrs carry the victim's request_id, priority, and emitted
    # token count). Absent entirely with preemption off.
    "serve.preempt_s",
}

# Namespaces whose METRIC names (counter/gauge/histogram) the source
# rule pins, with the full membership per instrument kind.
PINNED_METRIC_PREFIXES = ("serve.", "router.", "dist.", "checkpoint.",
                          "watchdog.", "slo.")
PINNED_COUNTERS = (_SERVE_COUNTERS | _ROUTER_COUNTERS | _DIST_COUNTERS
                   | _CHECKPOINT_COUNTERS | _OBS_COUNTERS)
PINNED_GAUGES = _SERVE_GAUGES | _ROUTER_GAUGES | _OBS_GAUGES
PINNED_HISTOGRAMS = _SERVE_HISTOGRAMS | _ROUTER_HISTOGRAMS
PINNED_SPANS = _PINNED_SPANS
PINNED_SPAN_PREFIXES = _PINNED_SPAN_PREFIXES

# ------------------------------------------------- events.jsonl schema
# The typed watchdog/SLO event stream (obs/registry.record_event
# -> obs/sink.write_event). Kinds under the watchdog./slo. namespaces
# are an interface — alert routing and nezha-telemetry --slo key on
# them — so the registry below is the ONLY place new kinds are minted
# (the source lint rule checks literal record_event kinds against it).
EVENT_SCHEMA_VERSION = 1
EVENT_KIND_PREFIXES = ("watchdog.", "slo.")
EVENT_KINDS = {
    "watchdog.queue_depth_sustained",   # queue never drained a window
    "watchdog.ttft_regression",         # p99 vs trailing baseline
    "watchdog.replica_flap",            # restarts-per-window threshold
    "watchdog.slo_burn",                # error-budget burn-rate alert
    "slo.eval",                         # one record per SLO evaluation
}
EVENT_SEVERITIES = ("info", "warning", "critical")


def check_events_jsonl(path: str, errors: List[str]) -> None:
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                errors.append(f"events.jsonl:{i}: not valid JSON")
                continue
            if not isinstance(rec, dict):
                errors.append(f"events.jsonl:{i}: not an object")
                continue
            if rec.get("event_schema_version") != EVENT_SCHEMA_VERSION:
                errors.append(
                    f"events.jsonl:{i}: event_schema_version must be "
                    f"{EVENT_SCHEMA_VERSION}, got "
                    f"{rec.get('event_schema_version')!r}")
            if not _is_num(rec.get("ts")):
                errors.append(f"events.jsonl:{i}: 'ts' must be a number")
            kind = rec.get("kind")
            if not isinstance(kind, str) or not kind:
                errors.append(f"events.jsonl:{i}: 'kind' must be a "
                              f"non-empty string")
            elif (kind.startswith(EVENT_KIND_PREFIXES)
                    and kind not in EVENT_KINDS):
                errors.append(f"events.jsonl:{i}: kind {kind!r} is not "
                              f"in the pinned event registry "
                              f"(EVENT_KINDS) for its namespace")
            if rec.get("severity") not in EVENT_SEVERITIES:
                errors.append(f"events.jsonl:{i}: 'severity' must be one "
                              f"of {list(EVENT_SEVERITIES)}, got "
                              f"{rec.get('severity')!r}")
            if not isinstance(rec.get("source"), str):
                errors.append(f"events.jsonl:{i}: 'source' must be a "
                              f"string")
            if not isinstance(rec.get("detail"), dict):
                errors.append(f"events.jsonl:{i}: 'detail' must be an "
                              f"object")


# --------------------------------------------- /metrics exposition pins
# The Prometheus-text exposition contract (obs/timeseries.py renders
# it; a unit test pins both sides to these values). Every sample name
# carries the prefix; windowed samples are labeled with one of the
# window labels; histogram quantile samples with one of the quantile
# labels. Scrapers (nezha-top, external Prometheus) key on this shape.
EXPOSITION_PREFIX = "nezha_"
EXPOSITION_WINDOW_LABELS = ("10s", "60s", "300s")
EXPOSITION_QUANTILE_LABELS = ("p50", "p90", "p99")

_EXPO_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(-?[0-9.eE+]+"
    r"|[+-]?Inf|NaN)$")
_EXPO_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def check_metrics_exposition(text: str) -> List[str]:
    """-> schema violations of one ``GET /metrics`` body (empty =
    valid): every non-comment line a well-formed sample, every name
    under the pinned prefix, window/quantile label values drawn from
    the pinned vocabularies."""
    errors: List[str] = []
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _EXPO_SAMPLE_RE.match(line)
        if not m:
            errors.append(f"metrics:{i}: not a valid exposition sample")
            continue
        name, raw_labels = m.group(1), m.group(2)
        if not name.startswith(EXPOSITION_PREFIX):
            errors.append(f"metrics:{i}: sample name {name!r} lacks the "
                          f"pinned {EXPOSITION_PREFIX!r} prefix")
        labels = dict(_EXPO_LABEL_RE.findall(raw_labels)) \
            if raw_labels else {}
        w = labels.get("window")
        if w is not None and w not in EXPOSITION_WINDOW_LABELS:
            errors.append(f"metrics:{i}: window label {w!r} not in "
                          f"{list(EXPOSITION_WINDOW_LABELS)}")
        q = labels.get("quantile")
        if q is not None and q not in EXPOSITION_QUANTILE_LABELS:
            errors.append(f"metrics:{i}: quantile label {q!r} not in "
                          f"{list(EXPOSITION_QUANTILE_LABELS)}")
    return errors


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_span(rec, where: str, errors: List[str]) -> None:
    if not isinstance(rec, dict):
        errors.append(f"{where}: span record is not an object")
        return
    if not isinstance(rec.get("name"), str):
        errors.append(f"{where}: span 'name' must be a string")
    for k in ("t0", "t1", "dur_s"):
        if not _is_num(rec.get(k)):
            errors.append(f"{where}: span '{k}' must be a number")
    if (_is_num(rec.get("t0")) and _is_num(rec.get("t1"))
            and rec["t1"] < rec["t0"]):
        errors.append(f"{where}: span t1 < t0")
    if not isinstance(rec.get("attrs"), dict):
        errors.append(f"{where}: span 'attrs' must be an object")
    # Trace record fields (distributed tracing): optional — an
    # untraced span carries none of them — but when present they must
    # be non-empty strings, a trace_id never rides without its span_id,
    # and a parent link never rides without a trace (the stitcher keys
    # on exactly this shape).
    for k in ("trace_id", "span_id", "parent_id"):
        if k in rec and not (isinstance(rec[k], str) and rec[k]):
            errors.append(f"{where}: span {k!r} must be a non-empty "
                          f"string when present")
    if "trace_id" in rec and "span_id" not in rec:
        errors.append(f"{where}: span carries trace_id without span_id")
    if "parent_id" in rec and "trace_id" not in rec:
        errors.append(f"{where}: span carries parent_id without "
                      f"trace_id")
    name = rec.get("name")
    if (isinstance(name, str) and name.startswith(_PINNED_SPAN_PREFIXES)
            and name not in _PINNED_SPANS):
        errors.append(f"{where}: span name {name!r} is not in the pinned "
                      f"span registry (_PINNED_SPANS) for its namespace")


def check_metrics_jsonl(path: str, errors: List[str]) -> None:
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                errors.append(f"metrics.jsonl:{i}: not valid JSON")
                continue
            if not isinstance(rec, dict):
                errors.append(f"metrics.jsonl:{i}: not an object")
                continue
            step = rec.get("step")
            if not (isinstance(step, int) and not isinstance(step, bool)
                    and step >= 0):
                errors.append(f"metrics.jsonl:{i}: 'step' must be an int "
                              f">= 0, got {step!r}")
            if not _is_num(rec.get("ts")):
                errors.append(f"metrics.jsonl:{i}: 'ts' must be a number")
            for k, v in rec.items():
                if not isinstance(v, (int, float, str, bool, type(None))):
                    errors.append(f"metrics.jsonl:{i}: value for {k!r} is "
                                  f"not a JSON scalar")


def check_spans_jsonl(path: str, errors: List[str]) -> None:
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                errors.append(f"spans.jsonl:{i}: not valid JSON")
                continue
            _check_span(rec, f"spans.jsonl:{i}", errors)


def check_summary_json(path: str, errors: List[str]) -> None:
    try:
        with open(path) as f:
            summary = json.load(f)
    except ValueError:
        errors.append("summary.json: not valid JSON")
        return
    if not isinstance(summary, dict):
        errors.append("summary.json: not an object")
        return
    if summary.get("schema_version") != SCHEMA_VERSION:
        errors.append(f"summary.json: schema_version must be "
                      f"{SCHEMA_VERSION}, got "
                      f"{summary.get('schema_version')!r}")
    missing = _SUMMARY_KEYS - set(summary)
    if missing:
        errors.append(f"summary.json: missing key(s) {sorted(missing)}")
    for section in ("counters", "gauges"):
        vals = summary.get(section)
        if not isinstance(vals, dict):
            errors.append(f"summary.json: '{section}' must be an object")
            continue
        for k, v in vals.items():
            if not _is_num(v):
                errors.append(f"summary.json: {section}[{k!r}] must be a "
                              f"number")
    hists = summary.get("histograms")
    if isinstance(hists, dict):
        for k, h in hists.items():
            if not isinstance(h, dict) or not _HIST_KEYS <= set(h):
                errors.append(f"summary.json: histograms[{k!r}] must "
                              f"carry {sorted(_HIST_KEYS)}")
    else:
        errors.append("summary.json: 'histograms' must be an object")
    coll = summary.get("collectives")
    if isinstance(coll, dict):
        for op, row in coll.items():
            if not isinstance(row, dict):
                errors.append(f"summary.json: collectives[{op!r}] must be "
                              f"an object")
                continue
            for field in ("calls", "payload_bytes"):
                if field in row and not _is_num(row[field]):
                    errors.append(f"summary.json: collectives[{op!r}]"
                                  f".{field} must be a number")
    else:
        errors.append("summary.json: 'collectives' must be an object")
    cc = summary.get("compile_cache")
    if isinstance(cc, dict):
        for field in ("hits", "misses"):
            v = cc.get(field)
            if not (isinstance(v, int) and not isinstance(v, bool)):
                errors.append(f"summary.json: compile_cache.{field} must "
                              f"be an int")
    else:
        errors.append("summary.json: 'compile_cache' must be an object")
    slowest = summary.get("slowest_spans")
    if isinstance(slowest, list):
        for j, rec in enumerate(slowest):
            _check_span(rec, f"summary.json: slowest_spans[{j}]", errors)
    else:
        errors.append("summary.json: 'slowest_spans' must be a list")
    _check_serving(summary, errors)
    _check_router(summary, errors)
    _check_dist(summary, errors)


def _check_serving(summary: dict, errors: List[str]) -> None:
    """Serving-run summaries (marker: serve.admitted_total) must carry
    the complete pinned serve instrument set."""
    counters = summary.get("counters")
    if not isinstance(counters, dict) or _SERVE_MARKER not in counters:
        return
    for name in sorted(_SERVE_COUNTERS - set(counters)):
        errors.append(f"summary.json: serving run missing counter "
                      f"{name!r}")
    gauges = summary.get("gauges")
    gauges = gauges if isinstance(gauges, dict) else {}
    for name in sorted(_SERVE_GAUGES - set(gauges)):
        errors.append(f"summary.json: serving run missing gauge {name!r}")
    hists = summary.get("histograms")
    hists = hists if isinstance(hists, dict) else {}
    for name in sorted(_SERVE_HISTOGRAMS - set(hists)):
        errors.append(f"summary.json: serving run missing histogram "
                      f"{name!r}")


def _check_router(summary: dict, errors: List[str]) -> None:
    """Router-run summaries (marker: router.retries_total) must carry
    the complete pinned router instrument set."""
    counters = summary.get("counters")
    if not isinstance(counters, dict) or _ROUTER_MARKER not in counters:
        return
    for name in sorted(_ROUTER_COUNTERS - set(counters)):
        errors.append(f"summary.json: router run missing counter "
                      f"{name!r}")
    gauges = summary.get("gauges")
    gauges = gauges if isinstance(gauges, dict) else {}
    for name in sorted(_ROUTER_GAUGES - set(gauges)):
        errors.append(f"summary.json: router run missing gauge {name!r}")
    hists = summary.get("histograms")
    hists = hists if isinstance(hists, dict) else {}
    for name in sorted(_ROUTER_HISTOGRAMS - set(hists)):
        errors.append(f"summary.json: router run missing histogram "
                      f"{name!r}")


def _check_dist(summary: dict, errors: List[str]) -> None:
    """Runs that touched the coordinator (any ``dist.*`` counter) must
    carry the complete failure-accounting counter set."""
    counters = summary.get("counters")
    if not isinstance(counters, dict):
        return
    if not any(k.startswith("dist.") for k in counters):
        return
    for name in sorted(_DIST_COUNTERS - set(counters)):
        errors.append(f"summary.json: dist run missing counter {name!r}")


# --------------------------------------------------- live /stats schema
# The GET /stats payload contract (stats schema v1). Two shapes share
# it: a REPLICA payload (obs.stats_snapshot() — one registry's live
# counters/gauges/histogram summaries) and the router's FLEET payload
# (its own snapshot + every replica's, + a summed roll-up). Extra keys
# are allowed (a replica may add its role); the pinned core may not
# drift — dashboards curl this mid-run.
STATS_SCHEMA_VERSION = 1


def _check_stats_metrics(obj: dict, where: str,
                         errors: List[str]) -> None:
    for section in ("counters", "gauges"):
        vals = obj.get(section)
        if not isinstance(vals, dict):
            errors.append(f"{where}: '{section}' must be an object")
            continue
        for k, v in vals.items():
            if not _is_num(v):
                errors.append(f"{where}: {section}[{k!r}] must be a "
                              f"number")


def _check_stats_replica(obj: dict, where: str,
                         errors: List[str]) -> None:
    if obj.get("stats_schema_version") != STATS_SCHEMA_VERSION:
        errors.append(f"{where}: stats_schema_version must be "
                      f"{STATS_SCHEMA_VERSION}, got "
                      f"{obj.get('stats_schema_version')!r}")
    if not _is_num(obj.get("ts")):
        errors.append(f"{where}: 'ts' must be a number")
    if not isinstance(obj.get("enabled"), bool):
        errors.append(f"{where}: 'enabled' must be a bool")
    _check_stats_metrics(obj, where, errors)
    hists = obj.get("histograms")
    if isinstance(hists, dict):
        for k, h in hists.items():
            if not isinstance(h, dict) or not _HIST_KEYS <= set(h):
                errors.append(f"{where}: histograms[{k!r}] must carry "
                              f"{sorted(_HIST_KEYS)}")
    else:
        errors.append(f"{where}: 'histograms' must be an object")


def check_stats_payload(obj) -> List[str]:
    """-> schema violations of one ``GET /stats`` response body (empty
    = valid). Accepts both the replica shape and the router's fleet
    shape, dispatching on ``kind``."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return ["stats payload is not an object"]
    kind = obj.get("kind")
    if kind == "replica":
        _check_stats_replica(obj, "stats", errors)
    elif kind == "fleet":
        if obj.get("stats_schema_version") != STATS_SCHEMA_VERSION:
            errors.append(f"stats: stats_schema_version must be "
                          f"{STATS_SCHEMA_VERSION}, got "
                          f"{obj.get('stats_schema_version')!r}")
        if not _is_num(obj.get("ts")):
            errors.append("stats: 'ts' must be a number")
        router = obj.get("router")
        if isinstance(router, dict):
            _check_stats_replica(router, "stats.router", errors)
        else:
            errors.append("stats: 'router' must be an object")
        replicas = obj.get("replicas")
        if isinstance(replicas, list):
            for i, row in enumerate(replicas):
                where = f"stats.replicas[{i}]"
                if not isinstance(row, dict):
                    errors.append(f"{where}: must be an object")
                    continue
                if not _is_num(row.get("rid")):
                    errors.append(f"{where}: 'rid' must be a number")
                for k in ("role", "state"):
                    if not isinstance(row.get(k), str):
                        errors.append(f"{where}: {k!r} must be a "
                                      f"string")
                if not isinstance(row.get("healthy"), bool):
                    errors.append(f"{where}: 'healthy' must be a bool")
                stats = row.get("stats")
                if stats is not None:      # None = member unreachable
                    if isinstance(stats, dict):
                        _check_stats_replica(stats, where + ".stats",
                                             errors)
                    else:
                        errors.append(f"{where}: 'stats' must be an "
                                      f"object or null")
        else:
            errors.append("stats: 'replicas' must be a list")
        fleet = obj.get("fleet")
        if isinstance(fleet, dict):
            _check_stats_metrics(fleet, "stats.fleet", errors)
        else:
            errors.append("stats: 'fleet' must be an object")
    else:
        errors.append(f"stats: 'kind' must be 'replica' or 'fleet', "
                      f"got {kind!r}")
    return errors


def check_run_dir(run_dir: str) -> List[str]:
    """-> list of schema violations (empty = valid). All three original
    artifacts are required — a run dir missing one is itself a
    violation. ``events.jsonl`` is validated when present but
    never required, so captures without one stay valid."""
    errors: List[str] = []
    for name, checker in (("metrics.jsonl", check_metrics_jsonl),
                          ("spans.jsonl", check_spans_jsonl),
                          ("summary.json", check_summary_json)):
        path = os.path.join(run_dir, name)
        if not os.path.isfile(path):
            errors.append(f"{name}: missing from {run_dir}")
            continue
        checker(path, errors)
    events = os.path.join(run_dir, "events.jsonl")
    if os.path.isfile(events):
        check_events_jsonl(events, errors)
    return errors
