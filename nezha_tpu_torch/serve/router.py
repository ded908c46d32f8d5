"""The multi-replica HTTP front end: health-checked routing + failover.

One process in front of N single-replica engines (spawned and restarted
by ``serve/supervisor.py``), answering the SAME protocol one replica
does (POST ``/generate``, GET ``/healthz``) so clients cannot tell one
engine from a crowd — except that losing any replica no longer loses
the service:

- **probing** — a background prober GETs each replica's ``/healthz``
  every ``probe_interval_s``; ``probe_misses`` consecutive failures
  EJECT the replica from routing, one success readmits it. A forward
  that dies on the wire ejects immediately (stronger evidence than a
  missed probe).
- **balancing** — least-loaded: the replica with the fewest
  router-tracked in-flight forwards (ties broken by its last-probed
  queue depth). A replica answering 503 (queue full / draining) is
  skipped for that request; the client sees 503 only when EVERY live
  replica refused. With ``affinity_routing`` on
  (serve/fleetcache) token-id requests are instead scored by
  prefix-AFFINITY — expected cached-prefix hit length from each
  replica's /healthz trie digest, discounted by load — and a
  near-miss hands the chosen replica a peer ``pull_from`` hint so it
  fetches the covering blocks from the sibling that has them (the
  ``router.kv_pull_s`` span brackets the hop; failure degrades to a
  cold prefill, never an error).
- **failover** — a replica that dies BEFORE its response begins
  provably delivered nothing, so the request is re-dispatched to a
  different replica: bounded retries (``route_retries``) with the
  seeded-backoff envelope (base doubling to a cap, ±50% jitter).
  Once a response has BEGUN, the stream is committed — a death
  mid-response returns the typed ``replica_lost`` error instead of a
  retry (the replica may have observably acted; re-running it could
  double-serve). Timeouts are typed errors too, never retries: a slow
  replica is not a dead one.
- **typed errors** — every failure mode the client can see carries an
  ``error_type``: ``no_live_replicas`` / ``queue_full`` (503, nothing
  could take the request), ``replica_lost`` (502), ``replica_timeout``
  (504), ``draining`` (503), ``bad_request`` (400, passthrough),
  ``injected_fault`` (500, chaos drills), ``migration_failed`` (502,
  disaggregated topologies only — every migration avenue AND the
  local-decode fallback failed). A request is NEVER silently dropped —
  the replica-kill chaos acceptance pins that.
- **disaggregation** — with ``RouterConfig.roles`` naming a prefill
  tier (``role=prefill`` members), admission lands on the least-loaded
  prefill replica with ``prefill_only`` (the replica prefills and
  PARKS the slot), then the router hands a decode-tier replica
  (``role=decode``/``both``) a ``pull_from`` reference: the decode
  side pulls the prompt's KV blocks over the int8+scales wire
  (serve/migrate.py), installs them into its own pool, ACKs the
  source (which only then releases its refs — two-phase handoff), and
  decodes. A prefill replica lost mid-migration restarts the whole
  pipeline on another prefill replica (nothing was delivered); a
  decode replica lost before answering retries the migration against
  another decode member; a dead/full decode tier degrades to LOCAL
  decode on the source (``resume`` — the ``role=both`` degradation),
  all under the same bounded seeded-backoff envelope. The
  ``router.migrate`` span brackets each orchestration;
  ``router.prefill_wait_s`` / ``router.decode_wait_s`` split the
  queueing delay per tier (schema-pinned).

Telemetry (schema-pinned by the telemetry schema checker, rendered
as the report's "replicas" section): ``router.replicas_live`` gauge,
``router.retries_total`` / ``router.failovers_total`` /
``router.replica_restarts_total`` counters, ``router.route_s``
histogram, and the ``router.drain`` span around the rolling drain.
Plain attribute ledgers (:attr:`Router.retries`,
:attr:`Router.failovers`, ``Supervisor.restarts``) mirror the counters
for callers outside a telemetry run (obs counters are branch-only
no-ops while disabled). Fault points ``router.route`` and
``router.probe`` make both paths chaos-drillable.

Fleet observability: the router MINTS a distributed trace id
per admission (sampled by ``obs.set_trace_sample`` / the serve CLI's
``--trace-sample``) and forwards it on every hop — the ``trace_id``
payload field + ``X-Nezha-Trace`` header on ``/generate``, the pull
reference on ``/kv_export``/``/kv_ack`` — so each replica's lifecycle
spans become fragments of one per-request timeline
(``nezha-telemetry RUN_DIR --trace`` stitches them; the
``router.request`` span is the root fragment). ``GET /stats`` answers
the LIVE fleet snapshot: the router's registry, every replica's
``/stats`` payload, and a roll-up that sums each distinct registry
once (``registry_id`` dedupe — thread and process backends report the
same fleet totals). adds the windowed pair: ``GET /windows``
(member window views merged sketch-wise) and ``GET /metrics``
(Prometheus text of the fleet roll-up — ``nezha-top``'s poll target).
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
from typing import Dict, Optional, Tuple

from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.faults import InjectedFault
from nezha_tpu_torch.serve.supervisor import LIVE, STARTING, RouterConfig


def register_router_instruments() -> None:
    """Pre-register (get-or-create) the router instrument set so every
    router run's summary carries all of it — a run with zero failovers
    still reports ``failovers_total = 0`` (the stable schema
    the telemetry schema checker pins). Called at Supervisor/Router
    construction; call again after a registry reset (a benchmark that
    starts its run AFTER warmup)."""
    for c in ("retries", "failovers", "replica_restarts",
              "migrate_fallbacks"):
        obs.counter(f"router.{c}_total")
    # Fleet-wide KV reuse: admissions where the affinity
    # scorer overrode the least-loaded pick (coverage win or cold
    # consistent-hash placement). Knob-invariant 0 when affinity
    # routing is off.
    obs.counter("router.affinity_wins_total")
    obs.gauge("router.replicas_live")
    # Elastic autoscale: the replica count the supervisor's
    # control loop steers toward (the configured size when autoscale
    # is off).
    obs.gauge("router.autoscale_target")
    obs.histogram("router.route_s")
    # Disaggregated-tier queueing split: time to the PARKED prefill
    # answer (queue wait + prefill at the source) vs the decode
    # replica's reported TTFT for the migrated request (queue wait +
    # tail prefill + first block slice at the destination). Both empty
    # on homogeneous topologies.
    obs.histogram("router.prefill_wait_s")
    obs.histogram("router.decode_wait_s")


def _typed(status: int, kind: str, msg: str) -> Tuple[int, dict]:
    return status, {"error": msg, "error_type": kind}


# The park receipt's finish_reason (scheduler.FinishReason.PREFILLED —
# spelled locally so the router stays importable without the engine
# stack: the front end never builds a model or touches the card).
FR_PREFILLED = "prefilled"


class Router:
    """Route requests across a :class:`~nezha_tpu_torch.serve.supervisor.
    Supervisor`'s replicas. :meth:`route` is the whole contract: it
    takes the client's request payload and ALWAYS returns an
    ``(http_status, response_object)`` pair — success, a replica's own
    4xx passed through, or a typed error object; it never raises for a
    replica failure. Thread-safe: HTTP handler threads call it
    concurrently."""

    # Cross-thread state -> guarding lock (the lock-discipline
    # lint's declaration): handler threads bump the ledgers
    # concurrently, and the backoff RNG's stream advance is a mutation.
    _LOCK_GUARDED = {"retries": "_ledger_lock",
                     "failovers": "_ledger_lock",
                     "migrations": "_ledger_lock",
                     "migration_bytes": "_ledger_lock",
                     "migration_seconds": "_ledger_lock",
                     "migrate_fallbacks": "_ledger_lock",
                     "affinity_wins": "_ledger_lock",
                     "kv_pulls": "_ledger_lock",
                     "kv_pull_bytes": "_ledger_lock",
                     "_rng": "_rng_lock"}

    def __init__(self, supervisor, cfg: Optional[RouterConfig] = None):
        self.sup = supervisor
        self.cfg = cfg if cfg is not None else supervisor.cfg
        self._rng = random.Random(self.cfg.seed)
        self._rng_lock = threading.Lock()
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        # Plain ledgers: obs counters only count inside a telemetry run.
        self.retries = 0
        self.failovers = 0
        # Migration ledgers (disaggregated topologies): committed
        # migrations, wire bytes moved, the SUM of per-pull transfer
        # windows (bytes / seconds = the bench's mean per-pull wire
        # rate — overlapping pulls each contribute their own window),
        # and local-decode fallbacks (typed degradation, not an
        # error).
        self.migrations = 0
        self.migration_bytes = 0
        self.migration_seconds = 0.0
        self.migrate_fallbacks = 0
        # Fleet-cache ledgers: affinity picks that overrode
        # least-loaded, committed peer pulls, and their wire bytes.
        self.affinity_wins = 0
        self.kv_pulls = 0
        self.kv_pull_bytes = 0
        self._ledger_lock = threading.Lock()
        register_router_instruments()

    # -------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Run the prober on a background thread (tests drive
        :meth:`probe_all` directly for determinism instead)."""
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="nezha-prober")
        self._probe_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.cfg.probe_interval_s):
            self.probe_all()

    # ---------------------------------------------------------- probing
    def probe_all(self) -> None:
        """One probe sweep over every replica that should be serving."""
        for r in self.sup.replicas():
            if r.state not in (STARTING, LIVE):
                continue
            ok, payload = self._probe(r)
            self.sup.mark_probe(r.rid, ok, payload)

    def _get_json(self, r, path: str) -> Optional[dict]:
        """GET one replica endpoint -> the parsed JSON object, or None
        on ANY failure (refused/reset/timeout/non-200/non-object) —
        the one fetch primitive the prober and the stats view share,
        so a transport fix can never land in one and miss the other."""
        conn = None
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", r.port, timeout=self.cfg.probe_timeout_s)
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return None
            obj = json.loads(body)
            return obj if isinstance(obj, dict) else None
        except Exception:
            return None
        finally:
            if conn is not None:
                conn.close()

    def _probe(self, r) -> Tuple[bool, Optional[dict]]:
        try:
            faults.point("router.probe")
        except Exception:
            # An injected router.probe fault reads as a MISSED probe.
            return False, None
        payload = self._get_json(r, "/healthz")
        return payload is not None, payload

    def _fetch_all(self, path: str) -> Dict[int, Optional[dict]]:
        """Fetch one endpoint from every routable member CONCURRENTLY
        under one shared deadline: a wedged replica (exactly what an
        operator curls the fleet views to diagnose) costs the view one
        probe window, not one window PER wedged member; a fetch that
        misses the deadline reports that member as null."""
        fetched: Dict[int, Optional[dict]] = {}
        threads = []
        for r in self.sup.replicas():
            if r.state in (STARTING, LIVE) and r.port:
                def fetch(rep=r):
                    fetched[rep.rid] = self._get_json(rep, path)
                t = threading.Thread(target=fetch, daemon=True)
                threads.append(t)
                t.start()
        deadline = time.monotonic() + self.cfg.probe_timeout_s
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        return fetched

    # ------------------------------------------------------- live stats
    def fleet_stats(self) -> dict:
        """The live fleet snapshot ``GET /stats`` answers (stats schema
        v1, pinned by the stats schema check):
        the router's own registry snapshot, every routable replica's
        ``/stats`` payload fetched live (None for a member that did not
        answer), and a ``fleet`` roll-up summing counters and gauges —
        one curl shows live occupancy, migration rate, and the queue
        split without touching a run dir. The roll-up sums each
        DISTINCT registry once, keyed by the ``registry_id`` every
        payload carries: with the thread replica backend all members
        (and the router itself) share this process's registry, so
        summing per member would over-count by the member count — the
        dedupe makes thread and process backends report the same fleet
        totals. Per-replica rows always show every member's payload."""
        reps = self.sup.replicas()
        fetched = self._fetch_all("/stats")
        out = obs.stats_snapshot()
        replicas = []
        fleet_counters: Dict[str, float] = {}
        fleet_gauges: Dict[str, float] = {}
        seen_regs = set()

        def roll_up(stats: dict) -> None:
            reg = stats.get("registry_id")
            if isinstance(reg, str) and reg:
                if reg in seen_regs:
                    return
                seen_regs.add(reg)
            for k, v in (stats.get("counters") or {}).items():
                fleet_counters[k] = fleet_counters.get(k, 0) + v
            for k, v in (stats.get("gauges") or {}).items():
                fleet_gauges[k] = fleet_gauges.get(k, 0) + v

        # The router's own registry joins the roll-up first: in thread
        # mode it IS every member's registry (one contribution total);
        # in process mode it contributes the router.* instruments.
        roll_up(out)
        for r in reps:
            stats = fetched.get(r.rid)
            if isinstance(stats, dict):
                roll_up(stats)
            replicas.append({"rid": r.rid, "role": r.role,
                             "port": r.port, "state": r.state,
                             "healthy": r.healthy, "stats": stats})
        return {"stats_schema_version": 1, "kind": "fleet",
                "ts": out["ts"], "enabled": out["enabled"],
                "router": out, "replicas": replicas,
                "fleet": {"counters": fleet_counters,
                          "gauges": fleet_gauges}}

    def fleet_windows(self) -> dict:
        """The fleet's rolled-up window views (``GET /windows``): every
        member's ``windows_payload()`` fetched live plus the router's
        own, merged by obs.merge_window_payloads — sketches merge
        bucket-wise (exact quantiles, never summed snapshot
        percentiles), and members sharing a registry (thread backend)
        contribute once."""
        fetched = self._fetch_all("/windows")
        payloads = [obs.windows_payload()]
        payloads.extend(p for p in fetched.values()
                        if isinstance(p, dict))
        return obs.merge_window_payloads(payloads)

    def fleet_metrics_text(self) -> str:
        """The fleet ``GET /metrics`` body: the deduped cumulative
        roll-up plus the merged window views, in Prometheus text
        format."""
        stats = self.fleet_stats()
        return obs.render_prometheus(stats.get("fleet"),
                                     self.fleet_windows())

    def wait_live(self, n: int, timeout_s: float = 300.0) -> bool:
        """Probe until ``n`` replicas are live (startup convenience for
        benchmarks and tests). Returns False on timeout."""
        t_end = time.monotonic() + timeout_s
        while time.monotonic() < t_end:
            self.probe_all()
            if self.sup.live_count() >= n:
                return True
            time.sleep(0.05)
        return False

    # ---------------------------------------------------------- routing
    def route(self, payload: dict) -> Tuple[int, dict]:
        """Dispatch one request: pick the least-loaded live replica,
        forward, fail over on uncommitted replica loss. On a
        disaggregated topology (``cfg.roles`` names a prefill tier)
        the dispatch is the two-phase prefill -> migrate -> decode
        pipeline instead. Always returns ``(status, object)`` — see
        the module docstring for the error taxonomy.

        The router is the fleet's TRACE-MINTING edge: each admission
        mints a trace id (None while telemetry is disabled or the
        ``obs.set_trace_sample`` knob rolls it out) and forwards it on
        every hop — the ``trace_id`` payload field plus the
        ``X-Nezha-Trace`` header on ``/generate``, and the pull
        reference on ``/kv_export`` / ``/kv_ack`` — so every replica's
        lifecycle spans land in one stitched per-request timeline. The
        ``router.request`` span is the timeline's root fragment."""
        t0 = time.monotonic()
        tid = None
        if isinstance(payload, dict):
            client_tid = payload.get("trace_id")
            if not isinstance(client_tid, str) or not client_tid:
                # A malformed (non-string) client trace_id must neither
                # poison the pinned span schema nor crash _forward's
                # header write — it is scrubbed and replaced by the
                # router's own minting verdict.
                client_tid = None
            tid = client_tid or obs.mint_trace_id()
            # ALWAYS rewrite the field: the minted id, or "" marking
            # "routed and sampled out" — the replica scheduler treats
            # "" as explicitly untraced and never re-mints, so the
            # router stays the fleet's single sampling edge
            # (--trace-sample P yields P, not P + (1-P)P).
            payload = {**payload, "trace_id": tid or ""}
        try:
            faults.point("router.route")
            with obs.trace_context(tid):
                with obs.traced_span("router.request") as sp:
                    if isinstance(payload, dict) and payload.get("id"):
                        sp.set(request_id=payload["id"])
                    if self.cfg.disaggregated:
                        status, obj = self._route_disagg(payload)
                    else:
                        status, obj = self._route_inner(
                            json.dumps(payload).encode(), trace_id=tid,
                            payload=payload)
                    sp.set(status=status)
                    return status, obj
        except InjectedFault as e:
            return _typed(500, "injected_fault", str(e))
        finally:
            obs.histogram("router.route_s").observe(
                time.monotonic() - t0)

    def _route_inner(self, body: bytes,
                     trace_id: Optional[str] = None,
                     payload: Optional[dict] = None) -> Tuple[int, dict]:
        # Affinity routing needs the prompt's TOKEN ids to hash
        # against the fleet digests — text prompts (no ids until the
        # replica tokenizes) and disaggregated dispatches (payload
        # None) route least-loaded, exactly as before.
        tokens = None
        if self.cfg.affinity_routing and isinstance(payload, dict):
            pt = payload.get("prompt_tokens")
            if isinstance(pt, list) and pt \
                    and all(isinstance(t, int) for t in pt):
                tokens = pt
        excluded: set = set()
        retries = 0
        failed_over = False
        while True:
            usable = [r for r in self.sup.live_replicas()
                      if r.rid not in excluded]
            if not usable:
                if failed_over:
                    return _typed(502, "replica_lost",
                                  f"no live replica left after "
                                  f"{retries} dispatch(es) failed")
                return _typed(503, "no_live_replicas",
                              "no live replicas")
            outcome, detail, r = self._dispatch_tier(
                usable, body, trace_id=trace_id, payload=payload,
                tokens=tokens)
            if outcome == "all_full":
                return _typed(503, "queue_full",
                              f"all {detail} live replica(s) at "
                              f"capacity")
            if outcome == "ok":
                if failed_over:
                    self._count_failover()
                return 200, detail
            if outcome == "pass":           # the replica's own 4xx
                return detail
            if outcome == "timeout":
                return _typed(504, "replica_timeout", detail)
            if outcome == "committed":
                # The response had begun: the stream is committed and
                # a retry could double-serve — typed error.
                return _typed(502, "replica_lost",
                              f"replica {r.rid} lost after its "
                              f"response began: {detail}")
            # outcome == "lost": died before any response byte —
            # provably delivered nothing, safe to fail over.
            failed_over = True
            excluded.add(r.rid)
            self.sup.note_forward_failure(r.rid)
            if retries >= self.cfg.route_retries:
                return _typed(502, "replica_lost",
                              f"replica {r.rid} died before the "
                              f"first token; {retries} retr"
                              f"{'y' if retries == 1 else 'ies'} "
                              f"exhausted: {detail}")
            retries += 1
            self._count_retry(retries)
            # loop: rebuild the live set — it may have changed

    # ------------------------------------- shared dispatch + ledgers
    def _count_retry(self, attempt: int) -> None:
        with self._ledger_lock:
            self.retries += 1
        obs.counter("router.retries_total").inc()
        time.sleep(self._retry_backoff(attempt))

    def _count_failover(self) -> None:
        with self._ledger_lock:
            self.failovers += 1
        obs.counter("router.failovers_total").inc()

    def _dispatch_tier(self, cand, body: bytes,
                       trace_id: Optional[str] = None,
                       payload: Optional[dict] = None,
                       tokens: Optional[list] = None):
        """Least-loaded (or, with tokens + affinity routing, digest-
        affinity) sweep over one tier: forward to the best member,
        skipping 503-full members for this request. -> ``(outcome,
        detail, replica)`` with :meth:`_forward`'s outcomes plus
        ``("all_full", tier size, None)`` when every member refused.

        On a near-miss (a NON-chosen member's digest covers more of
        the prompt than the chosen one's) the forward carries a
        ``pull_from`` hint naming that sibling — queue-full members
        still serve as pull SOURCES (``/kv_export`` is read-only, no
        admission involved), which is exactly how a saturated owner's
        cache keeps paying off through its siblings."""
        full: set = set()
        while True:
            usable = [r for r in cand if r.rid not in full]
            if not usable:
                return "all_full", len(cand), None
            r, pull = self._pick(usable, cand, tokens)
            if pull is not None and isinstance(payload, dict):
                outcome, detail = self._forward_pull(
                    r, payload, pull, trace_id=trace_id)
            else:
                outcome, detail = self._forward(r, body,
                                                trace_id=trace_id)
            if outcome == "full":
                full.add(r.rid)
                continue
            return outcome, detail, r

    def _pick(self, usable, cand, tokens):
        """Choose the dispatch target among ``usable`` (and, on a
        near-miss, a pull source from the full tier ``cand``). ->
        ``(replica, pull_hint_or_None)``.

        Baseline is the least-loaded pick (fewest in-flight forwards,
        ties by probed queue depth, then rid). With affinity routing
        on and integer prompt tokens at hand, every usable member is
        scored ``coverage_tokens / (1 + load)`` from its freshest
        digest; the best scorer wins only when it strictly beats the
        baseline's own score — affinity never routes to a busier
        replica than the hit is worth. When NOBODY covers anything,
        the tie among minimally loaded members is broken by a
        consistent hash of the prompt's first block instead of by rid,
        so repeat users grow an owner replica. The ``router.affinity``
        fault point degrades the whole scorer to the baseline pick —
        typed, request-scoped, never an error the client sees."""
        base = min(usable, key=lambda x: (
            x.in_flight, x.last_health.get("queued", 0), x.rid))
        if not tokens or not self.cfg.affinity_routing \
                or len(self.sup.replicas()) < 2:
            return base, None
        try:
            faults.point("router.affinity")
        except InjectedFault:
            return base, None
        from nezha_tpu_torch.serve import fleetcache
        now = time.monotonic()
        hashes_by_bs: Dict[int, list] = {}
        cover: Dict[int, tuple] = {}    # rid -> (blocks, block_size)

        def load_of(x) -> int:
            try:
                return x.in_flight + int(
                    x.last_health.get("queued", 0) or 0)
            except (TypeError, ValueError):
                return x.in_flight

        for x in cand:
            if x.probed_t <= 0:
                continue    # never probed: no digest to trust
            parsed = fleetcache.digest_entries_of(x.last_health)
            if parsed is None:
                continue
            bs, entries = parsed
            try:
                age = float(x.last_health.get("digest_age_s", 0.0))
            except (TypeError, ValueError):
                age = 0.0
            if age + (now - x.probed_t) > self.cfg.digest_stale_s:
                continue    # advisory data gone stale — ignore
            hashes = hashes_by_bs.get(bs)
            if hashes is None:
                hashes = fleetcache.prefix_hashes(tokens, bs)
                hashes_by_bs[bs] = hashes
            blocks, _tier = fleetcache.coverage(entries, hashes)
            if blocks:
                cover[x.rid] = (blocks, bs)

        def score_of(x) -> float:
            c = cover.get(x.rid)
            if c is None:
                return 0.0
            return fleetcache.score(c[0], c[1], x.in_flight,
                                    load_of(x) - x.in_flight)

        pick = base
        if cover:
            best = max(usable, key=lambda x: (score_of(x), -load_of(x),
                                              -x.rid))
            if score_of(best) > score_of(base):
                pick = best
        else:
            # Cold placement: nobody covers anything, so spread the
            # prefix deterministically across the members tied at the
            # baseline's load — least-loaded is preserved, only its
            # rid tie-break changes.
            bs = next(iter(hashes_by_bs), 16)
            key = (base.in_flight, base.last_health.get("queued", 0))
            tied = [x.rid for x in usable
                    if (x.in_flight,
                        x.last_health.get("queued", 0)) == key]
            rid = fleetcache.place_cold(tokens, bs, tied)
            if rid is not None and rid != base.rid:
                pick = next(x for x in usable if x.rid == rid)
        if pick.rid != base.rid:
            with self._ledger_lock:
                self.affinity_wins += 1
            obs.counter("router.affinity_wins_total").inc()
        # Near-miss peer pull: a sibling (any tier member, even one
        # whose queue is full — export needs no admission) covering
        # MORE than the pick gets handed to the pick as pull_from.
        pick_cov = cover.get(pick.rid, (0, 0))[0]
        src_rid, src_cov, src_bs = None, pick_cov, 0
        for x in cand:
            if x.rid == pick.rid:
                continue
            c = cover.get(x.rid)
            if c is not None and c[0] > src_cov:
                src_rid, src_cov, src_bs = x.rid, c[0], c[1]
        if src_rid is None:
            return pick, None
        src = next(x for x in cand if x.rid == src_rid)
        pull = {"host": "127.0.0.1", "port": src.port,
                "tokens": [int(t) for t in tokens[:src_cov * src_bs]],
                "blocks": src_cov, "src_rid": src.rid}
        return pick, pull

    def _forward_pull(self, r, payload: dict, pull: dict,
                      trace_id: Optional[str] = None):
        """Forward with a peer-pull hint attached, the hop bracketed
        by the pinned ``router.kv_pull_s`` span; a committed pull (the
        replica reports installed blocks) lands in the
        :attr:`kv_pulls` / :attr:`kv_pull_bytes` ledgers and the
        schema-pinned counters the replica side already bumped."""
        hint = dict(pull)
        src_rid = hint.pop("src_rid", None)
        if trace_id:
            hint["trace_id"] = trace_id
        body = json.dumps({**payload, "pull_from": hint}).encode()
        with obs.span("router.kv_pull_s", src=src_rid, dst=r.rid,
                      blocks=pull.get("blocks", 0)) as sp:
            outcome, detail = self._forward(r, body, trace_id=trace_id)
            meta = (detail.get("fleet_pull")
                    if outcome == "ok" and isinstance(detail, dict)
                    else None)
            if isinstance(meta, dict):
                sp.set(bytes=int(meta.get("bytes", 0) or 0),
                       installed=int(meta.get("installed", 0) or 0),
                       degraded=bool(meta.get("degraded")))
                if meta.get("installed"):
                    with self._ledger_lock:
                        self.kv_pulls += 1
                        self.kv_pull_bytes += int(meta.get("bytes", 0)
                                                  or 0)
        return outcome, detail

    def _src_live(self, src) -> bool:
        return any(r.rid == src.rid for r in self.sup.live_replicas())

    # ---------------------------------------------- disaggregated tiers

    def _route_disagg(self, payload: dict) -> Tuple[int, dict]:
        """The disaggregated pipeline: admit onto the prefill tier
        (``prefill_only`` parks the prompt's KV at the source), migrate
        the parked blocks to a decode-tier replica, return its answer.
        Crash-safe by phase: before the prefill answer nothing exists
        (plain failover); between park and a committed decode answer
        the request has delivered NOTHING to the client, so a lost
        source restarts the whole pipeline elsewhere and a lost decode
        replica retries the migration — bounded by ``route_retries``
        with the seeded-backoff envelope; a dead/full decode tier
        degrades to local decode on the source. The whole orchestration
        is one ``router.migrate`` span."""
        with obs.span("router.migrate") as sp:
            faults.point("router.migrate")
            rid = payload.get("id") if isinstance(payload, dict) else None
            if not rid:
                import uuid
                rid = f"mig-{uuid.uuid4().hex[:12]}"
            payload = {**payload, "id": rid}
            status, obj = self._disagg_pipeline(payload, rid, sp)
            sp.set(status=status)
            return status, obj

    def _disagg_pipeline(self, payload: dict, rid: str,
                         sp) -> Tuple[int, dict]:
        tid = payload.get("trace_id")
        pf_body = json.dumps({**payload, "prefill_only": True}).encode()
        attempts = 0          # whole-pipeline restarts (source lost)
        excluded: set = set()
        failed_over = False
        while True:
            # The prefill tier is the role=prefill members ONLY:
            # role=both replicas belong to the decode tier (and the
            # local-decode degradation) — admitting onto them would
            # put prefill bursts back on decode hardware, the exact
            # interleaving disaggregation exists to prevent.
            prefill_live = [r for r in self.sup.live_replicas()
                            if r.role == "prefill"
                            and r.rid not in excluded]
            if not prefill_live:
                # No prefill tier left: degrade to classic routing over
                # whatever is live (typed telemetry — the decode/both
                # tier serves the request end to end).
                with self._ledger_lock:
                    self.migrate_fallbacks += 1
                obs.counter("router.migrate_fallbacks_total").inc()
                sp.set(degraded="no_prefill_tier")
                return self._route_inner(json.dumps(payload).encode(),
                                         trace_id=tid)
            t_pf = time.monotonic()
            outcome, detail, src = self._dispatch_tier(prefill_live,
                                                       pf_body,
                                                       trace_id=tid)
            if outcome == "all_full":
                return _typed(503, "queue_full",
                              f"all {detail} live prefill replica(s) "
                              f"at capacity")
            if outcome == "pass":
                return detail
            if outcome == "timeout":
                return _typed(504, "replica_timeout", detail)
            if outcome == "committed":
                return _typed(502, "replica_lost",
                              f"prefill replica {src.rid} lost after "
                              f"its response began: {detail}")
            if outcome == "lost":
                self.sup.note_forward_failure(src.rid)
                excluded.add(src.rid)
                failed_over = True
                if attempts >= self.cfg.route_retries:
                    return _typed(502, "replica_lost",
                                  f"prefill dispatch failed and "
                                  f"{attempts} restart(s) exhausted: "
                                  f"{detail}")
                attempts += 1
                self._count_retry(attempts)
                continue
            # outcome == "ok": the prompt is parked at `src`.
            if detail.get("finish_reason") != FR_PREFILLED:
                # A pre-roles worker served it whole — still a valid
                # answer (rolling upgrades must not 500).
                return 200, detail
            pf_wait = time.monotonic() - t_pf
            obs.histogram("router.prefill_wait_s").observe(pf_wait)
            status, obj = self._decode_phase(payload, rid, src, sp,
                                             pf_wait)
            if status is None:
                # Source lost mid-migration with nothing delivered:
                # restart the pipeline on another prefill replica.
                excluded.add(src.rid)
                failed_over = True
                if attempts >= self.cfg.route_retries:
                    return _typed(502, "migration_failed",
                                  f"migration source replica "
                                  f"{src.rid} lost and {attempts} "
                                  f"restart(s) exhausted: {obj}")
                attempts += 1
                self._count_retry(attempts)
                continue
            if status == 200 and failed_over:
                self._count_failover()
            return status, obj

    def _decode_phase(self, payload: dict, rid: str, src, sp,
                      pf_wait: float):
        """Phase two: hand the parked span to a decode-tier replica.
        -> ``(status, obj)``, or ``(None, why)`` to signal the caller
        to restart from prefill (the source is gone and the client has
        been handed nothing — a rerun cannot double-serve)."""
        tid = payload.get("trace_id")
        # The pull reference carries the trace too: the decode replica
        # forwards it on its /kv_export + /kv_ack POSTs to the source,
        # and its own install span adopts it.
        pull = {"port": src.port, "request_id": rid}
        if tid:
            pull["trace_id"] = tid
        body = json.dumps({**payload, "pull_from": pull}).encode()
        mig_retries = 0
        excluded: set = set()
        while True:
            decode_live = [r for r in self.sup.live_replicas()
                           if r.role != "prefill"
                           and r.rid not in excluded
                           and r.rid != src.rid]
            if not decode_live:
                return self._local_decode(rid, src, sp, pf_wait,
                                          "no live decode replica")
            t_dec = time.monotonic()
            outcome, detail, dst = self._dispatch_tier(decode_live, body,
                                                       trace_id=tid)
            if outcome == "all_full":
                return self._local_decode(
                    rid, src, sp, pf_wait,
                    f"all {detail} decode replica(s) at capacity")
            if outcome == "timeout":
                return _typed(504, "replica_timeout", detail)
            if outcome == "committed":
                return _typed(502, "replica_lost",
                              f"decode replica {dst.rid} lost after "
                              f"its response began: {detail}")
            if outcome == "lost":
                # Died before answering: the parked span survives at
                # the source (or was ACKed away, which the next pull
                # surfaces as a typed 424) — retry the migration on
                # another decode member.
                self.sup.note_forward_failure(dst.rid)
                excluded.add(dst.rid)
                if mig_retries >= self.cfg.route_retries:
                    return self._local_decode(
                        rid, src, sp, pf_wait,
                        f"{mig_retries} migration retr"
                        f"{'y' if mig_retries == 1 else 'ies'} "
                        f"exhausted: {detail}")
                mig_retries += 1
                self._count_retry(mig_retries)
                continue
            if outcome == "pass":
                status, obj = detail
                if status != 424:
                    return status, obj
                # Migration dependency failed. A dead source — or a
                # live one whose PARK is gone (typed park_lost: TTL,
                # drain, or an ACK to a puller that then died) — means
                # every further pull/resume is doomed: restart from
                # prefill now instead of sweeping the tier. Otherwise
                # retry the pull through another decode member, then
                # fall back.
                if (obj.get("error_type") == "park_lost"
                        or not self._src_live(src)):
                    return None, obj.get("error", "source lost")
                excluded.add(dst.rid)
                if mig_retries >= self.cfg.route_retries:
                    return self._local_decode(
                        rid, src, sp, pf_wait,
                        f"migration failed after {mig_retries} "
                        f"retr{'y' if mig_retries == 1 else 'ies'}: "
                        f"{obj.get('error')}")
                mig_retries += 1
                self._count_retry(mig_retries)
                continue
            # outcome == "ok"
            obj = detail
            dec_wait = (float(obj["ttft_s"])
                        if obj.get("ttft_s") is not None
                        else time.monotonic() - t_dec)
            obs.histogram("router.decode_wait_s").observe(dec_wait)
            mig = obj.get("migration")
            if isinstance(mig, dict):
                with self._ledger_lock:
                    self.migrations += 1
                    self.migration_bytes += int(mig.get("bytes", 0))
                    self.migration_seconds += float(
                        mig.get("seconds", 0.0))
                # The per-request queueing split rides in the response
                # (benchmarks read it client-side; the histograms above
                # carry the same numbers for run-dir artifacts).
                mig["prefill_wait_s"] = pf_wait
                mig["decode_wait_s"] = dec_wait
                sp.set(bytes=int(mig.get("bytes", 0)),
                       blocks=int(mig.get("blocks", 0)),
                       src=src.rid, dst=dst.rid)
            return 200, obj

    def _local_decode(self, rid: str, src, sp, pf_wait: float,
                      why: str):
        """The ``role=both`` degradation: no decode replica could take
        the migration, so the SOURCE resumes the parked request and
        decodes it locally. -> ``(status, obj)``, or ``(None, why)``
        when the source is gone / the park vanished — the caller
        restarts from prefill (nothing was delivered)."""
        with self._ledger_lock:
            self.migrate_fallbacks += 1
        obs.counter("router.migrate_fallbacks_total").inc()
        sp.set(degraded=why)
        tid, _ = obs.current_trace()
        outcome, detail = self._forward(
            src, json.dumps({"resume": rid}).encode(), trace_id=tid)
        if outcome == "ok":
            obj = detail
            dec_wait = (float(obj["ttft_s"])
                        if obj.get("ttft_s") is not None else 0.0)
            obs.histogram("router.decode_wait_s").observe(dec_wait)
            obj["migration"] = {"bytes": 0, "blocks": 0, "seconds": 0.0,
                                "fallback": why,
                                "prefill_wait_s": pf_wait,
                                "decode_wait_s": dec_wait}
            return 200, obj
        if outcome == "timeout":
            return _typed(504, "replica_timeout", detail)
        if outcome == "committed":
            return _typed(502, "replica_lost",
                          f"replica {src.rid} lost after its resumed "
                          f"response began: {detail}")
        if outcome == "pass":
            status, obj = detail
            if status in (404, 424):
                # The park vanished (TTL, drain) before the resume:
                # nothing was delivered — restart from prefill.
                return None, obj.get("error", "park lost")
            return status, obj
        if outcome == "full":
            why = (detail.get("error") if isinstance(detail, dict)
                   else detail)
            return _typed(503, "queue_full",
                          f"source replica {src.rid} refused the "
                          f"local-decode fallback: {why}")
        # outcome == "lost": the source died — restart from prefill.
        self.sup.note_forward_failure(src.rid)
        return None, f"local-decode fallback failed: {detail}"

    def _retry_backoff(self, attempt: int) -> float:
        base = min(self.cfg.retry_backoff_base_s * (2 ** (attempt - 1)),
                   self.cfg.retry_backoff_max_s)
        with self._rng_lock:
            return base * (0.5 + self._rng.random())   # ±50% jitter

    def _forward(self, r, body: bytes,
                 trace_id: Optional[str] = None) -> Tuple[str, object]:
        """One dispatch to one replica -> (outcome, detail):

        - ``("ok", result)`` — 200, the finished generation
        - ``("pass", (status, obj))`` — the replica's own 4xx, passed
          through untouched (a bad request is bad on every replica)
        - ``("full", obj)`` — 503 from the replica (queue full /
          draining): unavailable for THIS request, not dead
        - ``("lost", msg)`` — failed before any response byte (connect
          refused/reset, or the replica answered 5xx declaring the
          request failed without serving it) — retryable
        - ``("committed", msg)`` — failed AFTER the response began —
          not retryable
        - ``("timeout", msg)`` — no answer within
          ``forward_timeout_s`` — not retryable (slow != dead)
        """
        self.sup.add_in_flight(r.rid, +1)
        conn = http.client.HTTPConnection(
            "127.0.0.1", r.port, timeout=self.cfg.forward_timeout_s)
        committed = False
        headers = {"Content-Type": "application/json"}
        if trace_id:
            # The header twin of the payload's trace_id field: replica
            # front ends honor either, so a proxy that re-encodes the
            # body cannot strand the trace.
            headers[obs.TRACE_HEADER] = trace_id
        try:
            conn.request("POST", "/generate", body=body, headers=headers)
            resp = conn.getresponse()
            committed = True
            raw = resp.read()
            try:
                obj = json.loads(raw)
            except ValueError:
                obj = {"error": "replica returned non-JSON"}
            if resp.status == 200:
                return "ok", obj
            if resp.status == 503:
                return "full", obj
            if resp.status >= 500:
                return "lost", (f"replica {r.rid} answered "
                                f"{resp.status}: {obj.get('error')}")
            return "pass", (resp.status, obj)
        except socket.timeout:
            return "timeout", (f"replica {r.rid} gave no answer within "
                               f"{self.cfg.forward_timeout_s}s")
        except Exception as e:
            kind = "committed" if committed else "lost"
            return kind, f"{type(e).__name__}: {e}"
        finally:
            conn.close()
            self.sup.add_in_flight(r.rid, -1)


# ---------------------------------------------------------- HTTP front end
def run_front_end(router: Router, supervisor, port: int, *,
                  ready_cb=None, drain: Optional[threading.Event] = None,
                  drain_timeout_s: float = 30.0) -> int:
    """Serve the router over stdlib HTTP: POST ``/generate`` routes
    across replicas, GET ``/healthz`` reports the replica set. Setting
    ``drain`` (the signal handlers do) closes admission (POST -> 503
    "draining", ``/healthz`` -> 503) and runs the ROLLING drain —
    replicas stop one at a time, each finishing its in-flight work, so
    capacity never hits zero before the last one — then shuts the
    server down. Mirrors ``cli/serve.run_http``'s lifecycle contract
    (non-daemon handlers flush final responses; a second signal is
    ignored). ``ready_cb(server)`` gets the bound server, with the
    ``router`` and ``supervisor`` as its attributes."""
    import sys
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    drain = drain if drain is not None else threading.Event()
    stop = threading.Event()

    class Handler(BaseHTTPRequestHandler):
        timeout = 60

        def log_message(self, *a):
            pass

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                # Live fleet view: answered even while draining — the
                # operator watching a drain is exactly who curls this.
                return self._send(200, router.fleet_stats())
            if self.path == "/windows":
                # The mergeable JSON form of the fleet roll-up (what a
                # higher-tier aggregator would scrape).
                return self._send(200, router.fleet_windows())
            if self.path == "/metrics":
                # Prometheus text: fleet-merged sketches + deduped
                # cumulative totals (nezha-top's poll target).
                body = router.fleet_metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/healthz":
                return self._send(404, {"error": "unknown path"})
            live = supervisor.live_count()
            if drain.is_set():
                status = "draining"
            elif live == 0:
                status = "no live replicas"
            else:
                status = "ok"
            self._send(200 if status == "ok" else 503, {
                "status": status, "replicas_live": live,
                "replicas": supervisor.describe()})

        def do_POST(self):
            if self.path != "/generate":
                return self._send(404, {"error": "unknown path"})
            if drain.is_set():
                return self._send(*_typed(503, "draining", "draining"))
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
            except (ValueError, json.JSONDecodeError) as e:
                return self._send(*_typed(400, "bad_request", str(e)))
            if not isinstance(payload, dict):
                return self._send(*_typed(400, "bad_request",
                                          "request must be a JSON "
                                          "object"))
            # The fleet entry point honors the same header/field pair
            # the replica front ends do — an operator tagging a repro
            # request at the router traces under THEIR id, not a
            # freshly minted one.
            obs.adopt_trace_header(self.headers, payload)
            code, obj = router.route(payload)
            self._send(code, obj)

    class Server(ThreadingHTTPServer):
        daemon_threads = False    # flush final responses at shutdown

    server = Server(("127.0.0.1", port), Handler)

    def drain_watch():
        drain.wait()
        if not stop.is_set():
            with obs.span("router.drain",
                          replicas=len(supervisor.replicas())) as sp:
                supervisor.rolling_drain(drain_timeout_s)
                sp.set(replicas_live=supervisor.live_count())
            stop.set()
        server.shutdown()

    threading.Thread(target=drain_watch, daemon=True).start()
    # The embedding caller's handles on the fleet (its chaos hook:
    # ``server.supervisor.kill(rid)``).
    server.router, server.supervisor = router, supervisor
    if ready_cb is not None:
        ready_cb(server)
    print(f"nezha_tpu_torch.cli.serve router listening on http://127.0.0.1:"
          f"{server.server_address[1]} "
          f"({supervisor.cfg.replicas} replicas; POST /generate, "
          f"GET /healthz)", file=sys.stderr)
    try:
        server.serve_forever(poll_interval=0.1)
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        drain.set()     # unblock the watcher on non-signal exits
        server.server_close()
    return 0
