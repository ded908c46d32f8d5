"""Replica supervision for multi-replica serving.

One engine process is one failure domain: a crash kills every in-flight
request it holds (and, pre-scale-out, the whole service). The supervisor
turns N copies of the existing single-replica stack into a crowd the
front end (`serve/router.py`) can survive losing members of:

- **spawn** — each replica is the SAME single-replica serve CLI stack
  on its own port, launched through a pluggable backend:
  ``ProcessBackend`` runs ``python -m nezha_tpu_torch.cli.serve ... --http
  PORT`` subprocesses (production: a real OS failure domain, SIGTERM
  drains it, SIGKILL is a genuine crash), ``ThreadBackend`` hosts the
  same engine/scheduler stack in-process behind a real HTTP socket
  (tests and benchmarks: killable without paying a process spawn +
  torch import per replica — a kill severs its sockets, so the router
  observes the same connection resets a SIGKILLed process produces).
- **restart** — a replica that dies while it should be serving is
  respawned with capped exponential backoff (the retry-envelope
  idiom: base doubling to a cap, seeded ±50% jitter so a mass failure
  doesn't respawn in lockstep). Failures that never reach a healthy
  probe count consecutively; after ``max_restart_failures`` of them the
  replica's CIRCUIT BREAKER opens (state ``failed``) and the supervisor
  stops burning spawns on it — a replica that crashes at startup every
  time is a config problem, not a transient. Reaching healthy resets
  the count. Successful respawns count into
  ``router.replica_restarts_total`` (and :attr:`Supervisor.restarts`).
- **rolling drain** — SIGTERM at the front end drains replicas ONE AT A
  TIME: each gets a graceful drain (SIGTERM to a process — the worker's
  own drain semantics; the in-process worker's drain method for
  threads) and its full drain budget while every later replica keeps
  serving its in-flight work, so live capacity steps down N, N-1, ...,
  1, 0 and never hits zero before the last replica.

Health (probe misses, ejection, readmission) is the router's verdict,
stored here per replica so routing and lifecycle share one record under
one lock. Chaos enters through :meth:`Supervisor.kill` (the seeded
replica-kill knob the chaos tests drive) and through the fault points
``supervisor.spawn`` (a spawn attempt that fails before the backend
runs) and ``replica.exec`` (the worker crashes at startup — both the
subprocess entry and the thread worker route through
:func:`replica_exec_point`, keeping one registered site).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from nezha_tpu_torch import faults, obs

# Replica lifecycle states. healthy (the router's probe verdict) is a
# separate axis: only a LIVE + healthy replica is routable.
STARTING = "starting"    # spawned, not yet probed healthy
LIVE = "live"            # probed healthy at least once since spawn
DRAINING = "draining"    # rolling drain in progress on this replica
STOPPED = "stopped"      # drained/shut down deliberately — never restarted
DEAD = "dead"            # died; restart scheduled (next_restart_t)
FAILED = "failed"        # circuit breaker open — restarts exhausted


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Shared knobs for the supervisor + router pair (the scale-out
    analogue of ``ServeConfig``): how many replicas, how health is
    judged, how failures are retried, and how restarts back off.

    ``probe_misses`` consecutive failed /healthz probes eject a replica
    from routing (one success readmits it). ``route_retries`` bounds
    how many times one request may be re-dispatched after its replica
    died before answering; retry sleeps follow the envelope
    (``retry_backoff_base_s`` doubling to ``retry_backoff_max_s``,
    seeded ±50% jitter). ``forward_timeout_s`` bounds one replica
    answer — it must exceed the worst-case request latency, and a
    timeout is a typed error, never a retry (a slow replica is not a
    dead one, and re-dispatching its request would double-serve it).
    ``max_restart_failures`` consecutive spawn/startup failures open a
    replica's circuit breaker. ``drain_timeout_s`` is the per-replica
    budget of the rolling drain.

    ``roles`` assigns each replica a serving role for the disaggregated
    prefill/decode topology: ``()`` (default) makes every replica
    ``"both"`` (the classic homogeneous pool); otherwise it must name
    one of ``prefill`` / ``decode`` / ``both`` per replica. With at
    least one ``prefill`` member the router admits new requests onto
    the prefill tier and MIGRATES the finished prompt's KV to a decode
    replica (serve/migrate.py); ``both`` members belong to the decode
    tier and double as the local-decode degradation target."""

    replicas: int = 2
    roles: Tuple[str, ...] = ()
    probe_interval_s: float = 0.5
    probe_timeout_s: float = 5.0
    probe_misses: int = 3
    route_retries: int = 2
    retry_backoff_base_s: float = 0.05
    retry_backoff_max_s: float = 1.0
    forward_timeout_s: float = 120.0
    restart_backoff_base_s: float = 0.25
    restart_backoff_max_s: float = 5.0
    max_restart_failures: int = 5
    spawn_timeout_s: float = 300.0
    drain_timeout_s: float = 30.0
    seed: int = 0
    # Fleet-wide KV reuse (serve/fleetcache): route by prefix
    # affinity instead of pure least-loaded, using the trie digests
    # replicas piggyback on /healthz. digest_interval_s is the
    # replica-side rebuild cadence (the CLI forwards it to workers);
    # digest_max_entries bounds each digest's size on the wire.
    affinity_routing: bool = False
    digest_interval_s: float = 2.0
    digest_max_entries: int = 256
    # Elastic autoscaling: when BOTH bounds are set the monitor
    # scales the live replica count between them from fleet pressure —
    # average /healthz queue depth per live replica and the
    # router.prefill_wait_s p90 (the trace segment). A signal
    # must hold for autoscale_sustain_ticks consecutive monitor ticks
    # before acting, and actions are spaced by autoscale_cooldown_s —
    # the two-sided hysteresis that keeps a bursty queue from flapping
    # the fleet. Scale-up spawns through the machinery (a failed
    # spawn counts against that replica's circuit breaker); scale-down
    # rolling-drains ONE replica gracefully. None/None (default)
    # disables the loop entirely.
    autoscale_min: Optional[int] = None
    autoscale_max: Optional[int] = None
    autoscale_up_queue: float = 4.0      # queued per live replica
    autoscale_up_wait_s: float = 1.0     # prefill_wait p90 bound
    autoscale_sustain_ticks: int = 3
    autoscale_cooldown_s: float = 5.0

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.probe_misses < 1:
            raise ValueError("probe_misses must be >= 1")
        if self.route_retries < 0:
            raise ValueError("route_retries must be >= 0")
        if self.max_restart_failures < 1:
            raise ValueError("max_restart_failures must be >= 1")
        if self.digest_interval_s <= 0:
            raise ValueError("digest_interval_s must be > 0")
        if self.digest_max_entries < 1:
            raise ValueError("digest_max_entries must be >= 1")
        roles = tuple(self.roles)
        if roles:
            if len(roles) != self.replicas:
                raise ValueError(
                    f"roles names {len(roles)} replica(s), "
                    f"replicas={self.replicas}")
            bad = sorted(set(roles) - {"prefill", "decode", "both"})
            if bad:
                raise ValueError(
                    f"roles must be 'prefill'/'decode'/'both', got {bad}")
            if "prefill" in roles and not any(
                    r in ("decode", "both") for r in roles):
                raise ValueError(
                    "a prefill tier needs at least one decode-capable "
                    "replica (role 'decode' or 'both')")
        object.__setattr__(self, "roles", roles)
        if (self.autoscale_min is None) != (self.autoscale_max is None):
            raise ValueError(
                "autoscale needs BOTH bounds (autoscale_min and "
                "autoscale_max) or neither")
        if self.autoscale_max is not None:
            if self.autoscale_min < 1:
                raise ValueError("autoscale_min must be >= 1")
            if self.autoscale_max < self.autoscale_min:
                raise ValueError(
                    f"autoscale_max ({self.autoscale_max}) must be >= "
                    f"autoscale_min ({self.autoscale_min})")
            if not (self.autoscale_min <= self.replicas
                    <= self.autoscale_max):
                raise ValueError(
                    f"replicas={self.replicas} must start inside "
                    f"[autoscale_min, autoscale_max] = "
                    f"[{self.autoscale_min}, {self.autoscale_max}]")
            if roles:
                raise ValueError(
                    "autoscale requires a homogeneous pool — it cannot "
                    "grow/shrink a fixed roles topology")
            if self.autoscale_sustain_ticks < 1:
                raise ValueError("autoscale_sustain_ticks must be >= 1")
            if self.autoscale_cooldown_s < 0:
                raise ValueError("autoscale_cooldown_s must be >= 0")
            if self.autoscale_up_queue <= 0:
                raise ValueError("autoscale_up_queue must be > 0")
            if self.autoscale_up_wait_s <= 0:
                raise ValueError("autoscale_up_wait_s must be > 0")

    def role_of(self, rid: int) -> str:
        return self.roles[rid] if self.roles else "both"

    @property
    def autoscale_enabled(self) -> bool:
        """True when both elastic bounds are set — the monitor then
        runs the autoscale control loop every tick."""
        return self.autoscale_max is not None

    @property
    def disaggregated(self) -> bool:
        """True when the topology has a dedicated prefill tier — the
        router then admits onto it and migrates KV to the decode
        tier."""
        return "prefill" in self.roles

    @property
    def digest_stale_s(self) -> float:
        """How old a replica's digest may be (replica-reported age +
        time since its probe landed) before the affinity scorer
        ignores it — a few rebuild intervals, floored at a few probe
        rounds so slow probing doesn't blind the scorer entirely."""
        return max(3.0 * self.digest_interval_s,
                   4.0 * self.probe_interval_s)


def replica_exec_point() -> None:
    """The ``replica.exec`` fault point: hit once when a replica worker
    begins executing, BEFORE it builds its engine. Both worker hosts
    route through here — the subprocess entry (``cli/serve.run_worker``)
    and the in-process thread worker — keeping one registered call site
    (the fault-point checker requires names to be unique). An
    ``error`` rule makes the replica crash at startup: the drill behind
    the supervisor's restart backoff and circuit breaker."""
    faults.point("replica.exec")


def free_port() -> int:
    """An ephemeral localhost port. Bound-then-released, so a parallel
    process could steal it before the worker binds — the supervisor's
    restart path absorbs that exactly like any other startup failure."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class Replica:
    """One replica's record: lifecycle (supervisor's), health (router's
    probe verdict), and routing load — mutated only under the
    supervisor lock so the two layers can't disagree."""

    rid: int
    role: str = "both"          # prefill | decode | both (routing tier)
    state: str = STARTING
    handle: Optional[object] = None
    port: int = 0
    healthy: bool = False
    probe_misses: int = 0
    restart_failures: int = 0
    next_restart_t: float = 0.0
    spawned_t: float = 0.0
    in_flight: int = 0
    last_health: Dict[str, object] = dataclasses.field(default_factory=dict)
    # Monotonic timestamp of the last SUCCESSFUL probe (0.0 = never) —
    # the router's affinity scorer judges digest staleness against it.
    probed_t: float = 0.0
    error: Optional[str] = None


# ------------------------------------------------------------- backends
class ProcessHandle:
    """A replica hosted as an OS process."""

    def __init__(self, proc: subprocess.Popen, port: int):
        self.proc = proc
        self.port = port

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self) -> None:
        """Graceful: SIGTERM — the worker's own drain semantics
        (admission closes, in-flight finishes within its
        --drain-timeout, stragglers cancel as "deadline")."""
        if self.alive():
            try:
                self.proc.terminate()
            except OSError:
                pass

    def kill(self) -> None:
        """Abrupt: SIGKILL — the chaos/crash path. The OS closes the
        worker's sockets, so the router sees connection resets."""
        if self.alive():
            try:
                self.proc.kill()
            except OSError:
                pass

    def wait(self, timeout: float) -> bool:
        try:
            self.proc.wait(timeout=timeout)
            return True
        except subprocess.TimeoutExpired:
            return False


class ProcessBackend:
    """Spawn replicas as serve CLI subprocesses (the production
    backend): each runs the full single-replica stack via
    ``cli/serve.run_worker`` — the SAME code path ``--replicas 1``
    uses. ``argv_for`` maps ``(rid, port)`` to the worker argv
    (cli/serve.py builds it from the front end's own flags); stderr
    goes to ``log_dir/replica<rid>.log`` when given (the listening
    banner and tracebacks land there), else is inherited."""

    kind = "process"

    def __init__(self, argv_for: Callable[[int, int], List[str]],
                 env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None):
        self.argv_for = argv_for
        self.env = env
        self.log_dir = log_dir

    def spawn(self, rid: int, port: int) -> ProcessHandle:
        stderr = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stderr = open(os.path.join(self.log_dir,
                                       f"replica{rid}.log"), "ab")
        try:
            proc = subprocess.Popen(
                self.argv_for(rid, port), stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=stderr,
                env=self.env)
        finally:
            if stderr is not None:
                stderr.close()   # the child holds its own fd now
        return ProcessHandle(proc, port)


class ThreadHandle:
    """A replica hosted as an in-process worker thread."""

    def __init__(self, worker: "_ThreadWorker"):
        self.worker = worker
        self.port = worker.port

    def alive(self) -> bool:
        return not self.worker.dead.is_set()

    def terminate(self) -> None:
        self.worker.drain()

    def kill(self) -> None:
        self.worker.kill()

    def wait(self, timeout: float) -> bool:
        return self.worker.exited.wait(timeout)


class ThreadBackend:
    """Host replicas as in-process worker threads behind real HTTP
    sockets — the test/benchmark backend. Each replica still builds its
    OWN engine/scheduler from ``worker_args`` (the serve CLI's parsed
    namespace) and is reached over 127.0.0.1 exactly like a process
    replica, so the router code has ONE transport; what thread hosting
    trades away is OS-level isolation (a worker that corrupts the
    interpreter takes the house down — production uses
    :class:`ProcessBackend`). ``kill()`` severs the worker's open
    sockets before stopping it, so the router observes the same
    connection resets a SIGKILL produces."""

    kind = "thread"

    def __init__(self, worker_args, drain_timeout_s: float = 30.0,
                 roles: Optional[Sequence[str]] = None):
        self.worker_args = worker_args
        self.drain_timeout_s = drain_timeout_s
        self.roles = tuple(roles) if roles else ()

    def spawn(self, rid: int, port: int) -> ThreadHandle:
        # port is ignored: the worker binds port 0 and reports the real
        # one via the handle — no bind race to absorb.
        args = self.worker_args
        if self.roles:
            import copy
            args = copy.copy(args)
            args.role = self.roles[rid]
        worker = _ThreadWorker(args, rid,
                               drain_timeout_s=self.drain_timeout_s)
        worker.start()
        return ThreadHandle(worker)


# Engine builds (weights drawn from the seed, pools allocated, kernels
# built at first use) run one at a time: concurrent spawns stay
# deterministic and off each other's allocations.
_BUILD_LOCK = threading.Lock()


class _ThreadWorker:
    """One in-process replica: engine + scheduler + a /generate +
    /healthz HTTP server matching the ``cli/serve.run_http`` protocol,
    purpose-built to be KILLABLE (connection tracking, daemon handler
    threads, abrupt socket severing) — the properties an OS process
    gets for free and a thread has to engineer."""

    # Handler threads, the decode loop, and kill() all touch these —
    # declared for the lock-discipline lint.
    _LOCK_GUARDED = {"_events": "_events_lock", "_conns": "_conns_lock"}

    def __init__(self, worker_args, rid: int, drain_timeout_s: float):
        from http.server import ThreadingHTTPServer

        self.args = worker_args
        self.rid = rid
        self.drain_timeout_s = drain_timeout_s
        self.dead = threading.Event()     # worker finished, any cause
        self.exited = threading.Event()   # ... and released its engine
        self.crashed = False
        self._drain_evt = threading.Event()
        self._killed = threading.Event()
        self._ready = threading.Event()   # stack built, serving
        self._sched = None
        self._events: Dict[str, threading.Event] = {}
        self._events_lock = threading.Lock()
        self._conns = set()
        self._conns_lock = threading.Lock()

        worker = self

        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            timeout = 60

            def log_message(self, *a):
                pass

            def setup(self):
                super().setup()
                with worker._conns_lock:
                    worker._conns.add(self.connection)

            def finish(self):
                with worker._conns_lock:
                    worker._conns.discard(self.connection)
                try:
                    super().finish()
                except OSError:
                    pass    # connection already severed by kill()

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/stats":
                    # Live registry snapshot (stats schema v1) — the
                    # per-replica row of the router's fleet view.
                    # Thread workers share the process registry, so
                    # every member answers the same numbers (carrying
                    # the same registry_id, which the router's fleet
                    # roll-up dedupes on; the production process
                    # backend is per-process).
                    payload = obs.stats_snapshot()
                    payload["role"] = getattr(worker.args, "role",
                                              "both")
                    sched = worker._sched
                    if worker._ready.is_set() and sched is not None:
                        payload["tenants"] = sched.tenant_queue_depths()
                    return self._send(200, payload)
                if self.path == "/windows":
                    # Mergeable window views (sketch bucket counts
                    # ride along) — what the router scrapes for the
                    # fleet /metrics roll-up.
                    return self._send(200, obs.windows_payload())
                if self.path == "/metrics":
                    from nezha_tpu_torch.cli.serve import send_metrics
                    return send_metrics(self)
                if self.path != "/healthz":
                    return self._send(404, {"error": "unknown path"})
                if not worker._ready.is_set():
                    return self._send(503, {"status": "starting"})
                if worker._drain_evt.is_set() or worker._killed.is_set():
                    return self._send(503, {"status": "draining"})
                sched = worker._sched
                if sched is None:        # stopped: its engine is gone
                    return self._send(503, {"status": "stopped"})
                pool = sched.engine.pool
                payload = {
                    "status": "ok", "active": pool.num_active,
                    "capacity": pool.capacity,
                    "queued": sched.queue_depth,
                    "occupancy": pool.occupancy,
                    "role": getattr(worker.args, "role", "both"),
                    "parked": sched.parked_count,
                    # Per-tenant queue depths + suspended count
                    #: same surface run_http mounts, so the
                    # router sees one replica protocol.
                    "tenants": sched.tenant_queue_depths(),
                    "preempted": sched.preempted_count}
                # Fleet digest piggyback: the prober is the
                # transport — no extra endpoint, no extra round trip.
                payload.update(sched.fleet_digest(
                    getattr(worker.args, "digest_interval", 2.0),
                    getattr(worker.args, "digest_max_entries", 256)))
                self._send(200, payload)

            def do_POST(self):
                worker._handle_post(self)

        class Server(ThreadingHTTPServer):
            # Handlers are daemons here, unlike run_http: a killed
            # replica abandons its parked handlers by design (their
            # sockets are already severed), and non-daemon threads
            # would wedge interpreter exit.
            daemon_threads = True

            def handle_error(self, request, client_address):
                pass     # severed sockets raise in handlers — expected

        self._server = Server(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"nezha-replica-{rid}")

    def start(self) -> None:
        self._thread.start()

    # ---------------------------------------------------- request path
    def _handle_post(self, h) -> None:
        """Route one POST: ``/generate`` (plain, ``prefill_only``,
        ``pull_from``, or ``resume``) plus the migration endpoints
        ``/kv_export`` / ``/kv_ack`` — the same surface
        ``cli/serve.run_http`` mounts, so the router sees ONE replica
        protocol regardless of backend."""
        if h.path in ("/kv_export", "/kv_ack"):
            sched = self._sched
            if not self._ready.is_set() or sched is None:
                return h._send(503, {"error": "starting"})
            from nezha_tpu_torch.serve import migrate
            n = int(h.headers.get("Content-Length", 0))
            return h._send(*migrate.dispatch_kv_endpoint(
                sched, h.path, h.rfile.read(n)))
        self._handle_generate(h)

    def _handle_generate(self, h) -> None:
        if h.path != "/generate":
            return h._send(404, {"error": "unknown path"})
        if not self._ready.is_set():
            return h._send(503, {"error": "starting"})
        if self._drain_evt.is_set() or self._killed.is_set():
            return h._send(503, {"error": "draining"})
        from nezha_tpu_torch.cli.serve import _result_obj, parse_request
        from nezha_tpu_torch.serve import QueueFull, migrate
        sched = self._sched
        if sched is None:
            return h._send(503, {"error": "replica stopped"})
        try:
            n = int(h.headers.get("Content-Length", 0))
            obj = json.loads(h.rfile.read(n))
        except (ValueError, json.JSONDecodeError) as e:
            return h._send(400, {"error": str(e)})
        obs.adopt_trace_header(h.headers, obj)
        if isinstance(obj, dict) and obj.get("resume"):
            return self._handle_resume(h, str(obj["resume"]))
        mig_meta = None
        fleet_meta = None
        pull = obj.get("pull_from") if isinstance(obj, dict) else None
        if isinstance(pull, dict) and "tokens" in pull \
                and "request_id" not in pull:
            # Fleet peer pull: fetch covering prefix blocks
            # from the sibling the router named, then fall through to
            # ordinary admission so submit prefix-hits them. Failure
            # DEGRADES to a cold prefill — never an HTTP error; the
            # pull is an optimization, not a dependency.
            try:
                fleet_meta = migrate.pull_prefix_into(sched, pull)
            except migrate.MigrationError as e:
                fleet_meta = {"bytes": 0, "blocks": 0, "installed": 0,
                              "degraded": str(e), "error_type": e.kind}
        elif pull is not None:
            # Decode side of a migration: pull + install + ACK before
            # admission, so the submit below prefix-hits the installed
            # blocks. Failure is HTTP 424 — the router's retry signal.
            try:
                mig_meta = migrate.pull_into(sched, pull)
            except migrate.MigrationError as e:
                return h._send(424, {"error": str(e),
                                     "error_type": e.kind})
        try:
            req = parse_request(obj, self.args, sched.engine.vocab,
                                self._tokenizer, self._eos_id)
        except ValueError as e:
            return h._send(400, {"error": str(e)})
        import uuid
        rid = req.request_id or f"r{self.rid}-{uuid.uuid4().hex[:12]}"
        req.request_id = rid
        ev = threading.Event()
        with self._events_lock:
            if rid in self._events:
                return h._send(409, {"error": f"request id {rid!r} "
                                              f"already in flight"})
            self._events[rid] = ev
        try:
            sched.submit(req)
        except QueueFull as e:
            with self._events_lock:
                self._events.pop(rid, None)
            return h._send(503, {"error": str(e)})
        except ValueError as e:
            with self._events_lock:
                self._events.pop(rid, None)
            return h._send(400, {"error": str(e)})
        if self.dead.is_set():
            # TOCTOU guard (same race run_http closes): the worker
            # finished its final waiter sweep between the admission
            # check above — which ran before this request's body
            # finished uploading — and the submit. Nobody will ever
            # retire the request or set the event, so answer 503 now
            # instead of parking on ev.wait() forever.
            with self._events_lock:
                self._events.pop(rid, None)
            return h._send(503, {"error": "draining"})
        ev.wait()
        with self._events_lock:
            self._events.pop(rid, None)
        res = sched.results.pop(rid, None)
        if res is None:
            return h._send(503, {"error": "replica stopped"})
        out = _result_obj(res, self._tokenizer)
        out.pop("event")
        if mig_meta is not None:
            out["migration"] = mig_meta
        if fleet_meta is not None:
            out["fleet_pull"] = fleet_meta
        h._send(200, out)

    def _handle_resume(self, h, rid: str) -> None:
        """Local-decode fallback: move a parked request into this
        replica's live set and answer with its finished result — the
        ``role=both`` degradation the router takes when the decode
        tier is gone or every migration attempt failed."""
        from nezha_tpu_torch.cli.serve import _result_obj
        if self._drain_evt.is_set() or self._killed.is_set():
            return h._send(503, {"error": "draining"})
        sched = self._sched
        if sched is None:
            return h._send(503, {"error": "replica stopped"})
        ev = threading.Event()
        with self._events_lock:
            if rid in self._events:
                return h._send(409, {"error": f"request id {rid!r} "
                                              f"already in flight"})
            self._events[rid] = ev
        if not sched.resume_parked(rid):
            with self._events_lock:
                self._events.pop(rid, None)
            return h._send(404, {"error": f"request {rid!r} is not "
                                          f"parked here",
                                 "error_type": "migration_failed"})
        if self.dead.is_set():
            with self._events_lock:
                self._events.pop(rid, None)
            return h._send(503, {"error": "draining"})
        ev.wait()
        with self._events_lock:
            self._events.pop(rid, None)
        res = sched.results.pop(rid, None)
        if res is None:
            return h._send(503, {"error": "replica stopped"})
        out = _result_obj(res, self._tokenizer)
        out.pop("event")
        out["resumed"] = True
        h._send(200, out)

    # ------------------------------------------------------ worker body
    def _run(self) -> None:
        try:
            replica_exec_point()
            with _BUILD_LOCK:
                from nezha_tpu_torch.cli.serve import _build_stack
                sched, tokenizer, eos_id = _build_stack(self.args)
            self._tokenizer, self._eos_id = tokenizer, eos_id

            def on_finish(res):
                with self._events_lock:
                    ev = self._events.get(res.request_id)
                if ev is not None:
                    ev.set()

            sched.on_finish = on_finish
            self._sched = sched
            self._ready.set()
            threading.Thread(target=self._server.serve_forever,
                             kwargs={"poll_interval": 0.05},
                             daemon=True).start()
            # The decode loop runs on the engine's device.
            with sched._device():
                while (not self._killed.is_set()
                       and not self._drain_evt.is_set()):
                    if not sched.step():
                        time.sleep(0.002)
                if self._drain_evt.is_set() and not self._killed.is_set():
                    # Graceful drain: admission already closed (the
                    # handler checks the event); finish in-flight within
                    # the budget, cancel stragglers as "deadline".
                    t_end = time.monotonic() + self.drain_timeout_s
                    while (sched.has_work() and time.monotonic() < t_end
                           and not self._killed.is_set()):
                        if not sched.step():
                            time.sleep(0.002)
                    sched.cancel_remaining()
        except BaseException:
            self.crashed = True
        finally:
            self.dead.set()
            try:
                self._server.shutdown()
                self._server.server_close()
            except OSError:
                pass
            self._release_waiters()
            # Drop the engine, its pools and any pinned host arena: a
            # restart builds anew, so repeated kills must not pile up
            # device memory. A handler still finishing holds its own
            # reference until it answers.
            self._ready.clear()
            self._sched = None
            gc.collect()
            self.exited.set()

    def _release_waiters(self) -> None:
        sched = self._sched
        if sched is not None:
            try:
                from nezha_tpu_torch.serve import FinishReason
                sched.cancel_remaining(FinishReason.ERROR,
                                       error="replica stopped")
            except Exception:
                pass
        with self._events_lock:
            for ev in self._events.values():
                ev.set()

    # -------------------------------------------------------- lifecycle
    def drain(self) -> None:
        self._drain_evt.set()

    def kill(self) -> None:
        """Abrupt stop, modelled on SIGKILL: sever every open
        connection FIRST (the router observes resets, exactly like a
        killed process), then stop the decode loop and the server."""
        self._killed.set()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass
        self._release_waiters()


# ------------------------------------------------------------ supervisor
class Supervisor:
    """Owns the replica set: spawns it, restarts crashed members with
    capped seeded backoff (circuit breaker after
    ``cfg.max_restart_failures`` consecutive startup failures), and
    performs the rolling drain. The router reads/writes health and load
    through the accessor methods — every mutation happens under one
    lock. ``tick()`` is the monitor step; ``start()`` runs it on a
    background thread, tests may drive it directly."""

    tick_interval_s = 0.05

    # Cross-thread state -> guarding lock (the lock-discipline
    # lint's declaration): the monitor tick, the router's prober, and
    # HTTP handler threads all touch the replica records and ledgers.
    _LOCK_GUARDED = {"_replicas": "_lock", "_draining": "_lock",
                     "restarts": "_lock", "_rng": "_lock",
                     "_as_up_ticks": "_lock", "_as_down_ticks": "_lock",
                     "_as_cooldown_t": "_lock", "_as_target": "_lock"}

    def __init__(self, backend, cfg: RouterConfig):
        self.backend = backend
        self.cfg = cfg
        self._replicas = [Replica(rid=i, role=cfg.role_of(i))
                          for i in range(cfg.replicas)]
        self._lock = threading.RLock()
        self._rng = random.Random(cfg.seed)
        self._draining = False
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.restarts = 0     # obs counters only count inside a run;
        #                       this plain ledger always does
        # Elastic autoscale state: consecutive-tick pressure
        # counters (the sustain side of the hysteresis), the monotonic
        # time before which no further action may fire (the cooldown
        # side), and the current target scale the gauge reports.
        self._as_up_ticks = 0
        self._as_down_ticks = 0
        self._as_cooldown_t = 0.0
        self._as_target = cfg.replicas
        from nezha_tpu_torch.serve.router import register_router_instruments
        register_router_instruments()
        obs.gauge("router.autoscale_target").set(self._as_target)

    # ------------------------------------------------------- lifecycle
    def start(self) -> None:
        with self._lock:
            for r in self._replicas:
                try:
                    self._spawn(r)
                except Exception as e:
                    self._spawn_failed(r, e, time.monotonic())
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="nezha-supervisor")
        self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            self.tick()

    def tick(self) -> None:
        """One monitor step: notice deaths, time out wedged startups,
        perform restarts that have reached their backoff time."""
        now = time.monotonic()
        with self._lock:
            if self._draining:
                return
            for r in self._replicas:
                if r.state in (STARTING, LIVE) and not r.handle.alive():
                    self._note_death(r, now, "replica died")
                elif (r.state == STARTING
                        and now - r.spawned_t > self.cfg.spawn_timeout_s):
                    r.handle.kill()
                    self._note_death(r, now, "startup timed out")
                elif r.state == DEAD and now >= r.next_restart_t:
                    self._restart(r, now)
        if self.cfg.autoscale_enabled:
            self.autoscale_tick(now)

    def shutdown(self) -> None:
        """Stop the monitor and kill whatever is still running (the
        abrupt teardown — :meth:`rolling_drain` is the graceful one)."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        with self._lock:
            self._draining = True
            for r in self._replicas:
                if r.handle is not None and r.state not in (STOPPED,
                                                            FAILED):
                    r.handle.kill()
                    r.state = STOPPED
                r.healthy = False
            self._update_live_gauge()

    # ------------------------------------------------------- internals
    def _spawn(self, r: Replica) -> None:
        """[holds: _lock] Raises on spawn failure (callers route the
        exception into the backoff/breaker accounting)."""
        faults.point("supervisor.spawn")
        port = free_port()
        r.handle = self.backend.spawn(r.rid, port)
        r.port = getattr(r.handle, "port", port)
        r.state = STARTING
        r.healthy = False
        r.probe_misses = 0
        r.spawned_t = time.monotonic()
        r.error = None

    def _spawn_failed(self, r: Replica, e: Exception, now: float) -> None:
        """[holds: _lock]"""
        r.restart_failures += 1
        r.error = f"spawn failed: {type(e).__name__}: {e}"
        if r.restart_failures >= self.cfg.max_restart_failures:
            r.state = FAILED
            print(f"supervisor: replica {r.rid} circuit breaker OPEN "
                  f"after {r.restart_failures} consecutive failures "
                  f"({r.error})", file=sys.stderr)
        else:
            r.state = DEAD
            r.next_restart_t = now + self._restart_backoff(
                r.restart_failures)

    def _note_death(self, r: Replica, now: float, why: str) -> None:
        """[holds: _lock]"""
        # Only deaths that never reached a healthy probe count toward
        # the breaker: a replica that serves and then gets killed is
        # RECOVERING each time, not failing to start.
        if r.state == STARTING:
            r.restart_failures += 1
        r.healthy = False
        r.error = why
        if r.restart_failures >= self.cfg.max_restart_failures:
            r.state = FAILED
            print(f"supervisor: replica {r.rid} circuit breaker OPEN "
                  f"after {r.restart_failures} consecutive startup "
                  f"failures", file=sys.stderr)
        else:
            r.state = DEAD
            r.next_restart_t = now + self._restart_backoff(
                r.restart_failures)
        self._update_live_gauge()

    def _restart(self, r: Replica, now: float) -> None:
        """[holds: _lock] — tick() performs restarts inside the lock."""
        try:
            self._spawn(r)
        except Exception as e:
            self._spawn_failed(r, e, now)
            return
        self.restarts += 1
        obs.counter("router.replica_restarts_total").inc()

    def _restart_backoff(self, failures: int) -> float:
        """[holds: _lock] — the seeded RNG stream is shared state."""
        base = min(self.cfg.restart_backoff_base_s * (2 ** failures),
                   self.cfg.restart_backoff_max_s)
        return base * (0.5 + self._rng.random())   # ±50% seeded jitter

    def _update_live_gauge(self) -> None:
        obs.gauge("router.replicas_live").set(sum(
            1 for r in self._replicas if r.state == LIVE and r.healthy))

    # ------------------------------------------------- router interface
    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def live_replicas(self) -> List[Replica]:
        with self._lock:
            return [r for r in self._replicas
                    if r.state == LIVE and r.healthy]

    def live_count(self) -> int:
        return len(self.live_replicas())

    def describe(self) -> List[dict]:
        """The replica table ``/healthz`` reports; a process replica's row
        carries its ``pid``."""
        with self._lock:
            rows = []
            for r in self._replicas:
                row = {"rid": r.rid, "role": r.role, "port": r.port,
                       "state": r.state, "healthy": r.healthy,
                       "in_flight": r.in_flight,
                       "restart_failures": r.restart_failures}
                proc = getattr(r.handle, "proc", None)
                if proc is not None:
                    row["pid"] = proc.pid
                rows.append(row)
            return rows

    def mark_probe(self, rid: int, ok: bool,
                   payload: Optional[dict] = None) -> None:
        """The prober's verdict for one replica: a success readmits it
        (and promotes STARTING -> LIVE, resetting the breaker count);
        ``cfg.probe_misses`` consecutive failures eject it."""
        with self._lock:
            r = self._replicas[rid]
            if r.state not in (STARTING, LIVE):
                return
            if ok:
                r.probe_misses = 0
                r.last_health = dict(payload or {})
                r.probed_t = time.monotonic()
                r.healthy = True
                if r.state == STARTING:
                    r.state = LIVE
                    r.restart_failures = 0
            else:
                r.probe_misses += 1
                if r.healthy and r.probe_misses >= self.cfg.probe_misses:
                    r.healthy = False    # ejected until a probe succeeds
            self._update_live_gauge()

    def note_forward_failure(self, rid: int) -> None:
        """A forward died on the wire — stronger evidence than a missed
        probe, so the replica is ejected immediately; the prober
        readmits it the moment it answers again."""
        with self._lock:
            r = self._replicas[rid]
            r.healthy = False
            r.probe_misses = max(r.probe_misses, self.cfg.probe_misses)
            self._update_live_gauge()

    def add_in_flight(self, rid: int, delta: int) -> None:
        with self._lock:
            self._replicas[rid].in_flight += delta

    # ------------------------------------------------------------ chaos
    def kill(self, rid: int) -> None:
        """Hard-kill one replica (chaos): its sockets sever, in-flight
        forwards fail, and the monitor restarts it with backoff."""
        with self._lock:
            handle = self._replicas[rid].handle
        if handle is not None:
            handle.kill()

    # -------------------------------------------------------- autoscale
    def autoscale_target(self) -> int:
        with self._lock:
            return self._as_target

    def autoscale_tick(self, now: Optional[float] = None
                       ) -> Optional[str]:
        """One elastic control step: read fleet pressure —
        total /healthz-reported queue depth per live replica, plus the
        ``router.prefill_wait_s`` p90 trace segment — and scale the
        replica count within ``[autoscale_min, autoscale_max]``.
        Two-sided hysteresis: a signal must hold for
        ``autoscale_sustain_ticks`` CONSECUTIVE ticks (a mixed reading
        resets both counters — the deadband), actions are spaced by
        ``autoscale_cooldown_s``, and exactly one replica moves per
        action. The ``supervisor.scale`` fault point fires at the
        decision: an injected error is the typed degradation drill —
        the action is skipped, pressure re-evaluates next tick, and the
        fleet stays at its current size. Returns "up"/"down"/None so
        tests can assert the ladder without timing games."""
        cfg = self.cfg
        if not cfg.autoscale_enabled:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._draining:
                return None
            active = [r for r in self._replicas
                      if r.state not in (STOPPED, FAILED)]
            live = [r for r in active
                    if r.state == LIVE and r.healthy]
            queued = sum(int((r.last_health or {}).get("queued", 0))
                         for r in live)
            per_live = queued / max(1, len(live))
            wait_p90 = obs.histogram(
                "router.prefill_wait_s").percentile(90)
            hot = (per_live >= cfg.autoscale_up_queue
                   or (wait_p90 is not None
                       and wait_p90 >= cfg.autoscale_up_wait_s))
            idle = (queued == 0 and live
                    and all(r.in_flight == 0 for r in live))
            if hot:
                self._as_up_ticks += 1
                self._as_down_ticks = 0
            elif idle:
                self._as_down_ticks += 1
                self._as_up_ticks = 0
            else:
                # Deadband: neither hot nor fully idle — hold scale and
                # make BOTH signals re-earn their sustain run.
                self._as_up_ticks = 0
                self._as_down_ticks = 0
            obs.gauge("router.autoscale_target").set(self._as_target)
            if now < self._as_cooldown_t:
                return None
            n = len(active)
            decision = None
            if (self._as_up_ticks >= cfg.autoscale_sustain_ticks
                    and n < cfg.autoscale_max):
                decision = "up"
            elif (self._as_down_ticks >= cfg.autoscale_sustain_ticks
                    and n > cfg.autoscale_min):
                decision = "down"
            if decision is None:
                return None
            try:
                faults.point("supervisor.scale")
            except Exception:
                return None
            self._as_up_ticks = 0
            self._as_down_ticks = 0
            self._as_cooldown_t = now + cfg.autoscale_cooldown_s
            self._as_target = n + 1 if decision == "up" else n - 1
            obs.gauge("router.autoscale_target").set(self._as_target)
            if decision == "up":
                self._scale_up(now)
                return "up"
            # Scale-down: gracefully drain the HIGHEST-rid active
            # replica (LIFO keeps the stable base of the fleet the
            # long-lived members) on its own thread — the per-replica
            # drain blocks up to the drain budget and must not stall
            # the monitor loop.
            victim = active[-1]
            victim.state = DRAINING
        threading.Thread(
            target=self._drain_one,
            args=(victim, cfg.drain_timeout_s),
            daemon=True, name=f"nezha-scale-down-{victim.rid}").start()
        return "down"

    def _scale_up(self, now: float) -> None:
        """[holds: _lock] Add one replica: re-arm a previously drained
        (STOPPED) record if one exists — keeping the rid==index
        invariant the router's ledgers rely on — else append a fresh
        one. Spawn failures route into the backoff/breaker
        accounting exactly like a restart."""
        r = next((x for x in self._replicas if x.state == STOPPED), None)
        if r is None:
            r = Replica(rid=len(self._replicas), role="both")
            self._replicas.append(r)
        else:
            r.restart_failures = 0
        try:
            self._spawn(r)
        except Exception as e:
            self._spawn_failed(r, e, now)

    # ------------------------------------------------------------ drain
    def _drain_one(self, r: Replica,
                   timeout_s: float,
                   progress: Optional[Callable[[int], None]] = None
                   ) -> None:
        """Gracefully stop ONE replica: graceful terminate, up to
        ``timeout_s`` for its in-flight work, then the hard stop — the
        per-replica body both :meth:`rolling_drain` and the autoscale
        scale-down share. Safe to call with the replica already marked
        DRAINING (the scale-down path does, inside its decision
        lock)."""
        with self._lock:
            handle = r.handle
            if r.state in (STOPPED, FAILED) or handle is None:
                return
            r.state = DRAINING
            self._update_live_gauge()
        if handle.alive():
            handle.terminate()
            # The worker runs its own drain inside; +5s covers its
            # shutdown tail so a healthy drain never gets killed at
            # exactly the budget.
            if not handle.wait(timeout_s + 5.0):
                handle.kill()
                handle.wait(5.0)
        with self._lock:
            r.state = STOPPED
            r.healthy = False
            self._update_live_gauge()
        if progress is not None:
            progress(self.live_count())

    def rolling_drain(self, timeout_s: Optional[float] = None,
                      progress: Optional[Callable[[int], None]] = None
                      ) -> None:
        """Drain replicas ONE AT A TIME: each gets a graceful stop and
        up to ``timeout_s`` (default ``cfg.drain_timeout_s``) to finish
        its in-flight work while every later replica keeps serving — so
        live capacity steps down one replica per round and only reaches
        zero when the last one exits. Restarts are frozen for the
        duration. ``progress(live_count)`` fires after each replica
        stops (tests assert the never-zero-mid-drain ladder with it)."""
        timeout_s = (self.cfg.drain_timeout_s if timeout_s is None
                     else timeout_s)
        with self._lock:
            self._draining = True
        for r in self._replicas:
            self._drain_one(r, timeout_s, progress)
