"""The port's fleet (``serve/router.py``, ``serve/supervisor.py``, the serve
CLI's ``run_multi``) on the CPU, tiny preset, f32 pools: weights from a
JAX tiny model saved as an npz checkpoint, loaded by every replica with
``--ckpt-dir``.

- a thread fleet of two replicas answers every request with JAX's
  single-engine greedy tokens, and one of a prefill and a decode replica
  with JAX's migrated ones (its park, export, wire, install and decode in
  one process: the wire is int8, lossy over float pools in both
  packages);
  the fleet ``/stats`` counts each shared registry once, JAX's schema
  checks pass on it, on ``/metrics`` and on the run dir;
- a replica killed mid-traffic loses no request (200 or the typed
  ``replica_lost``), and the supervisor restarts it;
- retries are bounded, their backoff seeded (JAX's sequence), and the
  typed errors come through;
- a replica that crashes at ``replica.exec`` opens its circuit breaker
  after ``max_restart_failures``;
- the rolling drain steps live capacity down one replica at a time;
- the process backend (``--device cpu``): kill, restart and serve again,
  with the front end never touching ``torch.cuda``; a thread worker and
  a process worker give the same ``/generate`` answer;
- the fleet flags take JAX's defaults and choices; ``_worker_argv``."""

import http.client
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.analysis.telemetry_schema import (check_metrics_exposition,
                                                 check_run_dir,
                                                 check_stats_payload)
from nezha_tpu.cli.serve import build_parser as jax_build_parser
from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.serve import Engine as JaxEngine
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu.serve import migrate as jax_migrate
from nezha_tpu.serve.router import Router as JaxRouter
from nezha_tpu.serve.supervisor import RouterConfig as JaxRouterConfig
from nezha_tpu.train import checkpoint as jax_ckpt
from nezha_tpu_torch import faults
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.faults import FaultPlan
from nezha_tpu_torch.serve.router import Router
from nezha_tpu_torch.serve.supervisor import (FAILED, LIVE, ProcessBackend,
                                              Replica, RouterConfig,
                                              Supervisor, ThreadBackend,
                                              free_port)

SERVE_KW = dict(max_batch_size=2, max_len=64, max_prefill_len=16,
                kv_block_size=8)
PROMPTS = [[(7 * i + 3 + 11 * s) % 512 for i in range(n)]
           for s, n in enumerate((5, 21, 9, 30, 14, 17))]
NEW = 6


def _lively(tree, rng):
    """Scaled-up weights: the small init repeats one token."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _lively(val, rng)
        elif key == "scale":
            out[key] = jnp.asarray(1 + 0.2 * rng.randn(*val.shape),
                                   jnp.float32)
        elif key in ("bias", "b"):
            out[key] = jnp.asarray(0.1 * rng.randn(*val.shape), jnp.float32)
        else:
            out[key] = val * 8
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """-> (checkpoint dir, JAX's single-engine greedy tokens by prompt,
    JAX's migrated ones)."""
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW))
    jv = jm.init(jax.random.PRNGKey(0))
    jv = {"params": _lively(jv["params"], np.random.RandomState(0)),
          "state": jv["state"]}
    d = tmp_path_factory.mktemp("fleet_ckpt")
    jax_ckpt.save_checkpoint(str(d), {"variables": jv}, 1)
    sched = JaxScheduler(JaxEngine(jm, jv, JaxServeConfig(
        **SERVE_KW, cache_dtype=jnp.float32)))
    for i, p in enumerate(PROMPTS):
        sched.submit(JaxRequest(prompt=p, max_new_tokens=NEW,
                                request_id=f"j{i}"))
    sched.run_until_idle()
    want = {tuple(p): sched.results[f"j{i}"].tokens
            for i, p in enumerate(PROMPTS)}
    assert len({tuple(t) for t in want.values()}) > 1
    dst = JaxScheduler(JaxEngine(jm, jv, JaxServeConfig(
        **SERVE_KW, cache_dtype=jnp.float32)))
    migrated = {}
    for i, p in enumerate(PROMPTS):
        rid = f"m{i}"
        sched.submit(JaxRequest(prompt=p, max_new_tokens=NEW,
                                request_id=rid, prefill_only=True))
        sched.run_until_idle()
        wire = json.loads(json.dumps(sched.export_parked(rid)))
        dst.install_migrated(*jax_migrate.decode_wire(wire))
        sched.ack_parked(rid)
        dst.submit(JaxRequest(prompt=p, max_new_tokens=NEW, request_id=rid))
        dst.run_until_idle()
        migrated[tuple(p)] = dst.results[rid].tokens
    return str(d), want, migrated


def _argv(ckpt_dir, *extra):
    return ["--ckpt-dir", ckpt_dir, "--model-preset", "tiny", "--device",
            "cpu", "--cache-dtype", "f32", "--max-batch-size", "2",
            "--max-len", "64", "--max-prefill-len", "16", "--kv-block-size",
            "8", "--http", "0", "--probe-interval", "0.05",
            "--restart-backoff", "0.05", "--digest-interval", "0.05",
            "--drain-timeout", "5", *extra]


class Fleet:
    """``serve_cli.run`` in a thread: the front end's port, its
    supervisor and router, and the drain."""

    def __init__(self, argv):
        self.args = serve_cli.build_parser().parse_args(argv)
        ready, self.drain, self.box = (threading.Event(), threading.Event(),
                                       {})

        def cb(server):
            self.box["server"] = server
            ready.set()

        self.thread = threading.Thread(target=lambda: self.box.update(
            rc=serve_cli.run(self.args, ready_cb=cb,
                             drain_event=self.drain)), daemon=True)
        self.thread.start()
        assert ready.wait(120), "front end did not start"
        srv = self.box["server"]
        self.port = srv.server_address[1]
        self.sup, self.router = srv.supervisor, srv.router
        assert self.router.wait_live(len(self.sup.replicas()), 60)

    def close(self):
        self.drain.set()
        self.thread.join(60)
        assert not self.thread.is_alive()
        return self.box.get("rc")


def _post(port, obj, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate", body=json.dumps(obj).encode())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        return resp.status, body
    finally:
        conn.close()


def _post_all(port, bodies):
    out = [None] * len(bodies)

    def post(i):
        out[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return out


def _wait(pred, timeout=30.0):
    t_end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < t_end, "timed out"
        time.sleep(0.005)


# ----------------------------------------------------------- parity
@pytest.mark.parametrize("topology", ["replicas2", "disagg1+1"])
def test_thread_fleet_gives_jax_single_engine_tokens(jax_run, topology,
                                                     tmp_path):
    ckpt_dir, single, migrated = jax_run
    want = single if topology == "replicas2" else migrated
    extra = (["--replicas", "2"] if topology == "replicas2" else
             ["--prefill-replicas", "1", "--decode-replicas", "1"])
    run_dir = tmp_path / "run"
    fleet = Fleet(_argv(ckpt_dir, "--replica-backend", "thread",
                        "--run-dir", str(run_dir), *extra))
    try:
        got = _post_all(fleet.port, [
            {"id": f"r{i}", "prompt_tokens": p, "max_new_tokens": NEW}
            for i, p in enumerate(PROMPTS)])
        for p, (code, ans) in zip(PROMPTS, got):
            assert code == 200, ans
            assert ans["tokens"] == want[tuple(p)]
            if topology != "replicas2":
                assert "fallback" not in ans["migration"]
        code, body = _get(fleet.port, "/stats")
        stats = json.loads(body)
        assert code == 200 and check_stats_payload(stats) == []
        assert stats["kind"] == "fleet" and len(stats["replicas"]) == 2
        # Thread members share this process's registry: counted once.
        assert stats["fleet"]["counters"]["serve.tokens_total"] == \
            NEW * len(PROMPTS)
        code, text = _get(fleet.port, "/metrics")
        assert code == 200 and check_metrics_exposition(text) == []
        router = fleet.router
        assert (router.retries, router.failovers, fleet.sup.restarts) == (
            0, 0, 0)
        if topology != "replicas2":
            # Every pull commits; a sub-block prompt moves no block.
            assert router.migrations == len(PROMPTS)
            assert [ans["migration"]["installed"] > 0 for _, ans in got] \
                == [len(p) >= 8 for p in PROMPTS]
            assert router.migrate_fallbacks == 0
            pre = fleet.sup.replicas()[0].handle.worker._sched
            assert pre.parked_count == 0
        for r in fleet.sup.replicas():
            sched = r.handle.worker._sched
            with sched._lock:
                sched.engine.pool.leak_check()
    finally:
        assert fleet.close() == 0
    assert check_run_dir(str(run_dir)) == []
    spans = [json.loads(x)["name"] for x in
             (run_dir / "spans.jsonl").read_text().splitlines()]
    assert spans.count("router.request") == len(PROMPTS)
    if topology != "replicas2":
        assert spans.count("router.migrate") == len(PROMPTS)
    assert "router.drain" in spans


def _slow(sched, seconds):
    inner = sched.step

    def step():
        time.sleep(seconds)
        return inner()

    sched.step = step


def test_kill_mid_traffic_loses_no_request(jax_run):
    ckpt_dir, want, _ = jax_run
    fleet = Fleet(_argv(ckpt_dir, "--replica-backend", "thread",
                        "--replicas", "2", "--affinity-routing", "off"))
    try:
        victim = fleet.sup.replicas()[0]
        for r in fleet.sup.replicas():
            _slow(r.handle.worker._sched, 0.02)
        out = [None]
        traffic = threading.Thread(target=lambda: out.__setitem__(
            0, _post_all(fleet.port, [
                {"id": f"k{i}", "prompt_tokens": p, "max_new_tokens": NEW}
                for i, p in enumerate(PROMPTS[:4])])))
        traffic.start()
        _wait(lambda: victim.handle.worker._sched is not None
              and victim.handle.worker._sched.engine.pool.num_active > 0)
        fleet.sup.kill(0)
        traffic.join(120)
        for p, (code, ans) in zip(PROMPTS, out[0]):
            if code == 200:
                assert ans["tokens"] == want[tuple(p)]
            else:
                assert (code, ans["error_type"]) == (502, "replica_lost")
        assert fleet.router.retries >= 1 and fleet.router.failovers >= 1
        _wait(lambda: fleet.sup.restarts == 1
              and fleet.sup.live_count() == 2)
        code, ans = _post(fleet.sup.replicas()[0].port, {
            "id": "again", "prompt_tokens": PROMPTS[1],
            "max_new_tokens": NEW})
        assert code == 200 and ans["tokens"] == want[tuple(PROMPTS[1])]
    finally:
        assert fleet.close() == 0


# ------------------------------------------------------ retries, errors
class _Dead:
    """A supervisor of replicas that refuse every connection."""

    def __init__(self, n, cfg):
        self.cfg = cfg
        self.reps = [Replica(rid=i, state=LIVE, healthy=True,
                             port=free_port()) for i in range(n)]
        self.failures = []

    def replicas(self):
        return list(self.reps)

    def live_replicas(self):
        return [r for r in self.reps if r.healthy]

    def live_count(self):
        return len(self.live_replicas())

    def note_forward_failure(self, rid):
        self.failures.append(rid)

    def add_in_flight(self, rid, delta):
        self.reps[rid].in_flight += delta


@pytest.mark.parametrize("retries", [0, 1, 2])
def test_retries_are_bounded_seeded_and_typed(retries):
    kw = dict(replicas=3, route_retries=retries, retry_backoff_base_s=0.01,
              retry_backoff_max_s=0.02, seed=5)
    cfg = RouterConfig(**kw)
    sup = _Dead(3, cfg)
    router = Router(sup, cfg)
    code, obj = router.route({"id": "x", "prompt_tokens": [1, 2, 3]})
    assert (code, obj["error_type"]) == (502, "replica_lost")
    assert router.retries == retries and router.failovers == 0
    assert len(sup.failures) == retries + 1
    assert len(set(sup.failures)) == retries + 1   # never the same twice
    # The backoff's jitter is JAX's seeded stream.
    mine = Router(_Dead(1, cfg), cfg)
    theirs = JaxRouter(_Dead(1, JaxRouterConfig(**kw)),
                       JaxRouterConfig(**kw))
    assert [mine._retry_backoff(a) for a in (1, 2, 3, 1)] == [
        theirs._retry_backoff(a) for a in (1, 2, 3, 1)]
    for r in sup.reps:
        r.healthy = False
    code, obj = router.route({"prompt_tokens": [1]})
    assert (code, obj["error_type"]) == (503, "no_live_replicas")


def test_injected_route_fault_is_typed():
    cfg = RouterConfig(replicas=1)
    router = Router(_Dead(1, cfg), cfg)
    faults.install(FaultPlan.parse("router.route:error@1"))
    try:
        code, obj = router.route({"prompt_tokens": [1]})
    finally:
        faults.clear()
    assert (code, obj["error_type"]) == (500, "injected_fault")


def test_replica_exec_crash_opens_the_circuit_breaker(jax_run):
    ckpt_dir, _, _ = jax_run
    wargs = serve_cli.build_parser().parse_args(_argv(ckpt_dir))
    cfg = RouterConfig(replicas=1, restart_backoff_base_s=0.001,
                       restart_backoff_max_s=0.002, max_restart_failures=3)
    sup = Supervisor(ThreadBackend(wargs, drain_timeout_s=1.0), cfg)
    faults.install(FaultPlan.parse("replica.exec:error@1x*"))
    try:
        sup.start()
        _wait(lambda: sup.replicas()[0].state == FAILED, 30)
        rep = sup.replicas()[0]
        assert rep.restart_failures == 3 and sup.restarts == 2
        assert faults.active().injected_counts["replica.exec"] == 3
        code, obj = Router(sup, cfg).route({"prompt_tokens": [1]})
        assert (code, obj["error_type"]) == (503, "no_live_replicas")
    finally:
        faults.clear()
        sup.shutdown()


def test_rolling_drain_never_reaches_zero_early(jax_run):
    ckpt_dir, _, _ = jax_run
    wargs = serve_cli.build_parser().parse_args(_argv(ckpt_dir))
    cfg = RouterConfig(replicas=3, probe_interval_s=0.05)
    sup = Supervisor(ThreadBackend(wargs, drain_timeout_s=1.0), cfg)
    router = Router(sup, cfg)
    sup.start()
    try:
        assert router.wait_live(3, 60)
        ladder = []
        sup.rolling_drain(2.0, progress=ladder.append)
        assert ladder == [2, 1, 0]
        assert all(r.state == "stopped" for r in sup.replicas())
    finally:
        sup.shutdown()


# ------------------------------------------------------- process backend
def test_process_fleet_kill_restart_and_serve(jax_run, monkeypatch):
    ckpt_dir, want, _ = jax_run

    def no_cuda(*a, **k):
        raise AssertionError("the front end touched torch.cuda")

    for name in ("_lazy_init", "init", "is_available", "device_count",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    fleet = Fleet(_argv(ckpt_dir, "--replicas", "2"))
    try:
        assert fleet.sup.backend.kind == "process"
        pid0 = fleet.sup.replicas()[0].handle.proc.pid
        code, ans = _post(fleet.port, {"prompt_tokens": PROMPTS[3],
                                       "max_new_tokens": NEW})
        assert code == 200 and ans["tokens"] == want[tuple(PROMPTS[3])]
        fleet.sup.kill(0)
        _wait(lambda: fleet.sup.restarts == 1
              and fleet.sup.live_count() == 2, 60)
        rep = fleet.sup.replicas()[0]
        assert rep.handle.proc.pid != pid0
        code, ans = _post(rep.port, {"prompt_tokens": PROMPTS[2],
                                     "max_new_tokens": NEW})
        assert code == 200 and ans["tokens"] == want[tuple(PROMPTS[2])]
        code, body = _get(fleet.port, "/healthz")
        rows = json.loads(body)["replicas"]
        assert [r["pid"] for r in rows] == [
            r.handle.proc.pid for r in fleet.sup.replicas()]
    finally:
        assert fleet.close() == 0
    assert all(r.handle.proc.poll() is not None
               for r in fleet.sup.replicas())


def _wait_healthy(port):
    def ok():
        try:
            return _get(port, "/healthz")[0] == 200
        except OSError:
            return False

    _wait(ok, 60)


def test_thread_and_process_workers_answer_alike(jax_run):
    ckpt_dir, want, _ = jax_run
    args = serve_cli.build_parser().parse_args(_argv(ckpt_dir))
    wargs = serve_cli.build_parser().parse_args(_argv(ckpt_dir))
    wargs.http = None
    port = free_port()
    proc = ProcessBackend(lambda rid, p: serve_cli._worker_argv(
        args, rid, p)).spawn(0, port)
    thread = ThreadBackend(wargs).spawn(0, 0)
    try:
        _wait_healthy(port)
        _wait_healthy(thread.port)
        body = {"id": "same", "prompt_tokens": PROMPTS[4],
                "max_new_tokens": NEW, "temperature": 0.9, "seed": 3}
        a = _post(port, body)
        b = _post(thread.port, body)
        assert a[0] == b[0] == 200
        for k in ("id", "tokens", "text", "finish_reason"):
            assert a[1][k] == b[1][k]
        body["temperature"] = 0.0
        assert _post(port, body)[1]["tokens"] == want[tuple(PROMPTS[4])]
    finally:
        proc.kill()
        thread.kill()
        proc.wait(30)
        thread.wait(30)


# ------------------------------------------------------------- the flags
FLEET_FLAGS = ["replicas", "prefill_replicas", "decode_replicas",
               "replica_backend", "probe_interval", "probe_misses",
               "route_retries", "restart_backoff", "max_restart_failures",
               "affinity_routing", "digest_interval", "digest_max_entries",
               "trace_sample", "run_dir", "slo", "watchdog_interval",
               "autoscale_min", "autoscale_max"]


@pytest.mark.parametrize("flag", FLEET_FLAGS)
def test_fleet_flags_take_jax_defaults_and_choices(flag):
    mine = {a.dest: a for a in serve_cli.build_parser()._actions}[flag]
    theirs = {a.dest: a for a in jax_build_parser()._actions}[flag]
    assert mine.default == theirs.default
    assert mine.choices == theirs.choices
    assert mine.type == theirs.type
    assert mine.option_strings == theirs.option_strings
    assert type(mine) is type(theirs)


def test_worker_argv_forwards_the_workers_flags(tmp_path):
    argv = _argv("/ck", "--replicas", "3", "--run-dir", str(tmp_path),
                 "--slo", "serve.ttft_s p99 < 1 over 10s", "--speculative",
                 "--draft-layers", "1", "--eos-id", "7",
                 "--tenant-queue-cap", "2")
    argv[argv.index("cpu")] = "cuda:1"
    args = serve_cli.build_parser().parse_args(argv)
    w = serve_cli._worker_argv(args, 2, 4321, "decode")
    assert w[1:3] == ["-m", "nezha_tpu_torch.cli.serve"]
    wa = serve_cli.build_parser().parse_args(w[3:])
    assert (wa.device, wa.http, wa.role, wa.replicas) == ("cuda:1", 4321,
                                                          "decode", 1)
    assert wa.run_dir == os.path.join(str(tmp_path), "replica2")
    for k in ("ckpt_dir", "model_preset", "cache_dtype", "max_len",
              "max_prefill_len", "kv_block_size", "digest_interval",
              "slo", "speculative", "draft_layers", "eos_id",
              "tenant_queue_cap", "probe_interval", "seed", "mesh"):
        if k == "probe_interval":
            continue    # the router's, not forwarded
        assert getattr(wa, k) == getattr(args, k), k
    # A fleet is an HTTP front end.
    with pytest.raises(SystemExit, match="requires --http"):
        serve_cli.run(serve_cli.build_parser().parse_args(
            ["--ckpt-dir", "/ck", "--replicas", "2"]))


# -------------------------------------------------------------- autoscale
class _StubHandle:
    def __init__(self, port):
        self.port = port
        self.stopped = threading.Event()

    def alive(self):
        return not self.stopped.is_set()

    def terminate(self):
        self.stopped.set()

    kill = terminate

    def wait(self, timeout):
        return self.stopped.wait(timeout)


class _StubBackend:
    kind = "stub"

    def spawn(self, rid, port):
        return _StubHandle(port)


def _autoscale_run(sup_cls, cfg):
    """One scripted pressure sequence through ``autoscale_tick`` ->
    (decisions, replica counts)."""
    sup = sup_cls(_StubBackend(), cfg)
    with sup._lock:
        for r in sup._replicas:
            sup._spawn(r)
    decisions, sizes = [], []
    script = [10, 10, 10, 3, 10, 10, 0, 0, 0, 0, 0, 0]
    for t, queued in enumerate(script):
        for r in sup.replicas():
            if r.state in ("starting", "live"):
                sup.mark_probe(r.rid, True, {"queued": queued})
        decisions.append(sup.autoscale_tick(now=float(t)))
        time.sleep(0.05)      # a scale-down drains on its own thread
        sizes.append(sum(1 for r in sup.replicas()
                         if r.state not in ("stopped", "failed")))
    sup.shutdown()
    return decisions, sizes


def test_autoscale_decisions_equal_jax():
    from nezha_tpu import obs as jobs
    from nezha_tpu.serve.supervisor import Supervisor as JaxSupervisor
    from nezha_tpu_torch import obs
    # The prefill-wait signal reads each process-wide registry: start
    # both empty, whatever earlier fleets recorded.
    obs.REGISTRY.reset()
    jobs.REGISTRY.reset()
    kw = dict(replicas=1, autoscale_min=1, autoscale_max=3,
              autoscale_sustain_ticks=2, autoscale_cooldown_s=1.0,
              drain_timeout_s=0.5)
    mine = _autoscale_run(Supervisor, RouterConfig(**kw))
    theirs = _autoscale_run(JaxSupervisor, JaxRouterConfig(**kw))
    assert mine == theirs
    assert "up" in mine[0] and "down" in mine[0] and max(mine[1]) == 3


def test_autoscale_bounds_start_a_router_at_one_replica(jax_run):
    ckpt_dir, want, _ = jax_run
    fleet = Fleet(_argv(ckpt_dir, "--replica-backend", "thread",
                        "--autoscale-min", "1", "--autoscale-max", "2"))
    try:
        assert len(fleet.sup.replicas()) == 1
        assert fleet.sup.autoscale_target() == 1
        code, ans = _post(fleet.port, {"prompt_tokens": PROMPTS[0],
                                       "max_new_tokens": NEW})
        assert code == 200 and ans["tokens"] == want[tuple(PROMPTS[0])]
    finally:
        assert fleet.close() == 0
    with pytest.raises(SystemExit, match="autoscale"):
        serve_cli.run(serve_cli.build_parser().parse_args(_argv(
            ckpt_dir, "--autoscale-min", "2", "--autoscale-max", "1")))
