"""``nezha_tpu_torch.cli.serve``'s HTTP front end and graceful drain, after
``tests/test_faults.py`` (the drains) and ``tests/test_migration.py`` (the
pull, ``/healthz``), on the tiny preset on the CPU: two port ``run_http``
servers on ephemeral 127.0.0.1 ports in threads of the test.

- the migration over HTTP: a ``prefill_only`` park on A, ``pull_from`` on
  B (``pull_into``: export, install, ACK), tokens equal to a local
  decode; a lost park is 424 ``park_lost``; a local ``resume``; the peer
  pull's tokens mode, which degrades to a cold prefill on failure;
- ``/healthz`` with every JAX key but the fleet digest, the 409 duplicate,
  the typed 503s (``queue_full``, ``tenant_over_limit``), 501 for the
  telemetry endpoints, the decode thread's death;
- the stdio and HTTP drains: stragglers retire "deadline", a line read
  after the signal is answered "draining", the drain event closes stdio,
  the HTTP server ends; ``run`` installs and restores SIGTERM/SIGINT;
- the new flags' defaults and choices against JAX's parser.

The drains need requests that outlive a short budget: the tests slow the
scheduler's ``step`` with a wrapper of their own (JAX's tests use a fault
plan; the port has no fault switch)."""

import io
import json
import os
import signal
import threading
import time
import types

import pytest

from nezha_tpu.cli.serve import build_parser as jax_build_parser
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.serve import Request, Scheduler, migrate
from nezha_tpu_torch.serve.migrate import MigrationError

BASE = ["--random-init", "--model-preset", "tiny", "--device", "cpu",
        "--max-batch-size", "2", "--max-len", "64", "--max-prefill-len",
        "16", "--kv-block-size", "8", "--queue-capacity", "8"]
# JAX's /healthz keys (nezha_tpu/cli/serve.py run_http), the fleet
# digest's aside.
HEALTHZ_KEYS = {"status", "active", "capacity", "queued", "occupancy",
                "role", "parked", "tenants", "preempted", "host_blocks",
                "host_blocks_used"}


def _prompt(n, salt=0):
    return [(7 * i + 3 + 11 * salt) % 512 for i in range(n)]


def call(port, method, path, obj=None, timeout=60):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if obj is None else json.dumps(obj).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def slow_steps(sched, seconds):
    """Slow every step of ``sched`` by ``seconds`` (a test-local
    wrapper: long requests outlive a short drain budget)."""
    inner = sched.step

    def step():
        time.sleep(seconds)
        return inner()

    sched.step = step
    return sched


class Servers:
    """``run_http`` servers in threads; ``close`` drains and joins each."""

    def __init__(self):
        self.all = []

    def start(self, *extra, slow=0.0, sched_fn=None):
        args = serve_cli.build_parser().parse_args(BASE + list(extra))
        sched = serve_cli.build_scheduler(args)
        if sched_fn is not None:
            sched_fn(sched)
        if slow:
            slow_steps(sched, slow)
        ready, drain, box = threading.Event(), threading.Event(), {}

        def cb(server):
            box["port"] = server.server_address[1]
            ready.set()

        th = threading.Thread(
            target=lambda: box.update(rc=serve_cli.run_http(
                sched, args, 0, ready_cb=cb, drain=drain)), daemon=True)
        th.start()
        assert ready.wait(120), "server did not start"
        srv = types.SimpleNamespace(port=box["port"], sched=sched,
                                    drain=drain, thread=th, box=box)
        self.all.append(srv)
        return srv

    def close(self):
        for srv in self.all:
            srv.drain.set()
        for srv in self.all:
            srv.thread.join(60)


@pytest.fixture
def servers():
    s = Servers()
    try:
        yield s
    finally:
        s.close()


def _wait(cond, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


# ------------------------------------------------------------ migration
def test_pull_into_end_to_end_and_healthz(servers):
    a, b = servers.start("--role", "prefill"), servers.start()
    prompt = _prompt(21)
    code, park = call(a.port, "POST", "/generate", {
        "id": "m", "prompt_tokens": prompt, "max_new_tokens": 6,
        "prefill_only": True})
    assert code == 200 and park["finish_reason"] == "prefilled"
    assert park["tokens"] == [] and "event" not in park
    code, health = call(a.port, "GET", "/healthz")
    assert code == 200 and set(health) == HEALTHZ_KEYS
    assert (health["status"], health["role"], health["parked"],
            health["active"]) == ("ok", "prefill", 1, 1)
    code, moved = call(b.port, "POST", "/generate", {
        "id": "m", "prompt_tokens": prompt, "max_new_tokens": 6,
        "pull_from": {"port": a.port, "request_id": "m"}})
    assert code == 200, moved
    mig = moved["migration"]
    assert mig["blocks"] == 2 and mig["installed"] == 2 and mig["acked"]
    assert mig["bytes"] > 0 and mig["seconds"] >= 0
    assert moved["finish_reason"] == "length"
    assert b.sched.engine.pool.prefix_hits == 1
    assert b.sched.migrations == 1
    code, health = call(a.port, "GET", "/healthz")
    assert (health["parked"], health["active"]) == (0, 0)
    local = Scheduler(b.sched.engine)
    local.submit(Request(prompt=prompt, max_new_tokens=6, request_id="l"))
    local.run_until_idle()
    assert moved["tokens"] == local.results["l"].tokens
    for srv in (a, b):
        srv.sched.engine.pool.leak_check()


def test_lost_park_is_424_park_lost_and_resume(servers):
    a, b = servers.start(), servers.start()
    code, body = call(b.port, "POST", "/generate", {
        "id": "x", "prompt_tokens": _prompt(21), "max_new_tokens": 4,
        "pull_from": {"port": a.port, "request_id": "gone"}})
    assert code == 424 and body["error_type"] == "park_lost"
    code, body = call(b.port, "POST", "/generate", {
        "id": "x", "prompt_tokens": _prompt(21),
        "pull_from": {"request_id": "gone"}})
    assert code == 424 and body["error_type"] == "migration_failed"
    with pytest.raises(MigrationError) as info:
        migrate.pull_into(b.sched, {"port": a.port, "request_id": "gone"})
    assert info.value.kind == "park_lost"
    code, _ = call(a.port, "POST", "/generate", {
        "id": "r", "prompt_tokens": _prompt(21, 1), "max_new_tokens": 5,
        "prefill_only": True})
    assert code == 200
    code, res = call(a.port, "POST", "/generate", {"resume": "r"})
    assert code == 200 and res["resumed"] is True
    assert res["finish_reason"] == "length" and len(res["tokens"]) == 5
    code, body = call(a.port, "POST", "/generate", {"resume": "r"})
    assert code == 404 and body["error_type"] == "migration_failed"
    code, body = call(a.port, "POST", "/kv_ack", {"request_id": "r"})
    assert code == 200 and body == {"id": "r", "released": False}
    code, body = call(a.port, "POST", "/kv_export", {})
    assert code == 400 and body["error_type"] == "bad_request"
    for srv in (a, b):
        srv.sched.engine.pool.leak_check()


def test_peer_pull_tokens_mode_and_degrade(servers):
    a, b = servers.start(), servers.start()
    prompt = _prompt(30, 2)
    code, _ = call(a.port, "POST", "/generate", {
        "prompt_tokens": prompt, "max_new_tokens": 2})
    assert code == 200
    code, res = call(b.port, "POST", "/generate", {
        "id": "p", "prompt_tokens": prompt, "max_new_tokens": 3,
        "pull_from": {"port": a.port, "tokens": prompt}})
    assert code == 200, res
    pull = res["fleet_pull"]
    assert pull["blocks"] == 3 and pull["installed"] == 3
    pool = b.sched.engine.pool
    assert pool.fleet_hits["peer"] == 1 and b.sched.pull_bytes == pull[
        "bytes"]
    code, res = call(b.port, "POST", "/generate", {
        "id": "q", "prompt_tokens": _prompt(12, 3), "max_new_tokens": 2,
        "pull_from": {"port": 1, "tokens": _prompt(12, 3)}})
    assert code == 200 and res["finish_reason"] == "length"
    assert res["fleet_pull"]["error_type"] == "kv_pull_failed"
    assert res["fleet_pull"]["installed"] == 0
    for srv in (a, b):
        srv.sched.engine.pool.leak_check()


# ------------------------------------------------------ front end errors
def test_duplicate_409_typed_503s_and_501(servers):
    srv = servers.start("--max-batch-size", "1", "--queue-capacity", "1",
                        "--max-new-tokens", "40", "--drain-timeout", "0.2",
                        slow=0.05)
    results = {}

    def post(rid, **kw):
        results[rid] = call(srv.port, "POST", "/generate", {
            "id": rid, "prompt_tokens": _prompt(9), "max_new_tokens": 40,
            **kw})

    first = threading.Thread(target=post, args=("a",))
    first.start()
    _wait(lambda: srv.sched.engine.pool.num_active == 1)
    second = threading.Thread(target=post, args=("b",))
    second.start()
    _wait(lambda: srv.sched.queue_depth == 1)
    code, body = call(srv.port, "POST", "/generate", {
        "id": "a", "prompt_tokens": _prompt(9)})
    assert code == 409 and "already in flight" in body["error"]
    code, body = call(srv.port, "POST", "/generate", {
        "id": "c", "prompt_tokens": _prompt(9)})
    assert code == 503 and body["error_type"] == "queue_full"
    for path in ("/stats", "/windows", "/metrics"):
        code, body = call(srv.port, "GET", path)
        assert code == 501 and "A5" in body["error"]
    code, body = call(srv.port, "GET", "/nope")
    assert code == 404
    srv.drain.set()
    first.join(60)
    second.join(60)
    assert {results[r][1]["finish_reason"] for r in ("a", "b")} <= {
        "length", "deadline"}
    srv.thread.join(60)
    srv.sched.engine.pool.leak_check()


def test_tenant_over_limit_is_a_typed_503(servers):
    srv = servers.start("--max-batch-size", "1", "--tenant-queue-cap", "1",
                        "--max-new-tokens", "40", "--drain-timeout", "0.2",
                        slow=0.05)
    threads = []
    # t0 decodes in the one slot, t1 fills acme's one queue seat.
    for rid, placed in (("t0", lambda: srv.sched.engine.pool.num_active),
                        ("t1", lambda: srv.sched.queue_depth)):
        threads.append(threading.Thread(target=call, args=(
            srv.port, "POST", "/generate", {
                "id": rid, "prompt_tokens": _prompt(9), "tenant_id": "acme",
                "max_new_tokens": 40})))
        threads[-1].start()
        _wait(lambda: placed() == 1)
    code, body = call(srv.port, "POST", "/generate", {
        "id": "t2", "prompt_tokens": _prompt(9), "tenant_id": "acme"})
    assert code == 503 and body["error_type"] == "tenant_over_limit"
    srv.drain.set()
    for th in threads:
        th.join(60)


def test_decode_thread_death_releases_waiters(servers):
    def broken(sched):
        inner = sched.step

        def step():
            if sched.engine.pool.num_active:
                raise RuntimeError("boom")
            return inner()

        sched.step = step

    srv = servers.start(sched_fn=broken)
    code, body = call(srv.port, "POST", "/generate", {
        "id": "d", "prompt_tokens": _prompt(9), "max_new_tokens": 4})
    assert code == 500 and body["error"] == "decode loop failed"
    code, health = call(srv.port, "GET", "/healthz")
    assert code == 503 and health["status"] == "decode loop stopped"
    code, body = call(srv.port, "POST", "/generate", {
        "id": "e", "prompt_tokens": _prompt(9)})
    assert code == 503


# ----------------------------------------------------------------- drains
def test_http_drain_closes_admission_and_cancels_stragglers(servers):
    srv = servers.start("--drain-timeout", "0.3", "--max-new-tokens", "48",
                        slow=0.05)
    answers = {}

    def post(i):
        answers[i] = call(srv.port, "POST", "/generate", {
            "id": f"s{i}", "prompt_tokens": _prompt(9, i),
            "max_new_tokens": 48})

    threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    _wait(lambda: srv.sched.engine.pool.num_active == 2)
    srv.drain.set()
    code, health = call(srv.port, "GET", "/healthz")
    assert code == 503 and health["status"] == "draining"
    code, body = call(srv.port, "POST", "/generate", {
        "prompt_tokens": _prompt(9)})
    assert code == 503 and body["error"] == "draining"
    for th in threads:
        th.join(60)
    srv.thread.join(60)
    assert not srv.thread.is_alive() and srv.box["rc"] == 0
    assert {a[0] for a in answers.values()} == {200}
    assert {a[1]["finish_reason"] for a in answers.values()} == {"deadline"}
    assert all(0 < len(a[1]["tokens"]) < 48 for a in answers.values())
    srv.sched.engine.pool.leak_check()


def _stdio(extra, slow=0.0):
    """The stdio front end on a pipe, in a thread: -> (write, drain,
    stdout, thread, scheduler, result box)."""
    args = serve_cli.build_parser().parse_args(BASE + list(extra))
    sched = slow_steps(serve_cli.build_scheduler(args), slow) if slow \
        else serve_cli.build_scheduler(args)
    r, w = os.pipe()
    reader, writer = os.fdopen(r), os.fdopen(w, "w")
    stdout, drain, box = io.StringIO(), threading.Event(), {}
    th = threading.Thread(target=lambda: box.update(rc=serve_cli.run_stdio(
        sched, args, stdin=reader, stdout=stdout, drain=drain)),
        daemon=True)
    th.start()

    def write(obj):
        writer.write(json.dumps(obj) + "\n")
        writer.flush()

    return write, drain, stdout, th, sched, box, writer


def _events(stdout):
    return [json.loads(ln) for ln in stdout.getvalue().splitlines()]


def test_stdio_drain_finishes_in_flight():
    write, drain, stdout, th, sched, box, w = _stdio(["--drain-timeout",
                                                      "30"], slow=0.01)
    write({"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 24})
    _wait(lambda: sched.engine.pool.num_active == 1)
    drain.set()
    th.join(60)
    w.close()
    assert not th.is_alive() and box["rc"] == 0
    events = _events(stdout)
    done = [e for e in events if e["event"] == "done"]
    assert [e["id"] for e in done] == ["a"]
    assert done[0]["finish_reason"] == "length"
    assert len(done[0]["tokens"]) == 24
    assert events[-1] == {"id": None, "event": "drain", "cancelled": 0}


def test_stdio_drain_deadline_cancels_and_answers_late_lines():
    write, drain, stdout, th, sched, box, w = _stdio(
        ["--drain-timeout", "0", "--max-new-tokens", "40"], slow=0.05)
    write({"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 40})
    _wait(lambda: sched.engine.pool.num_active == 1)
    drain.set()
    write({"id": "late", "prompt_tokens": [5, 17]})
    th.join(60)
    w.close()
    assert not th.is_alive() and box["rc"] == 0
    events = _events(stdout)
    done = [e for e in events if e["event"] == "done"]
    assert done and done[0]["finish_reason"] == "deadline"
    assert events[-1] == {"id": None, "event": "drain", "cancelled": 1}
    sched.engine.pool.leak_check()


def test_stdio_drain_answers_request_awaiting_queue_room():
    write, drain, stdout, th, sched, box, w = _stdio(
        ["--max-batch-size", "1", "--queue-capacity", "1",
         "--drain-timeout", "30", "--max-new-tokens", "30"], slow=0.05)
    for i in range(3):
        write({"id": f"r{i}", "prompt_tokens": [5, 17],
               "max_new_tokens": 30})
    _wait(lambda: sched.engine.pool.num_active == 1
          and sched.queue_depth == 1)
    time.sleep(0.05)              # r2 read, waiting for queue room
    drain.set()
    th.join(120)
    w.close()
    assert not th.is_alive() and box["rc"] == 0
    events = _events(stdout)
    assert events[-1]["event"] == "drain"
    answered = {e.get("id") for e in events
                if e["event"] in ("done", "error")}
    assert answered >= {"r0", "r1", "r2"}
    assert any(e["event"] == "error" and e.get("error") == "draining"
               for e in events)


def test_serve_run_installs_and_restores_signal_handlers(monkeypatch):
    installed, restored = {}, {}

    def fake_signal(sig, handler):
        (restored if sig in installed else installed)[sig] = handler
        return signal.SIG_DFL

    monkeypatch.setattr(signal, "signal", fake_signal)
    args = serve_cli.build_parser().parse_args(BASE)
    assert serve_cli.run(args, stdin=io.StringIO(""),
                         stdout=io.StringIO()) == 0
    assert set(installed) == set(restored) == {signal.SIGTERM,
                                               signal.SIGINT}
    assert all(h == signal.SIG_DFL for h in restored.values())
    installed[signal.SIGTERM](signal.SIGTERM, None)   # sets the event
    # A drain event set before the stream ends: one final drain line.
    drain, out = threading.Event(), io.StringIO()
    drain.set()
    assert serve_cli.run(args, stdin=io.StringIO(""), stdout=out,
                         drain_event=drain) == 0
    assert json.loads(out.getvalue().splitlines()[-1]) == {
        "id": None, "event": "drain", "cancelled": 0}


# ------------------------------------------------------------------ flags
@pytest.mark.parametrize("flag", ["kv_host_blocks", "prefill_impl",
                                  "drain_timeout", "http", "role"])
def test_new_flags_take_jax_defaults_and_choices(flag):
    mine = {a.dest: a for a in serve_cli.build_parser()._actions}[flag]
    theirs = {a.dest: a for a in jax_build_parser()._actions}[flag]
    assert mine.default == theirs.default
    assert mine.choices == theirs.choices
    assert mine.type == theirs.type
    assert mine.option_strings == theirs.option_strings
    args = serve_cli.build_parser().parse_args(BASE + ["--prefill-impl",
                                                       "xla"])
    assert serve_cli.build_scheduler(args).engine.model.cfg.prefill_impl \
        == "xla"
    req = serve_cli.parse_request({"prompt_tokens": [1, 2],
                                   "prefill_only": True}, args, 512)
    assert req.prefill_only is True
