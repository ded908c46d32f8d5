"""``nezha_tpu_torch.obs`` against the JAX package's ``obs``: the same
seeded sequence of instrument operations on a registry of each package
gives equal ``/stats`` payloads and summaries (times and registry ids
aside), equal log-bucket sketches and window merges, identical
Prometheus text, and equal SLO evaluations and watchdog events. Then the
port's serve CLI on the CPU (tiny preset): JAX's ``check_run_dir``,
``check_stats_payload`` and ``check_metrics_exposition`` pass on its run
dir, its ``/stats`` and its ``/metrics``, stdio and HTTP."""

import http.client
import io
import json
import threading
import time

import numpy as np
import pytest

from nezha_tpu import obs as jobs
from nezha_tpu.analysis.telemetry_schema import (check_metrics_exposition,
                                                 check_run_dir,
                                                 check_stats_payload)
from nezha_tpu.obs import registry as jreg_mod
from nezha_tpu.obs import timeseries as jts
from nezha_tpu_torch import obs
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.obs import registry as reg_mod
from nezha_tpu_torch.obs import timeseries as ts

BASE = ["--random-init", "--model-preset", "tiny", "--device", "cpu",
        "--max-batch-size", "2", "--max-len", "64", "--max-prefill-len",
        "16", "--kv-block-size", "8"]
SLOS = ["serve.ttft_s p99 < 0.05 over 10s", "serve.queue_depth max <= 2 "
        "over 10s objective 0.9", "serve.tokens_total rate > 1 over 60s"]


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _disabled():
    yield
    for mod in (obs, jobs):
        mod.end_run()
        mod.disable()
        mod.uninstall_windows()


def _drive(obs_mod, reg_module, ts_module, seed=0, n=6000):
    """One seeded run of counter, gauge, histogram and span operations
    over a fresh registry with a window store on a fake clock -> (the
    registry, the clock)."""
    reg = reg_module.Registry()
    clock = Clock()
    reg_module._state.windows = ts_module.WindowStore(
        interval_s=10.0, retention_s=300.0, clock=clock)
    obs_mod.enable()
    rng = np.random.RandomState(seed)
    for i in range(n):
        op = rng.randint(5)
        if op == 0:
            reg.counter(f"serve.c{rng.randint(3)}_total").inc(
                int(rng.randint(1, 5)))
        elif op == 1:
            reg.gauge(f"serve.g{rng.randint(2)}").set(float(rng.rand()))
        elif op == 2:
            reg.histogram("serve.ttft_s").observe(float(rng.lognormal()))
        elif op == 3:
            reg.histogram("serve.tpot_s").observe(float(rng.rand() * 0.1))
        else:
            t0 = clock.t
            reg.emit_span("serve.queue_wait", t0, t0 + float(rng.rand()),
                          trace_id="abc" if i % 2 else None,
                          request_id=str(i))
        if i % 97 == 0:
            clock.t += 3.7
        if i % 500 == 0:
            reg.counter("serve.queue_depth_samples").inc()
            reg.gauge("serve.queue_depth").set(float(rng.randint(0, 5)))
    return reg, clock


def _strip_stats(stats):
    stats = dict(stats)
    for k in ("ts", "registry_id"):
        stats.pop(k, None)
    return stats


def _strip_snapshot(snap):
    snap = json.loads(json.dumps(snap))
    for s in snap["slowest_spans"]:
        s.pop("span_id", None)
    return snap


def test_registry_snapshots_equal_jax():
    jreg, _ = _drive(jobs, jreg_mod, jts)
    reg, _ = _drive(obs, reg_mod, ts)
    assert _strip_stats(reg.stats()) == _strip_stats(jreg.stats())
    assert _strip_snapshot(reg.snapshot()) == _strip_snapshot(
        jreg.snapshot())
    assert reg.stats()["registry_id"] != jreg.stats()["registry_id"]


def test_disabled_registry_is_a_no_op():
    reg = reg_mod.Registry()
    obs.disable()
    reg.counter("x").inc()
    reg.histogram("h").observe(1.0)
    reg.gauge("g").set(2.0)
    assert reg.span("s") is obs.NULL_SPAN
    assert reg.traced_span("s") is obs.NULL_SPAN
    assert obs.mint_trace_id() is None
    assert reg.counter("x").value == 0 and reg.histogram("h").count == 0
    assert reg.record_event("watchdog.x") is None


@pytest.mark.parametrize("gamma", [1.05, 1.2])
def test_log_sketches_and_merges_equal_jax(gamma):
    rng = np.random.RandomState(3)
    a_vals = rng.lognormal(size=3000).tolist() + [0.0, -1.0]
    b_vals = (rng.rand(2000) * 1e-3).tolist()
    mine = [ts.LogSketch(gamma) for _ in range(2)]
    theirs = [jts.LogSketch(gamma) for _ in range(2)]
    for vals, m, t in zip((a_vals, b_vals), mine, theirs):
        for v in vals:
            m.observe(v)
            t.observe(v)
        assert m.to_dict() == t.to_dict()
    mine[0].merge(mine[1])
    theirs[0].merge(theirs[1])
    assert mine[0].to_dict() == theirs[0].to_dict()
    for q in (0.5, 0.9, 0.99):
        assert mine[0].quantile(q) == theirs[0].quantile(q)
    assert mine[0].summary() == theirs[0].summary()
    back = ts.LogSketch.from_dict(theirs[0].to_dict())
    assert back.to_dict() == theirs[0].to_dict()


def _payloads(obs_mod, reg_module, ts_module, seed):
    reg, clock = _drive(obs_mod, reg_module, ts_module, seed=seed, n=2000)
    out = ts_module.windows_payload(reg)
    out["ts"] = 0.0
    return reg, out


def test_windows_merge_and_prometheus_text_equal_jax():
    mine, theirs = [], []
    for seed in (1, 2):
        reg, p = _payloads(obs, reg_mod, ts, seed)
        jreg, jp = _payloads(jobs, jreg_mod, jts, seed)
        p["registry_id"] = jp["registry_id"] = f"r{seed}"
        mine.append((reg, p))
        theirs.append((jreg, jp))
        assert p == jp
    # The same member twice (a shared registry) counts once.
    dup = [mine[0][1], mine[0][1], mine[1][1]]
    jdup = [theirs[0][1], theirs[0][1], theirs[1][1]]

    def merge(mod, payloads):
        out = mod.merge_window_payloads(payloads)
        out.pop("ts")
        return out

    merged = merge(ts, dup)
    assert merged == merge(jts, jdup)
    assert merged["deduped"] == 1
    assert merged["windows"] == merge(ts, [mine[0][1], mine[1][1]])[
        "windows"]
    stats = _strip_stats(mine[0][0].stats())
    jstats = _strip_stats(theirs[0][0].stats())
    text = ts.render_prometheus(stats, merged)
    assert text == jts.render_prometheus(jstats, merge(jts, jdup))
    assert check_metrics_exposition(text) == []
    assert ts.parse_prometheus(text) == jts.parse_prometheus(text)
    assert ts.render_prometheus(None, None) == jts.render_prometheus(
        None, None)


def test_slo_evaluations_and_watchdog_events_equal_jax():
    mine = [obs.parse_slo(s) for s in SLOS]
    theirs = [jobs.parse_slo(s) for s in SLOS]
    assert [m.spec() for m in mine] == [t.spec() for t in theirs]
    assert [m.name for m in mine] == [t.name for t in theirs]
    for bad in ("serve.ttft_s p99 <", "x p42 < 1 over 10s",
                "x p99 < 1 over 10s objective 2"):
        with pytest.raises(ValueError):
            jobs.parse_slo(bad)
        with pytest.raises(ValueError):
            obs.parse_slo(bad)
    reg, clock = _drive(obs, reg_mod, ts, seed=4, n=3000)
    jreg, jclock = _drive(jobs, jreg_mod, jts, seed=4, n=3000)
    for m, t in zip(mine, theirs):
        assert obs.evaluate_slo(m, reg.windows(m.window_s)) == \
            jobs.evaluate_slo(t, jreg.windows(t.window_s))
    cfg = dict(interval_s=1.0, window_s=10.0, queue_depth_limit=1.0,
               min_samples=5)
    wd = obs.Watchdog(registry=reg, slos=mine,
                      config=obs.WatchdogConfig(**cfg))
    jwd = jobs.Watchdog(registry=jreg, slos=theirs,
                        config=jobs.WatchdogConfig(**cfg))
    got, want = [], []
    rng = np.random.RandomState(5)
    for step in range(12):
        v = float(rng.lognormal() * (5 if step > 6 else 1))
        for r in (reg, jreg):
            r.histogram("serve.ttft_s").observe(v)
            r.gauge("serve.queue_depth").set(float(step % 4))
            r.counter("router.replica_restarts_total").inc(step % 3)
        clock.t += 4.0
        jclock.t += 4.0
        got += wd.check()
        want += jwd.check()
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in got]
    jstrip = [{k: v for k, v in e.items() if k != "ts"} for e in want]
    assert strip == jstrip and strip
    assert wd.status() == jwd.status()
    assert obs.summarize_slo_events(got) == jobs.summarize_slo_events(want)


def test_trace_ids_and_headers():
    obs.enable()
    obs.set_trace_sample(1.0)
    tid = obs.mint_trace_id()
    assert isinstance(tid, str) and len(tid) == 16
    obs.set_trace_sample(0.0)
    assert obs.mint_trace_id() is None
    obs.set_trace_sample(1.0)
    with pytest.raises(ValueError):
        obs.set_trace_sample(1.5)
    payload = {"prompt_tokens": [1]}
    obs.adopt_trace_header({obs.TRACE_HEADER: "t1"}, payload)
    assert payload["trace_id"] == "t1"
    obs.adopt_trace_header({obs.TRACE_HEADER: "t2"}, payload)
    assert payload["trace_id"] == "t1"
    assert obs.TRACE_HEADER == jobs.TRACE_HEADER
    obs.REGISTRY.spans.clear()
    with obs.trace_context("tr"):
        with obs.traced_span("a") as outer:
            with obs.span("b"):
                pass
    obs.emit_span("c", 1.0, 2.0)
    recs = {r["name"]: r for r in obs.REGISTRY.spans}
    assert recs["a"]["trace_id"] == recs["b"]["trace_id"] == "tr"
    assert recs["b"]["parent_id"] == outer.span_id
    assert "trace_id" not in recs["c"]


# ---------------------------------------------------------- the serve CLI
def test_serve_stdio_run_dir_passes_jax_checks(tmp_path):
    run = tmp_path / "run"
    args = serve_cli.build_parser().parse_args(
        BASE + ["--run-dir", str(run), "--slo",
                "serve.ttft_s p99 < 5 over 10s", "--watchdog-interval",
                "0.05"])
    lines = [{"id": f"r{i}", "prompt_tokens": [3 + i, 5, 7, 9],
              "max_new_tokens": 4} for i in range(3)]
    out = io.StringIO()
    stdin = io.StringIO("".join(json.dumps(x) + "\n" for x in lines))
    assert serve_cli.run(args, stdin=stdin, stdout=out) == 0
    assert check_run_dir(str(run)) == []
    summary = json.loads((run / "summary.json").read_text())
    assert summary["counters"]["serve.tokens_total"] == 12
    assert summary["counters"]["serve.admitted_total"] == 3
    assert summary["run"]["kind"] == "serve"
    spans = [json.loads(x) for x in (run / "spans.jsonl").read_text()
             .splitlines()]
    names = {s["name"] for s in spans}
    assert {"serve.prefill", "serve.queue_wait", "serve.decode",
            "serve.prefill.chunk"} <= names
    assert not obs.enabled()


def _get_text(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_serve_http_stats_and_metrics_pass_jax_checks(tmp_path):
    run = tmp_path / "run"
    args = serve_cli.build_parser().parse_args(
        BASE + ["--http", "0", "--run-dir", str(run)])
    box, ready, drain = {}, threading.Event(), threading.Event()

    def cb(srv):
        box["port"] = srv.server_address[1]
        ready.set()

    th = threading.Thread(target=lambda: box.update(rc=serve_cli.run(
        args, ready_cb=cb, drain_event=drain)), daemon=True)
    th.start()
    assert ready.wait(120)
    port = box["port"]
    try:
        for i in range(2):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/generate", body=json.dumps({
                "id": f"h{i}", "prompt_tokens": [4, 6, 8 + i],
                "max_new_tokens": 3}).encode(),
                headers={obs.TRACE_HEADER: f"trace{i}"})
            assert conn.getresponse().status == 200
            conn.close()
        code, body = _get_text(port, "/stats")
        stats = json.loads(body)
        assert code == 200 and check_stats_payload(stats) == []
        assert stats["counters"]["serve.tokens_total"] == 6
        code, text = _get_text(port, "/metrics")
        assert code == 200 and check_metrics_exposition(text) == []
        assert ts.metric_value(ts.parse_prometheus(text),
                               "nezha_serve_tokens_total") == 6
        code, body = _get_text(port, "/windows")
        win = json.loads(body)
        assert code == 200 and set(win["windows"]) == {"10s", "60s", "300s"}
    finally:
        drain.set()
        th.join(60)
    assert box["rc"] == 0 and check_run_dir(str(run)) == []
    spans = [json.loads(x) for x in (run / "spans.jsonl").read_text()
             .splitlines()]
    traced = {s.get("trace_id") for s in spans if s["name"] ==
              "serve.prefill"}
    assert traced == {"trace0", "trace1"}
    assert any(s["name"] == "serve.drain" for s in spans)
