"""The train side's telemetry of the port against the JAX package's, on
the CPU at the tiny preset: ``StepTimer``'s windows, ``get_logger``'s
lines, ``annotate``; the train CLI's ``--run-dir`` (JAX's
``check_run_dir`` and the port's copy both pass; the summary's counter,
gauge, histogram and span names equal those of a JAX CLI run of the same
config, ``train.steps`` too); the port's ``obs/report.py`` and
``cli/telemetry.py`` render the same text as JAX's on the same run dirs
(a train run, a single serve replica, a two-replica process fleet whose
replica was killed with requests in flight); the port's copy of the
schema checks returns JAX's error lists on good and broken run dirs,
``/stats`` bodies and exposition texts; the prefetcher's and the
coordinator's instruments and the train side's fault points."""

import http.client
import io
import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nezha_tpu import faults as jfaults
from nezha_tpu import obs as jobs
from nezha_tpu.analysis import telemetry_schema as jschema
from nezha_tpu.cli import telemetry as jtelemetry
from nezha_tpu.cli import train as jtrain
from nezha_tpu.obs import metrics as jmetrics
from nezha_tpu.obs import report as jreport
from nezha_tpu.utils import logging as jlogging
from nezha_tpu_torch import dist, faults, obs
from nezha_tpu_torch.analysis import telemetry_schema as schema
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.cli import telemetry as telemetry_cli
from nezha_tpu_torch.cli import top as top_cli
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.obs import metrics as metrics_mod
from nezha_tpu_torch.obs import report
from nezha_tpu_torch.runtime import Prefetcher
from nezha_tpu_torch.utils import logging as logging_mod

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["--config", "gpt2_124m", "--model-preset", "tiny", "--steps", "4",
         "--batch-size", "2", "--seq-len", "32", "--log-every", "2",
         "--ckpt-every", "2", "--parallel", "single"]
SERVE = ["--random-init", "--model-preset", "tiny", "--device", "cpu",
         "--max-batch-size", "2", "--max-len", "64", "--max-prefill-len",
         "16", "--kv-block-size", "8"]


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (obs, jobs):
        mod.end_run()
        mod.disable()
        mod.uninstall_windows()
    faults.clear()
    jfaults.clear()


# ------------------------------------------------------------ StepTimer
class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("window,seed", [(1, 0), (3, 1), (5, 2)])
def test_step_timer_windows_equal_jax(window, seed, monkeypatch):
    """One seeded sequence of tick, start, lap and reset calls on a
    patched ``time.perf_counter``: every return (rates and Nones) equal
    JAX's timer's."""
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    rng = np.random.RandomState(seed)
    ops = [(int(rng.randint(6)), float(rng.rand()), int(rng.randint(4)))
           for _ in range(200)]
    out = []
    for mod in (metrics_mod, jmetrics):
        clock.t = 100.0
        timer, got = mod.StepTimer(window=window), []
        for op, dt, n in ops:
            clock.t += dt
            if op <= 2:
                got.append(timer.tick(np.float32(dt)))
            elif op == 3:
                got.append(timer.lap(dt, n))
            elif op == 4:
                timer.start()
            else:
                timer.reset()
        out.append(got)
    assert out[0] == out[1]
    assert any(r is None for r in out[0]) and any(r for r in out[0])


def test_step_timer_lap_reads_its_scalar():
    """The lap's barrier is ``float()`` of the scalar it is given."""
    reads = []

    class Scalar:
        def __float__(self):
            reads.append(1)
            return 0.0

    timer = metrics_mod.StepTimer()
    timer.start()
    assert timer.lap(Scalar(), 2) > 0 and reads == [1]
    timer.reset()
    assert timer.lap(Scalar(), 2) is None and reads == [1, 1]


# --------------------------------------------------------------- logging
def _line(mod, root_name, name):
    mod.set_rank(3)
    logger = mod.get_logger(name)
    handler = logging.getLogger(root_name).handlers[0]
    rec = logger.makeRecord(name, logging.WARNING, "f.py", 1,
                            "joined world: rank %d / %d", (3, 4), None)
    rec.created, rec.msecs = 1.5e9, 0.0
    for f in handler.filters:
        f.filter(rec)
    return handler.formatter.format(rec)


def test_logger_line_equals_jax():
    got = _line(logging_mod, "nezha_tpu_torch", "nezha_tpu_torch.cli")
    want = _line(jlogging, "nezha_tpu", "nezha_tpu.cli")
    assert "[rank 3] WARNING" in got
    assert got.replace("nezha_tpu_torch", "P") == want.replace(
        "nezha_tpu", "P")


def test_logger_rank_and_level_from_the_environment():
    import subprocess
    import sys
    code = ("from nezha_tpu_torch.utils import get_logger; "
            "log = get_logger('nezha_tpu_torch.x'); "
            "log.info('quiet'); log.error('loud')")
    env = dict(os.environ, NEZHA_RANK="5", NEZHA_LOG_LEVEL="error",
               PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "quiet" not in r.stderr
    assert "[rank 5] ERROR nezha_tpu_torch.x: loud" in r.stderr


def test_annotate_names_a_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.annotate("nezha.region"):
            torch.ones(4).add_(1)
    assert "nezha.region" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------- the train run dir
@pytest.fixture(scope="module")
def train_dirs(tmp_path_factory):
    """-> (the port CLI's run dir, a JAX CLI run dir of the same config,
    the port CLI's stderr lines)."""
    root = tmp_path_factory.mktemp("train_run")
    port, jax_dir = root / "port", root / "jax"
    import contextlib
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        train_cli.run(train_cli.parse_args(
            TRAIN + ["--device", "cpu", "--run-dir", str(port),
                     "--ckpt-dir", str(root / "pck")]))
    jtrain.main(TRAIN + ["--platform", "cpu", "--run-dir", str(jax_dir),
                         "--ckpt-dir", str(root / "jck")])
    return port, jax_dir, err.getvalue().splitlines()


def _summary(d):
    return json.loads((Path(d) / "summary.json").read_text())


def _span_names(d):
    return {json.loads(x)["name"] for x in
            (Path(d) / "spans.jsonl").read_text().splitlines()}


def test_train_run_dir_passes_both_schema_checks(train_dirs):
    port, _, _ = train_dirs
    assert jschema.check_run_dir(str(port)) == []
    assert schema.check_run_dir(str(port)) == []
    run = _summary(port)["run"]
    assert (run["config"], run["engine"], run["steps"],
            run["model_preset"], run["parallel"]) == (
        "gpt2_124m", "eager", 4, "tiny", "single")
    assert not obs.enabled()


# Registered at a run's first prefetch stall, which depends on timing
# in both packages.
STALL_NAMES = {"prefetch.stalls", "prefetch.stall_seconds"}


def test_train_run_dir_names_equal_a_jax_cli_run(train_dirs):
    port, jax_dir, _ = train_dirs
    got, want = _summary(port), _summary(jax_dir)
    for key in ("counters", "gauges", "histograms", "collectives"):
        assert sorted(set(got[key]) - STALL_NAMES) == \
            sorted(set(want[key]) - STALL_NAMES), key
    for s in (got, want):
        assert ("prefetch.stalls" in s["counters"]) == \
            ("prefetch.stall_seconds" in s["histograms"])
    assert _span_names(port) == _span_names(jax_dir) == {
        "train.first_step", "checkpoint.save"}
    assert got["counters"]["train.steps"] == \
        want["counters"]["train.steps"] == 4


def test_train_run_dir_metrics_are_the_cli_lines(train_dirs):
    """metrics.jsonl holds the CLI's own windows, and the report's step
    rate and tokens/s per chip are theirs."""
    port, _, err = train_dirs
    logged = [json.loads(x) for x in err if x.startswith('{"loss"')]
    stream = [json.loads(x) for x in
              (port / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in stream] == [r["step"] for r in logged] == \
        [2, 4]
    for s, c in zip(stream, logged):
        assert s["tokens_per_sec_per_chip"] == c["tokens_per_sec_per_chip"]
    hist = _summary(port)["histograms"]["metric.tokens_per_sec_per_chip"]
    assert hist["count"] == 2
    assert hist["mean"] == pytest.approx(np.mean(
        [c["tokens_per_sec_per_chip"] for c in logged]), rel=1e-12)


def test_trainer_without_a_run_records_nothing(tmp_path):
    """Outside a run the Trainer's spans and counters are no-ops: no
    span, and every counter the run touched reads 0."""
    obs.REGISTRY.reset()
    train_cli.run(train_cli.parse_args(
        TRAIN + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "c")]))
    snap = obs.REGISTRY.snapshot()
    assert set(snap["counters"].values()) <= {0}
    assert snap["num_spans"] == 0


# --------------------------------------------------------------- reports
def _cli_outputs(main, run_dir, capsys):
    """stdout and the exit code of every report mode of a telemetry CLI
    on ``run_dir``."""
    out = {}
    for mode in ([], ["--json"], ["--trace"], ["--trace", "--json"],
                 ["--slo"], ["--slo", "--json"]):
        rc = main([str(run_dir), *mode])
        out[" ".join(mode)] = (rc, capsys.readouterr().out)
    return out


def _assert_reports_equal(run_dir, capsys):
    d = str(run_dir)
    assert report.render_report(d) == jreport.render_report(d)
    assert report.render_trace_report(d) == jreport.render_trace_report(d)
    assert report.render_slo_report(d) == jreport.render_slo_report(d)
    assert report.stitch_run_dir(d) == jreport.stitch_run_dir(d)
    assert report.trace_summary(d) == jreport.trace_summary(d)
    assert _cli_outputs(telemetry_cli.main, d, capsys) == _cli_outputs(
        jtelemetry.main, d, capsys)


def test_train_reports_equal_jax(train_dirs, capsys):
    port, jax_dir, _ = train_dirs
    for d in (port, jax_dir):
        _assert_reports_equal(d, capsys)
    text = report.render_report(str(port))
    assert "engine=eager" in text and "train.first_step" in text


def test_train_report_from_the_streams_alone(train_dirs, tmp_path,
                                             capsys):
    """A crashed run's dir (no summary.json): the report and ``--json``
    recompute from the streams, as JAX's do."""
    port, _, _ = train_dirs
    d = tmp_path / "crashed"
    shutil.copytree(port, d)
    (d / "summary.json").unlink()
    _assert_reports_equal(d, capsys)


def test_telemetry_check_passes_and_fails(train_dirs, tmp_path, capsys):
    port, _, _ = train_dirs
    assert telemetry_cli.main([str(port), "--check"]) == 0
    assert "schema: OK" in capsys.readouterr().err
    bad = tmp_path / "bad"
    shutil.copytree(port, bad)
    summary = _summary(bad)
    summary["schema_version"] = 2
    (bad / "summary.json").write_text(json.dumps(summary))
    assert telemetry_cli.main([str(bad), "--check"]) == 1
    err = capsys.readouterr().err
    assert "schema: " in err and "schema: OK" not in err
    assert telemetry_cli.main([str(tmp_path / "none")]) == 2


def test_single_replica_serve_reports_equal_jax(tmp_path, capsys):
    run = tmp_path / "serve"
    args = serve_cli.build_parser().parse_args(
        SERVE + ["--run-dir", str(run), "--slo",
                 "serve.ttft_s p99 < 5 over 10s; serve.queue_depth max "
                 "<= 1 over 10s objective 0.9", "--watchdog-interval",
                 "0.05"])
    lines = [{"id": f"r{i}", "prompt_tokens": [3 + i, 5, 7, 9, 11][:2 + i],
              "max_new_tokens": 4 + i} for i in range(4)]
    stdin = io.StringIO("".join(json.dumps(x) + "\n" for x in lines))
    assert serve_cli.run(args, stdin=stdin, stdout=io.StringIO()) == 0
    capsys.readouterr()
    _assert_reports_equal(run, capsys)
    assert "serving:" in report.render_report(str(run))
    assert "SLO report" in report.render_slo_report(str(run))


# ------------------------------------------- a fleet with a killed replica
def _post(port, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps(obj).encode(),
                     headers={obs.TRACE_HEADER: obj["id"]})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory):
    """A two-replica process fleet's run dir: replica 0 killed while it
    held requests (each decode step delayed 50 ms by a fault plan), the
    router's requests answered by replica 1, one request sent to replica
    0 directly lost with it, then a drain."""
    root = tmp_path_factory.mktemp("fleet")
    run = root / "run"
    old = os.environ.get(faults.ENV_PLAN)
    os.environ[faults.ENV_PLAN] = "serve.step:delay=0.05x*"
    try:
        args = serve_cli.build_parser().parse_args(
            SERVE + ["--replicas", "2", "--http", "0", "--run-dir",
                     str(run), "--probe-interval", "0.05",
                     "--restart-backoff", "30", "--drain-timeout", "10",
                     "--slo", "serve.ttft_s p99 < 5 over 10s",
                     "--watchdog-interval", "0.1"])
        box, ready, drain = {}, threading.Event(), threading.Event()

        def cb(server):
            box["server"] = server
            ready.set()

        th = threading.Thread(target=lambda: box.update(rc=serve_cli.run(
            args, ready_cb=cb, drain_event=drain)), daemon=True)
        th.start()
        assert ready.wait(120)
        srv = box["server"]
        port, sup = srv.server_address[1], srv.supervisor
        assert srv.router.wait_live(2, 120)
        assert _post(port, {"id": "warm", "prompt_tokens": [3, 1, 4],
                            "max_new_tokens": 4})[0] == 200
        import contextlib
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert top_cli.main([f"http://127.0.0.1:{port}", "--iterations",
                                 "2", "--interval", "0.2",
                                 "--no-clear"]) == 0
        answers = [None] * 4

        def post(i):
            answers[i] = _post(port, {"id": f"k{i}", "prompt_tokens":
                                      [5 + i, 9, 13, 2 + i],
                                      "max_new_tokens": 12})

        def direct():
            # Straight to replica 0, past the router: its trace keeps
            # only what replica 0 wrote before the kill (partial).
            try:
                answers.append(_post(sup.replicas()[0].port, {
                    "id": "direct", "prompt_tokens": [4, 4, 8],
                    "max_new_tokens": 40}))
            except (OSError, http.client.HTTPException):
                answers.append("lost")

        posts = [threading.Thread(target=direct)]
        posts[0].start()
        time.sleep(0.2)   # the direct request admitted first
        posts += [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in posts[1:]:
            t.start()
        time.sleep(0.4)   # requests admitted and decoding
        sup.kill(0)
        for t in posts:
            t.join(120)
        assert [a[0] for a in answers[:4]] == [200] * 4, answers
        assert answers[4:] == ["lost"], answers
        assert srv.router.retries >= 1
        # Drained before replica 0's restart, which would truncate its
        # streams (a sink opens its files afresh).
        assert sup.restarts == 0
        drain.set()
        th.join(60)
        assert box["rc"] == 0
    finally:
        if old is None:
            os.environ.pop(faults.ENV_PLAN, None)
        else:
            os.environ[faults.ENV_PLAN] = old
    return run, buf.getvalue()


def test_top_frames_of_the_fleet(fleet_dir):
    """``nezha-top`` polled the live fleet's front end twice: each frame
    shows two live replicas and a tokens/s row."""
    _, text = fleet_dir
    frames = [f for f in text.split("nezha-top  ") if f]
    assert len(frames) == 2
    for frame in frames:
        rows = {line[2:22].strip(): line[22:].split()
                for line in frame.splitlines()[2:]}
        assert rows["replicas live"] == ["2"], frame
        assert "tokens/s" in rows, frame


def test_fleet_reports_equal_jax(fleet_dir, capsys):
    fleet_dir, _ = fleet_dir
    subs = {p.name for p in fleet_dir.iterdir() if p.is_dir()}
    assert {"replica0", "replica1"} <= subs
    for d in (fleet_dir, fleet_dir / "replica0", fleet_dir / "replica1"):
        _assert_reports_equal(d, capsys)
    timelines = {t["trace_id"]: t for t in
                 report.stitch_run_dir(str(fleet_dir))}
    assert {f"k{i}" for i in range(4)} <= set(timelines)
    assert all(timelines[f"k{i}"]["complete"] for i in range(4))
    partial = timelines["direct"]
    assert not partial["complete"] and partial["replicas"] == ["replica0"]
    assert "1 partial" in report.render_trace_report(str(fleet_dir))


# ------------------------------------------------------ the schema copy
def _breakages():
    """name -> a function that breaks a copied run dir."""
    def edit_summary(fn):
        def go(d):
            s = _summary(d)
            fn(s)
            (d / "summary.json").write_text(json.dumps(s))
        return go

    def append(name, line):
        def go(d):
            with open(d / name, "a") as f:
                f.write(line + "\n")
        return go

    return {
        "good": lambda d: None,
        "no_summary": lambda d: (d / "summary.json").unlink(),
        "no_spans": lambda d: (d / "spans.jsonl").unlink(),
        "schema_version": edit_summary(
            lambda s: s.update(schema_version=3)),
        "missing_key": edit_summary(lambda s: s.pop("collectives")),
        "bad_hist": edit_summary(
            lambda s: s["histograms"]["metric.loss"].pop("p99")),
        "bad_counter": edit_summary(
            lambda s: s["counters"].update({"train.steps": "four"})),
        "cache_hits": edit_summary(
            lambda s: s["compile_cache"].update(hits=1.5)),
        "metrics_step": append("metrics.jsonl",
                               '{"step": -1, "ts": 1.0, "loss": 2.0}'),
        "metrics_json": append("metrics.jsonl", "{not json"),
        "metrics_value": append("metrics.jsonl",
                                '{"step": 5, "ts": 1.0, "x": [1]}'),
        "span_order": append("spans.jsonl", json.dumps(
            {"name": "a", "t0": 2.0, "t1": 1.0, "dur_s": -1.0,
             "attrs": {}})),
        "span_trace": append("spans.jsonl", json.dumps(
            {"name": "a", "t0": 1.0, "t1": 2.0, "dur_s": 1.0, "attrs": {},
             "trace_id": ""})),
        "event_kind": append("events.jsonl", json.dumps(
            {"schema_version": 1, "ts": 1.0, "kind": "no.such",
             "severity": "info", "attrs": {}})),
        "serve_marker": edit_summary(
            lambda s: s["counters"].update({"serve.admitted_total": 1})),
        "router_marker": edit_summary(
            lambda s: s["counters"].update({"router.retries_total": 1})),
    }


@pytest.mark.parametrize("name", sorted(_breakages()))
def test_schema_copy_equals_jax_on_run_dirs(name, train_dirs, tmp_path):
    port, _, _ = train_dirs
    d = tmp_path / name
    shutil.copytree(port, d)
    _breakages()[name](d)
    got = schema.check_run_dir(str(d))
    assert got == jschema.check_run_dir(str(d))
    assert (got == []) == (name == "good")


def _stats_cases():
    obs.REGISTRY.reset()
    obs.enable()
    obs.counter("serve.tokens_total").inc(3)
    obs.gauge("serve.queue_depth").set(1)
    obs.histogram("serve.ttft_s").observe(0.2)
    good = json.loads(json.dumps(obs.stats_snapshot()))
    obs.disable()
    fleet = {"stats_schema_version": 1, "kind": "fleet", "ts": 1.0,
             "replicas": [{"replica_id": 0, "live": True}],
             "fleet": {k: good[k] for k in ("counters", "gauges",
                                            "histograms")}}
    # "fleet" lacks the router block and the replica rows' fields.
    cases = {"replica": good, "fleet": fleet, "not_a_dict": [1, 2]}
    for key in ("stats_schema_version", "kind", "counters", "histograms"):
        cases[f"no_{key}"] = {k: v for k, v in good.items() if k != key}
    cases["bad_version"] = dict(good, stats_schema_version=9)
    cases["bad_kind"] = dict(good, kind="other")
    cases["bad_hist"] = dict(good, histograms={"serve.ttft_s": {"p50": 1}})
    cases["fleet_no_replicas"] = {k: v for k, v in fleet.items()
                                  if k != "replicas"}
    return cases


def test_schema_copy_equals_jax_on_stats_payloads():
    cases = _stats_cases()
    for name, body in cases.items():
        got = schema.check_stats_payload(body)
        assert got == jschema.check_stats_payload(body), name
        assert (got == []) == (name == "replica"), (name, got)


def test_schema_copy_equals_jax_on_expositions():
    obs.REGISTRY.reset()
    obs.install_windows(interval_s=10.0, retention_s=300.0)
    obs.enable()
    obs.counter("serve.tokens_total").inc(5)
    obs.histogram("serve.ttft_s").observe(0.3)
    obs.gauge("serve.queue_depth").set(2)
    good = obs.render_prometheus(obs.stats_snapshot(),
                                 obs.windows_payload())
    obs.disable()
    texts = {
        "good": good,
        "empty": "",
        "prefix": good.replace("nezha_serve_tokens_total",
                               "other_tokens_total"),
        "window": good.replace('window="60s"', 'window="7s"'),
        "value": good + "nezha_x_total not_a_number\n",
        "type": "# TYPE nezha_x nonsense\nnezha_x 1\n",
        "label": good + 'nezha_y{window="60s" 1\n',
    }
    for name, text in texts.items():
        got = schema.check_metrics_exposition(text)
        assert got == jschema.check_metrics_exposition(text), name
        if name == "good":
            assert got == []
    assert any(schema.check_metrics_exposition(t) for t in texts.values())


def test_schema_copy_pins_jax_names():
    pinned = [n for n in dir(jschema) if n.startswith("_")
              and isinstance(getattr(jschema, n), (set, frozenset))]
    assert "_DIST_COUNTERS" in pinned and "_PINNED_SPANS" in pinned
    for name in pinned:
        assert getattr(schema, name) == getattr(jschema, name), name
    for name in ("SCHEMA_VERSION", "STATS_SCHEMA_VERSION",
                 "EVENT_SCHEMA_VERSION", "EVENT_KINDS", "EXPOSITION_PREFIX",
                 "EXPOSITION_WINDOW_LABELS"):
        assert getattr(schema, name) == getattr(jschema, name), name


# ------------------------------------------------ prefetcher, coordinator
def test_prefetcher_records_stalls_and_depth(tmp_path):
    def slow():
        for i in range(4):
            time.sleep(0.05)
            yield {"x": np.full((2,), i, np.float32)}

    obs.start_run(str(tmp_path / "run"), windows=False)
    p = Prefetcher(slow(), depth=2, device="cpu")
    try:
        assert [int(b["x"][0]) for b in p] == [0, 1, 2, 3]
    finally:
        p.close()
    snap = obs.REGISTRY.snapshot()
    obs.end_run()
    assert p.stalls >= 1
    assert snap["counters"]["prefetch.stalls"] == p.stalls
    hist = snap["histograms"]["prefetch.stall_seconds"]
    assert hist["count"] == p.stalls
    assert hist["sum"] == pytest.approx(p.stall_seconds, rel=1e-9)
    assert "prefetch.queue_depth" in snap["gauges"]


def test_injected_join_fault_is_absorbed_by_the_backoff():
    """JAX's ``test_join_retries_through_injected_dial_failure``: a fault
    on the first dial attempt is a counted retry; the second lands."""
    faults.install(faults.FaultPlan.parse("dist.join:error@1"))
    obs.enable()
    try:
        with dist.Coordinator(world_size=1) as coord:
            g = dist.join("127.0.0.1", coord.port, backoff_base_s=0.01)
            assert g.rank == 0
            g.put("k", b"v")
            assert g.get("k", timeout_s=5) == b"v"
            g.leave()
        assert faults.active().injected_counts == {"dist.join": 1}
        assert obs.counter("dist.join_retries_total").value == 1
    finally:
        obs.disable()


def test_checkpoint_save_fault_keeps_the_last_checkpoint(tmp_path):
    """A fault between the temporary file's fsync and its rename leaves
    the previous checkpoint the newest, no temporary file, and the CLI
    run failing: the JAX CLI's chaos drill through ``NEZHA_FAULT_PLAN``,
    armed for the run and restored after it."""
    ck = tmp_path / "ck"
    env_old = os.environ.get(faults.ENV_PLAN)
    os.environ[faults.ENV_PLAN] = "checkpoint.save:error@2"
    try:
        with pytest.raises(faults.InjectedFault):
            train_cli.run(train_cli.parse_args(
                TRAIN + ["--device", "cpu", "--ckpt-dir", str(ck),
                         "--run-dir", str(tmp_path / "run")]))
    finally:
        if env_old is None:
            os.environ.pop(faults.ENV_PLAN)
        else:
            os.environ[faults.ENV_PLAN] = env_old
    assert faults.active() is None
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000002.npz"]
    assert jschema.check_run_dir(str(tmp_path / "run")) == []
    spans = [json.loads(x) for x in
             (tmp_path / "run" / "spans.jsonl").read_text().splitlines()]
    saves = [s for s in spans if s["name"] == "checkpoint.save"]
    assert [s["attrs"]["step"] for s in saves] == [2, 4]
    assert "error" in saves[-1]["attrs"]


def test_train_side_fault_points_are_ported():
    import ast
    found = set()
    for path in (ROOT / "nezha_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "faults"
                    and node.func.attr == "point" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                found.add(node.args[0].value)
    assert {"checkpoint.save", "dist.join"} <= found
