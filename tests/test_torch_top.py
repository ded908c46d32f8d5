"""``nezha_tpu_torch.cli.top`` against the JAX package's ``nezha-top``:
the same exposition text gives the same frames (every window, a fleet
roll-up, a single replica, an empty body), and ``main --iterations``
polls a port HTTP server on the CPU (tiny preset), exits 0, and renders
the rows JAX's ``main`` renders from the same server; a dead endpoint
gives up after five failed polls with exit 1, as JAX's does."""

import http.client
import json
import socket
import threading

import numpy as np
import pytest

from nezha_tpu import obs as jobs
from nezha_tpu.cli import top as jtop
from nezha_tpu.obs import timeseries as jts
from nezha_tpu_torch import obs
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.cli import top
from nezha_tpu_torch.obs import timeseries as ts

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


class Clock:
    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


def _exposition(fleet: bool, seed: int = 0) -> str:
    """Prometheus text of a seeded registry with windows on a fake clock
    (a fleet's router instruments too when ``fleet``)."""
    clock = Clock()
    obs.REGISTRY.reset()
    obs.install_windows(interval_s=10.0, retention_s=300.0, clock=clock)
    obs.enable()
    rng = np.random.RandomState(seed)
    for i in range(400):
        clock.t += float(rng.rand())
        obs.counter("serve.admitted_total").inc()
        obs.counter("serve.tokens_total").inc(int(rng.randint(1, 9)))
        if i % 37 == 0:
            obs.counter("serve.rejected_total").inc()
        obs.gauge("serve.queue_depth").set(float(rng.randint(0, 4)))
        obs.gauge("serve.batch_occupancy").set(float(rng.rand()))
        obs.histogram("serve.ttft_s").observe(float(rng.lognormal(-2)))
        obs.histogram("serve.tpot_s").observe(float(rng.rand() * 0.05))
        if fleet:
            obs.gauge("router.replicas_live").set(2.0)
            obs.histogram("router.route_s").observe(float(rng.rand()))
            if i % 100 == 0:
                obs.counter("router.replica_restarts_total").inc()
    text = obs.render_prometheus(obs.stats_snapshot(),
                                 obs.windows_payload())
    obs.disable()
    obs.uninstall_windows()
    return text


@pytest.mark.parametrize("fleet", [True, False])
@pytest.mark.parametrize("window", ["10s", "60s", "300s"])
def test_frames_equal_jax(fleet, window):
    text = _exposition(fleet, seed=int(fleet))
    got = top.render_top(ts.parse_prometheus(text), window,
                         url="http://h:1")
    want = jtop.render_top(jts.parse_prometheus(text), window,
                           url="http://h:1")
    assert got == want
    assert ("replicas live" in got) == fleet and "tokens/s" in got


def test_empty_body_frame_equals_jax():
    assert top.render_top(ts.parse_prometheus(""), "60s") == \
        jtop.render_top(jts.parse_prometheus(""), "60s")
    assert "no recognized samples" in top.render_top([], "60s")


def test_parser_choices_equal_jax():
    mine, theirs = top.build_parser(), jtop.build_parser()
    for argv in (["u"], ["u", "--interval", "0.5", "--iterations", "3",
                         "--window", "300s", "--no-clear"]):
        assert vars(mine.parse_args(argv)) == vars(theirs.parse_args(argv))
    assert top._ROWS == jtop._ROWS


def test_main_polls_a_port_server(capsys, tmp_path):
    """A server with a run dir (its registry and windows on)."""
    args = serve_cli.build_parser().parse_args(
        SERVE + ["--http", "0", "--run-dir", str(tmp_path / "run")])
    box, ready, drain = {}, threading.Event(), threading.Event()

    def cb(srv):
        box["port"] = srv.server_address[1]
        ready.set()

    th = threading.Thread(target=lambda: box.update(rc=serve_cli.run(
        args, ready_cb=cb, drain_event=drain)), daemon=True)
    th.start()
    assert ready.wait(120)
    url = f"http://127.0.0.1:{box['port']}"
    try:
        conn = http.client.HTTPConnection("127.0.0.1", box["port"],
                                          timeout=60)
        conn.request("POST", "/generate", body=json.dumps({
            "prompt_tokens": [4, 6, 8], "max_new_tokens": 3}).encode())
        assert conn.getresponse().status == 200
        conn.close()
        capsys.readouterr()
        assert top.main([url, "--iterations", "2", "--interval", "0.05",
                         "--no-clear"]) == 0
        mine = capsys.readouterr().out
        assert jtop.main([url, "--iterations", "1", "--no-clear"]) == 0
        theirs = capsys.readouterr().out
    finally:
        drain.set()
        th.join(60)
    assert box["rc"] == 0
    frames = [f for f in mine.split("nezha-top  ") if f]
    assert len(frames) == 2

    def labels(frame):
        return [line.split("  ")[1] for line in frame.splitlines()[2:]]

    assert labels(frames[0]) == labels(theirs.split("nezha-top  ")[1])
    assert any(line.strip().startswith("tokens/s")
               for line in frames[0].splitlines())


def test_main_gives_up_on_a_dead_endpoint(capsys):
    with socket.socket() as s:   # grab and release: a dead port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert top.main([f"http://127.0.0.1:{port}", "--interval", "0.01"]) == 1
    err = capsys.readouterr().err
    assert err.count("fetch failed") == 5 and "giving up" in err
