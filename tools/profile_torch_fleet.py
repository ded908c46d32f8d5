"""Where the time goes in the port's serving fleet, on one CUDA card.

    python3 tools/profile_torch_fleet.py [--out f.json] [--variants ...]

Sends ``chip_smoke.py``'s serve-phase requests (GPT-2 124M, seeded
random weights, bf16, blocks of 16, ``max_len`` 1024, 256-wide prefill
chunks, eight prompts of 5-900 tokens, 32 greedy tokens each), all at
once, to each variant twice (the first run warms it), and reports the
second run: its wall seconds, each request's latency at the client and
the replica's own ``ttft_s`` and ``latency_s``, the decode steps the
engines ran and the run's wall over them (ms a step, host clock):

- ``engine``: a ``Scheduler`` driven in this thread, no HTTP;
- ``http``: one replica's ``run_http`` in a thread of this process;
- ``fleet``: ``serve --replicas 2 --replica-backend thread`` with the
  default probe and digest intervals (0.5 s, 2 s); ``fleet_fast`` with
  ``chip_smoke.py``'s (0.1 s, 0.5 s); ``fleet_run_dir`` that with
  ``--run-dir`` (the registry on); ``fleet_fast_switch`` with Python's
  thread switch interval cut from 5 ms to 0.5 ms; ``fleet_no_yield``
  with the scheduler's yield to waiting threads off
  (``serve.scheduler.YIELD_S = 0``), and ``http_no_yield`` the same for
  one replica.

Prints one JSON line a variant and writes them all to ``--out``. It
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nezha_tpu_torch.cli import serve as serve_cli  # noqa: E402

ARGV = ["--random-init", "--max-len", "1024", "--max-prefill-len", "256",
        "--kv-block-size", "16", "--max-batch-size", "8",
        "--max-new-tokens", "32"]
FLEETS = {"fleet": ["--probe-interval", "0.5", "--digest-interval", "2"],
          "fleet_fast": ["--probe-interval", "0.1", "--digest-interval",
                         "0.5"],
          "fleet_run_dir": ["--probe-interval", "0.1", "--digest-interval",
                            "0.5", "--run-dir", "RUN_DIR"],
          "fleet_fast_switch": ["--probe-interval", "0.1",
                                "--digest-interval", "0.5"],
          "fleet_no_yield": ["--probe-interval", "0.1", "--digest-interval",
                             "0.5"]}
VARIANTS = ["engine", "http", "http_no_yield"] + list(FLEETS)


def prompts(vocab: int):
    g = torch.Generator().manual_seed(1)

    def toks(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    prefix = toks(128)
    return [toks(5), toks(37), toks(200), toks(300), toks(600), toks(900),
            prefix + toks(20), prefix + toks(45)]


def post(port: int, obj: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body=json.dumps(obj).encode())
        resp = conn.getresponse()
        out = json.loads(resp.read())
        return resp.status, out, time.perf_counter() - t0
    finally:
        conn.close()


def send_all(port: int, tag: str, ps) -> list:
    out = [None] * len(ps)

    def one(i):
        out[i] = post(port, {"id": f"{tag}{i}", "prompt_tokens": ps[i],
                             "max_new_tokens": 32})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(ps))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for code, ans, _ in out:
        if code != 200:
            raise SystemExit(f"{tag}: {code} {ans}")
    return out


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(int(q / 100 * len(xs)), len(xs) - 1)]


def summary(name, wall, answers, steps):
    client = [s for _, _, s in answers]
    ttft = [a["ttft_s"] for _, a, _ in answers]
    lat = [a["latency_s"] for _, a, _ in answers]
    return {"variant": name, "wall_s": wall, "decode_steps": steps,
            "ms_per_step": 1e3 * wall / steps if steps else None,
            "client_s": {"p50": pct(client, 50), "max": max(client)},
            "replica_ttft_s": {"p50": pct(ttft, 50), "max": max(ttft)},
            "replica_latency_s": {"p50": pct(lat, 50), "max": max(lat),
                                  "mean": statistics.mean(lat)}}


def run_engine(ps):
    from nezha_tpu_torch.serve import Request
    sched = serve_cli.build_scheduler(
        serve_cli.build_parser().parse_args(ARGV))
    rows = []
    for rep in range(2):
        steps0 = sched.engine.step_calls
        t0 = time.perf_counter()
        reqs = [Request(prompt=p, max_new_tokens=32, request_id=f"e{rep}{i}")
                for i, p in enumerate(ps)]
        for r in reqs:
            sched.submit(r)
        sched.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = [sched.results[r.request_id] for r in reqs]
        answers = [(200, {"ttft_s": x.ttft_s, "latency_s": x.latency_s}, 0.0)
                   for x in res]
        rows.append(summary("engine", wall, answers,
                            sched.engine.step_calls - steps0))
    return rows[-1]


def no_yield(name):
    """Turn the scheduler's yield off for a ``*_no_yield`` variant ->
    the value to restore."""
    from nezha_tpu_torch.serve import scheduler
    old = scheduler.YIELD_S
    if name.endswith("_no_yield"):
        scheduler.YIELD_S = 0
    return old


def restore_yield(old):
    from nezha_tpu_torch.serve import scheduler
    scheduler.YIELD_S = old


def run_http(ps, name="http"):
    args = serve_cli.build_parser().parse_args(ARGV + ["--http", "0"])
    sched = serve_cli.build_scheduler(args)
    ready, drain, box = threading.Event(), threading.Event(), {}

    def cb(server):
        box["port"] = server.server_address[1]
        ready.set()

    th = threading.Thread(target=serve_cli.run_http, args=(sched, args, 0),
                          kwargs=dict(ready_cb=cb, drain=drain), daemon=True)
    old = no_yield(name)
    th.start()
    ready.wait(120)
    try:
        for rep in range(2):
            steps0 = sched.engine.step_calls
            t0 = time.perf_counter()
            answers = send_all(box["port"], f"h{rep}", ps)
            wall = time.perf_counter() - t0
        return summary(name, wall, answers,
                       sched.engine.step_calls - steps0)
    finally:
        drain.set()
        th.join(60)
        restore_yield(old)


def run_fleet(name, ps, tmp):
    extra = [a.replace("RUN_DIR", os.path.join(tmp, name))
             for a in FLEETS[name]]
    args = serve_cli.build_parser().parse_args(
        ARGV + ["--http", "0", "--replicas", "2", "--replica-backend",
                "thread"] + extra)
    ready, drain, box = threading.Event(), threading.Event(), {}

    def cb(server):
        box["server"] = server
        ready.set()

    old = sys.getswitchinterval()
    if name.endswith("_switch"):
        sys.setswitchinterval(0.0005)
    old_yield = no_yield(name)
    th = threading.Thread(target=lambda: serve_cli.run(
        args, ready_cb=cb, drain_event=drain), daemon=True)
    th.start()
    try:
        ready.wait(300)
        srv = box["server"]
        srv.router.wait_live(2, 300)
        port = srv.server_address[1]
        scheds = [r.handle.worker._sched for r in srv.supervisor.replicas()]
        for rep in range(2):
            steps0 = sum(s.engine.step_calls for s in scheds)
            t0 = time.perf_counter()
            answers = send_all(port, f"f{rep}", ps)
            wall = time.perf_counter() - t0
            steps = sum(s.engine.step_calls for s in scheds) - steps0
        row = summary(name, wall, answers, steps)
        row["steps_by_replica"] = [s.engine.step_calls for s in scheds]
        return row
    finally:
        drain.set()
        th.join(120)
        sys.setswitchinterval(old)
        restore_yield(old_yield)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", nargs="+", default=VARIANTS,
                   choices=VARIANTS)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    ps = prompts(gpt2_for_preset("full", seed=0, device="cuda").cfg
                 .vocab_size)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.variants:
            if name == "engine":
                row = run_engine(ps)
            elif name.startswith("http"):
                row = run_http(ps, name)
            else:
                row = run_fleet(name, ps, tmp)
            row["card"] = card
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
