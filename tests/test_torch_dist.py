"""The port's control plane and process groups on the CPU: the native
coordinator's binding (``nezha_tpu_torch.dist``, built from
``csrc/coordinator.cpp`` alone) through the cases of tests/test_dist.py
that do not rejoin, ``init_torch_distributed`` and the collectives over
gloo in worker processes (tests/torch_dist_worker.py) against JAX's under
``shard_map``, and the train CLI across processes: a world of two
through the coordinator (dp against one process; ZeRO-1 saved per shard
at world 2 and resumed at world 1) and ``--on-failure stop`` when a peer
dies. Every rendezvous binds port 0 and every child is joined with a
timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from nezha_tpu import parallel as jax_parallel
from nezha_tpu.parallel._compat import shard_map
from nezha_tpu_torch import dist
from nezha_tpu_torch.dist import native
from torch_dist_worker import ROOT, run_world


def _run_ranks(world, fn, **coord_kwargs):
    """A coordinator, ``world`` clients on threads, fn(group) on each;
    -> rank-indexed results."""
    with dist.Coordinator(world_size=world, **coord_kwargs) as coord:
        results = [None] * world
        errors = []
        done = threading.Barrier(world)

        def worker():
            try:
                with dist.join("127.0.0.1", coord.port) as g:
                    results[g.rank] = fn(g)
                    done.wait(timeout=30)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        return results


def test_library_builds_alone_under_build():
    path = native.build_library(native.SOURCE, "coordinator",
                                "libnezha_coord.so", native.NativeBuildError)
    assert path.is_relative_to(ROOT / "build" / "nezha_tpu_torch")
    assert native.load_library().nz_coord_start


def test_rendezvous_assigns_unique_ranks():
    ranks = _run_ranks(4, lambda g: (g.rank, g.world_size))
    assert sorted(r for r, _ in ranks) == [0, 1, 2, 3]
    assert all(w == 4 for _, w in ranks)


def test_rank_hint_honored():
    with dist.Coordinator(world_size=2) as coord:
        g1 = dist.join("127.0.0.1", coord.port, rank_hint=1)
        assert g1.rank == 1
        g0 = dist.join("127.0.0.1", coord.port)
        assert g0.rank == 0
        g0.leave()
        g1.leave()


def test_kv_put_get_blocking_and_large_values():
    blob = bytes(range(256)) * 1024  # larger than the first 64 KiB buffer

    def fn(g):
        if g.rank == 0:
            time.sleep(0.1)  # rank 1 really blocks on get
            g.put("topo", b"mesh:2x2")
            g.put("big", blob)
        return g.get("topo", timeout_s=10), g.get("big", timeout_s=10)

    assert _run_ranks(2, fn) == [(b"mesh:2x2", blob)] * 2


def test_get_timeout_raises():
    with dist.Coordinator(world_size=1) as coord:
        with dist.join("127.0.0.1", coord.port) as g:
            with pytest.raises(dist.CoordinatorError):
                g.get("never-put", timeout_s=0.2)


def test_barrier_synchronizes_and_is_reusable():
    order = []
    lock = threading.Lock()

    def fn(g):
        time.sleep(0.05 * g.rank)
        with lock:
            order.append(("arrive", g.rank))
        g.barrier(timeout_s=10)
        with lock:
            order.append(("pass", g.rank))
        for _ in range(4):
            g.barrier(timeout_s=10)
        return True

    assert all(_run_ranks(3, fn))
    arrivals = [i for i, (ev, _) in enumerate(order) if ev == "arrive"]
    passes = [i for i, (ev, _) in enumerate(order) if ev == "pass"]
    assert max(arrivals) < min(passes)


def test_broadcast_all_gather_and_fresh_rounds():
    def fn(g):
        b = g.broadcast(b"root-data" if g.rank == 0 else None, root=0,
                        timeout_s=10)
        r1 = g.all_gather(f"a{g.rank}".encode(), timeout_s=10)
        r2 = g.all_gather(f"b{g.rank}".encode(), timeout_s=10)
        return b, r1, r2

    for b, r1, r2 in _run_ranks(3, fn):
        assert b == b"root-data"
        assert r1 == [b"a0", b"a1", b"a2"]
        assert r2 == [b"b0", b"b1", b"b2"]


def test_incr_is_atomic_across_ranks():
    vals = sum(_run_ranks(4, lambda g: [g.incr("ctr") for _ in range(10)]),
               [])
    assert sorted(vals) == list(range(40))


def _wait_failed(g, timeout=5.0):
    deadline = time.time() + timeout
    failed = []
    while time.time() < deadline and not failed:
        failed = g.failed_ranks()
        time.sleep(0.05)
    return failed


def test_failure_detection_on_drop_is_counted_once():
    """A dropped peer counts once in the registry's
    ``dist.heartbeat_lost_total``, with one ``dist.failure`` span."""
    from nezha_tpu_torch import obs

    obs.enable()
    try:
        lost = obs.counter("dist.heartbeat_lost_total")
        before, spans_before = lost.value, len(obs.REGISTRY.spans)
        with dist.Coordinator(world_size=2,
                              heartbeat_timeout_s=0.5) as coord:
            g0 = dist.join("127.0.0.1", coord.port,
                           heartbeat_interval_s=0.1)
            g1 = dist.join("127.0.0.1", coord.port,
                           heartbeat_interval_s=0.1)
            assert g0.failed_ranks() == []
            g1.close()  # abrupt: no LEAVE
            assert _wait_failed(g0) == [1]
            assert g0.failed_ranks() == [1]   # the same transition
            assert lost.value == before + 1
            g0.leave()
        names = [s["name"] for s in obs.REGISTRY.spans[spans_before:]]
        assert names.count("dist.failure") == 1, names
        assert names.count("dist.join") == 2 and "dist.leave" in names
    finally:
        obs.disable()


def test_graceful_leave_is_not_failure_and_frees_the_slot():
    with dist.Coordinator(world_size=2, heartbeat_timeout_s=0.5) as coord:
        g0 = dist.join("127.0.0.1", coord.port, heartbeat_interval_s=0.1)
        g1 = dist.join("127.0.0.1", coord.port, heartbeat_interval_s=0.1)
        g1.leave()
        time.sleep(1.0)  # well past the heartbeat timeout
        assert g0.failed_ranks() == []
        g2 = dist.join("127.0.0.1", coord.port)
        assert g2.rank == 1
        g2.leave()
        g0.leave()


def test_client_connects_before_coordinator_up():
    holder, result = {}, {}

    def late_client():
        while "port" not in holder:
            time.sleep(0.01)
        g = dist.join("127.0.0.1", holder["port"], timeout_s=10)
        result["rank"] = g.rank
        g.leave()

    t = threading.Thread(target=late_client)
    t.start()
    time.sleep(0.2)
    with dist.Coordinator(world_size=1) as coord:
        holder["port"] = coord.port
        t.join(timeout=10)
    assert result["rank"] == 0


def test_blocking_wait_does_not_trip_failure_detector():
    with dist.Coordinator(world_size=2, heartbeat_timeout_s=0.6) as coord:
        g0 = dist.join("127.0.0.1", coord.port, heartbeat_interval_s=0.2)
        g1 = dist.join("127.0.0.1", coord.port, heartbeat_interval_s=0.2)
        got = {}
        t = threading.Thread(target=lambda: got.setdefault(
            "v", g1.get("slow-key", timeout_s=10)))
        t.start()
        time.sleep(1.5)  # past the heartbeat timeout while g1 blocks
        assert g0.failed_ranks() == []
        g0.put("slow-key", b"done")
        t.join(timeout=10)
        assert got["v"] == b"done"
        g1.leave()
        g0.leave()


def test_peer_death_during_barrier_is_detected():
    with dist.Coordinator(world_size=2, heartbeat_timeout_s=0.5) as coord:
        g0 = dist.join("127.0.0.1", coord.port, heartbeat_interval_s=0.1)
        g1 = dist.join("127.0.0.1", coord.port, heartbeat_interval_s=0.1)
        err = {}

        def waiter():
            try:
                g0.barrier(timeout_s=5)
            except dist.CoordinatorError as e:
                err["e"] = e

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.3)
        g1.close()  # dies mid-barrier
        assert _wait_failed(g0) == [1]
        t.join(timeout=10)
        assert "e" in err
        g0.leave()


def test_join_timeout_is_typed_and_counted():
    import socket

    with socket.socket() as s:   # grab and release: a dead port
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    from nezha_tpu_torch import obs

    obs.enable()
    try:
        before = obs.counter("dist.join_retries_total").value
        t0 = time.monotonic()
        with pytest.raises(dist.JoinTimeout):
            dist.join("127.0.0.1", dead_port, timeout_s=1.0,
                      attempt_timeout_s=0.2, backoff_base_s=0.02)
        assert time.monotonic() - t0 < 5.0
        assert obs.counter("dist.join_retries_total").value > before
    finally:
        obs.disable()
    assert issubclass(dist.JoinTimeout, dist.CoordinatorError)


# ------------------------------------------------- torch.distributed
def test_init_torch_distributed_two_processes(tmp_path):
    """Two processes join, rank 0 advertises its TCPStore through the
    coordinator, both enter init_process_group (gloo) and all-reduce."""
    ranks = run_world("launch", 2, None, tmp_path)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["sum"], [3.0, 3.0, 3.0])
        assert (r["backend"], r["world"], r["rank"], r["coord_rank"]) == \
            ("gloo", 2, rank, rank)


def test_backend_follows_the_device():
    assert dist.backend_for("cuda") == "nccl"
    assert dist.backend_for("cuda:1") == "nccl"
    assert dist.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        dist.backend_for("meta")


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_jax(world, tmp_path):
    r = np.random.RandomState(world)
    x = {"v": r.randn(world, 2 * world).astype(np.float32),
         "m": r.randn(world, 3, 2).astype(np.float32),
         "i": r.randint(0, 9, (world, world)).astype(np.int32)}
    ranks = run_world("collectives", world, x, tmp_path)
    mesh = jax_parallel.make_mesh({"dp": world},
                                  devices=jax.devices()[:world])

    def body(t):
        t = jax.tree_util.tree_map(lambda a: a[0], t)
        g = jax_parallel.all_gather(t, "dp")
        out = {"sum": jax_parallel.all_reduce_sum(t, "dp"),
               "mean": jax_parallel.all_reduce_mean(
                   {k: t[k] for k in ("v", "m")}, "dp"),
               "gather0": g, "rs": jax_parallel.reduce_scatter(g, "dp"),
               "gather1": jax_parallel.all_gather(t["m"], "dp", axis=1),
               "stack": jax_parallel.all_gather(t["m"], "dp", tiled=False)}
        return jax.tree_util.tree_map(lambda a: a[None], out)

    spec = {k: P("dp") for k in x}
    want = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,),
                             out_specs=P("dp")))(
        {k: jnp.asarray(v) for k, v in x.items()})
    for rank, got in enumerate(ranks):
        for op in ("sum", "gather0", "rs"):
            for k in x:
                np.testing.assert_allclose(got[op][k],
                                           np.asarray(want[op][k][rank]),
                                           rtol=1e-6, err_msg=f"{op} {k}")
        for k in ("v", "m"):
            np.testing.assert_allclose(got["mean"][k],
                                       np.asarray(want["mean"][k][rank]),
                                       rtol=1e-6)
        np.testing.assert_allclose(got["mean"]["i"], x["i"].mean(axis=0),
                                   rtol=1e-6)
        for op in ("gather1", "stack"):
            np.testing.assert_array_equal(got[op],
                                          np.asarray(want[op][rank]))
        # reduce_scatter along axis 1 of the axis-1 gather: the sum of
        # ``world`` identical gathers, this rank's columns.
        np.testing.assert_allclose(got["rs1"], world * x["m"][rank],
                                   rtol=1e-6)
        assert got["bytes"]["all_reduce"] > 0


def test_eval_splits_rows_and_adds_sums_over_ranks(tmp_path):
    """The train CLI's eval at world 2: each rank evaluates its rows of
    every global batch (5 rows: 2 and 3; 1 row: none and 1) and the sums
    are added over the group, so both ranks report one process's
    metrics over the whole batches (the port's ``evaluate``, held to
    JAX's in test_torch_train.py) within rtol 1e-6; ``max_batches``
    counts global batches."""
    import torch

    from nezha_tpu_torch.train.eval import evaluate, lm_token_stats
    from torch_dist_worker import build_model

    torch.manual_seed(0)
    model = build_model("gpt2")
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    r = np.random.RandomState(0)
    batches = [{"tokens": r.randint(0, 512, (n, 17)).astype(np.int32)}
               for n in (5, 1, 4)]
    ranks = run_world("eval", 2, {"state_dict": sd, "batches": batches,
                                  "max_batches": 2}, tmp_path)
    want = evaluate(model, iter(batches), lm_token_stats, max_batches=2)
    assert [rk["rows"] for rk in ranks] == [[2], [3, 1]]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    got = ranks[0]["metrics"]
    assert got["count"] == want["count"] == 6 * 16
    assert got["batches"] == want["batches"] == 2
    np.testing.assert_allclose(got["nll_sum"], want["nll_sum"], rtol=1e-6)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-6)


# --------------------------------------------------------------- CLI
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _cli(*argv):
    return [sys.executable, "-m", "nezha_tpu_torch.cli.train", "--device",
            "cpu", "--model-preset", "tiny", *argv]


def _final(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])["final"]


def _wait_all(procs, timeout=180):
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return outs


def test_cli_dp_world2_matches_one_process():
    """gpt2_124m's dp at world 2 through the coordinator: each rank
    trains on its half of the global batch; the final loss is the one
    process's over the whole batch. The final eval too: each rank
    evaluates its half of every eval batch and the sums are added over
    the group, so both ranks report the one process's token count and
    perplexity."""
    argv = ["--config", "gpt2_124m", "--steps", "3", "--batch-size", "4",
            "--seq-len", "32", "--eval", "--eval-batches", "2"]
    with dist.Coordinator(world_size=2) as coord:
        procs = [subprocess.Popen(
            _cli(*argv, "--coordinator", f"127.0.0.1:{coord.port}"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=_env()) for _ in range(2)]
        outs = _wait_all(procs)
    one = subprocess.run(_cli(*argv, "--parallel", "single"),
                         capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=180)
    assert one.returncode == 0, one.stderr
    want = _final(one.stdout)
    finals = [_final(out) for out, _ in outs]
    for got in finals:
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert got["eval_count"] == want["eval_count"] > 0
        assert got["eval_batches"] == want["eval_batches"] == 2
        np.testing.assert_allclose(got["eval_perplexity"],
                                   want["eval_perplexity"], rtol=1e-4)
    assert finals[0]["eval_nll_sum"] == finals[1]["eval_nll_sum"]
    errs = sorted(err for _, err in outs)
    assert sum('"parallel": {"mode": "dp", "world": 2' in e
               for e in errs) == 1   # log lines from rank 0 only


def test_cli_zero1_world2_saves_per_shard_and_resumes_at_world1(tmp_path):
    """bert_base_zero1 at world 2, rank 0 serving the coordinator on a
    free port: per-shard saves by both ranks, then a resume at world 1
    (--mesh dp=1) from step_4.sharded."""
    ck = str(tmp_path / "ck")
    argv = ["--config", "bert_base_zero1", "--steps", "4", "--batch-size",
            "4", "--ckpt-dir", ck, "--ckpt-every", "2", "--ckpt-keep", "1"]
    err0 = open(tmp_path / "rank0.err", "w+")
    procs = [subprocess.Popen(
        _cli(*argv, "--coordinator", "127.0.0.1:0", "--serve-coordinator",
             "--world-size", "2"), stdout=subprocess.PIPE, stderr=err0,
        text=True, cwd=ROOT, env=_env())]
    try:
        deadline = time.monotonic() + 60
        port = None
        while port is None:
            assert time.monotonic() < deadline and procs[0].poll() is None
            for line in (tmp_path / "rank0.err").read_text().splitlines():
                if line.startswith("coordinator: serving"):
                    port = int(line.split()[2].rpartition(":")[2])
            time.sleep(0.05)
        procs.append(subprocess.Popen(
            _cli(*argv, "--coordinator", f"127.0.0.1:{port}"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=_env()))
        _wait_all(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        err0.close()
    d = Path(ck)
    assert sorted(p.name for p in d.glob("step_*")) == \
        ["step_00000004.sharded"]
    step = d / "step_00000004.sharded"
    assert sorted(p.name for p in step.iterdir()) == [
        "COMPLETE_p0", "COMPLETE_p1", "meta_p0.json", "meta_p1.json",
        "shards_p0.npz", "shards_p1.npz"]
    log0 = (tmp_path / "rank0.err").read_text()
    assert '"mode": "zero1", "world": 2' in log0 and '{"save"' in log0
    again = subprocess.run(_cli(*argv[:-4], "--ckpt-dir", ck, "--mesh",
                                "dp=1", "--steps", "1"),
                           capture_output=True, text=True, cwd=ROOT,
                           env=_env(), timeout=180)
    assert again.returncode == 0, again.stderr
    assert "resumed from step 4 (sharded)" in again.stderr
    assert _final(again.stdout)["step"] == 5


def test_cli_on_failure_stop_checkpoints_then_raises(tmp_path):
    """A peer dies mid-run: the loop notices at its next check, writes
    a checkpoint, then raises naming the rank."""
    from nezha_tpu_torch.cli.train import parse_args, run

    with dist.Coordinator(world_size=2, heartbeat_timeout_s=1.0) as coord:
        g1 = dist.join("127.0.0.1", coord.port, rank_hint=1,
                       heartbeat_interval_s=0.1)
        killer = threading.Timer(1.0, g1.close)  # abrupt: no LEAVE
        killer.start()
        ck = str(tmp_path / "ck")
        args = parse_args([
            "--config", "mlp_mnist", "--device", "cpu", "--steps",
            "100000", "--batch-size", "16", "--failure-check-every", "5",
            "--ckpt-dir", ck, "--coordinator", f"127.0.0.1:{coord.port}"])
        with pytest.raises(RuntimeError, match=r"peer rank\(s\) \[1\]"):
            run(args)
        killer.join()
    assert list(Path(ck).glob("step_*.npz"))


def test_trainer_on_failure_callback_follows_the_checkpoint(tmp_path):
    """``on_failure`` takes the place of the raise, as in JAX's
    ``Trainer.fit``: at a check that finds dead peers the loop saves,
    then calls it with their ranks, and training goes on."""
    from nezha_tpu_torch.cli.train import build_config
    from nezha_tpu_torch.train.loop import Trainer

    class Peers:   # a coordinator group whose rank 1 died after step 3
        def __init__(self):
            self.trainer = None

        def failed_ranks(self):
            return [1] if self.trainer.global_step > 3 else []

    calls = []
    ck = tmp_path / "ck"
    cfg = build_config("mlp_mnist", preset="tiny", steps=8, seed=0,
                       device="cpu")
    peers = Peers()

    def on_failure(failed):
        calls.append((trainer.global_step, failed,
                      sorted(p.name for p in ck.glob("step_*"))))

    trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn,
                      checkpoint_dir=str(ck), process_group=peers,
                      failure_check_every=2, on_failure=on_failure)
    peers.trainer = trainer
    trainer.initialize()
    last = trainer.fit(cfg.batches(8), 8)
    assert trainer.global_step == 8 and np.isfinite(last["loss"])
    assert [(s, f) for s, f, _ in calls] == [(4, [1]), (6, [1]), (8, [1])]
    assert calls[0][2] == ["step_00000004.npz"]
