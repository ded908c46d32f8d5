"""Elastic recovery in the port (``--on-failure rejoin``) on the CPU,
against the JAX package's behaviour (tests/test_cli.py's elastic cases,
tests/test_dist.py's rejoin cases):

- the full cycle through the train CLI in OS processes: rank 1 is
  SIGKILLed mid-run, rank 0 saves a rescue checkpoint and waits, a
  replacement started with ``--rank-hint 1`` resumes from it, rank 0
  reloads it and both finish; with no replacement rank 0 gives up after
  ``--rejoin-timeout`` with JAX's message;
- the argv refusals (JAX's, word for word, and the port's refusal of a
  mode that would start a ``torch.distributed`` group across processes);
- the Trainer with a stub process group: the save commits before the
  wait, the reload replaces the live state bitwise with the rescue
  checkpoint's, and the rate window restarts after the heal;
- the coordinator: a crashed rank's slot is reclaimed and the failure
  cleared, and the replacement joins the world's current collective round.

The rig's children run ``python -m nezha_tpu_torch.cli.train`` and import
no JAX.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nezha_tpu_torch import dist
from nezha_tpu_torch.cli import train as train_cli

ROOT = Path(__file__).resolve().parents[1]


class TwoRankElastic:
    """A two-rank ``mlp_mnist`` world of the port's train CLI under
    ``--on-failure rejoin`` (one shared ``--ckpt-dir``, the coordinator on
    rank 0, ``--parallel single``): per-rank stderr files, polling for a
    line, and every child reaped."""

    def __init__(self, tmp_path, rejoin_timeout="120"):
        self.tmp_path = tmp_path
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = str(ROOT) + os.pathsep + self.env.get(
            "PYTHONPATH", "")
        self.env.setdefault("OMP_NUM_THREADS", "2")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.ck = str(tmp_path / "ck")
        self.base = [sys.executable, "-m", "nezha_tpu_torch.cli.train",
                     "--config", "mlp_mnist", "--batch-size", "64",
                     "--device", "cpu", "--parallel", "single",
                     "--log-every", "25", "--failure-check-every", "5",
                     "--ckpt-dir", self.ck,
                     "--coordinator", f"127.0.0.1:{self.port}",
                     "--on-failure", "rejoin",
                     "--rejoin-timeout", str(rejoin_timeout)]
        self.procs = []
        self.errfiles = []

    def launch(self, tag, extra):
        errf = open(self.tmp_path / f"{tag}.err", "w+")
        self.errfiles.append(errf)
        p = subprocess.Popen(self.base + extra, stdout=subprocess.DEVNULL,
                             stderr=errf, text=True, env=self.env, cwd=ROOT)
        self.procs.append(p)
        return p

    def err(self, tag) -> str:
        return (self.tmp_path / f"{tag}.err").read_text()

    def wait_for(self, tag, needle, proc, timeout=120):
        """Poll a rank's stderr for ``needle`` while it stays alive."""
        deadline = time.monotonic() + timeout
        while needle not in self.err(tag):
            assert proc.poll() is None, self.err(tag)
            assert time.monotonic() < deadline, self.err(tag)
            time.sleep(0.1)

    def cleanup(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.errfiles:
            f.close()


def test_cli_elastic_rejoin_continues(tmp_path):
    """The whole cycle: kill -> rescue save and ``waiting for rejoin`` ->
    relaunch -> ``world healed; resumed from step N``; both ranks exit 0
    and rank 0's logged steps rise strictly to its horizon."""
    cluster = TwoRankElastic(tmp_path)
    try:
        r0 = cluster.launch("r0", ["--steps", "3000", "--serve-coordinator",
                                   "--world-size", "2"])
        r1 = cluster.launch("r1", ["--steps", "3000", "--rank-hint", "1"])
        # Killed once it has logged a metrics line: mid-training.
        cluster.wait_for("r1", '"step"', r1)
        r1.kill()
        r1.wait()
        cluster.wait_for("r0", "waiting for rejoin", r0)
        assert list(Path(cluster.ck).glob("step_*.npz"))   # the rescue
        r1b = cluster.launch("r1b", ["--steps", "200", "--rank-hint", "1"])
        assert r0.wait(timeout=240) == 0, cluster.err("r0")
        assert r1b.wait(timeout=240) == 0, cluster.err("r1b")
    finally:
        cluster.cleanup()
    e0 = cluster.err("r0")
    assert "world healed; resumed from step" in e0
    assert "resumed from step" in cluster.err("r1b")
    lines = [json.loads(line) for line in e0.splitlines()
             if line.startswith("{")]
    steps = [m["step"] for m in lines if "loss" in m]
    assert steps[-1] == 3000
    assert all(a < b for a, b in zip(steps, steps[1:]))
    rejoin = [m["rejoin"] for m in lines if "rejoin" in m]
    assert len(rejoin) == 1 and rejoin[0]["failed"] == [1]
    healed = int(e0.split("world healed; resumed from step ")[1].split()[0])
    assert rejoin[0]["step"] == rejoin[0]["detect_step"] == healed
    assert rejoin[0]["wait_s"] > 0 and rejoin[0]["reload_s"] > 0
    # The rescue save is one of rank 0's logged saves, at the heal step.
    saves = [m["save"]["step"] for m in lines if "save" in m]
    assert healed in saves and saves[-1] == 3000


def test_cli_rejoin_timeout_gives_up_loudly(tmp_path):
    """No replacement: after ``--rejoin-timeout`` the survivor raises
    JAX's message and exits nonzero, the rescue checkpoint on disk."""
    cluster = TwoRankElastic(tmp_path, rejoin_timeout="3")
    try:
        r0 = cluster.launch("r0", ["--steps", "3000", "--serve-coordinator",
                                   "--world-size", "2"])
        r1 = cluster.launch("r1", ["--steps", "3000", "--rank-hint", "1"])
        cluster.wait_for("r1", '"step"', r1)
        r1.kill()
        r1.wait()
        assert r0.wait(timeout=180) != 0
    finally:
        cluster.cleanup()
    assert "no replacement rejoined within 3s" in cluster.err("r0")
    assert list(Path(cluster.ck).glob("step_*.npz"))


# ------------------------------------------------------------ argv checks
BASE = ["--config", "mlp_mnist", "--steps", "1", "--batch-size", "8",
        "--on-failure", "rejoin"]


@pytest.mark.parametrize("extra,match", [
    ([], "needs --coordinator"),
    (["--coordinator", "127.0.0.1:1"], "needs --ckpt-dir"),
    (["--rejoin-timeout", "0", "--coordinator", "127.0.0.1:1",
      "--ckpt-dir", "/x"], "--rejoin-timeout must be > 0"),
    (["--rejoin-timeout", "nan", "--coordinator", "127.0.0.1:1",
      "--ckpt-dir", "/x"], "--rejoin-timeout must be > 0")])
def test_rejoin_argv_refusals_match_jax(extra, match):
    """JAX's checks, with its words; refused before any rendezvous (the
    coordinator address is never dialled)."""
    from nezha_tpu.cli.train import build_parser as jax_parser
    from nezha_tpu.cli.train import run as jax_run

    with pytest.raises(SystemExit, match=match) as mine:
        train_cli.run(train_cli.parse_args(BASE + extra + ["--device",
                                                           "cpu"]))
    # JAX's CLI checks --no-jax-distributed after these three; passing it
    # reaches the same refusal.
    with pytest.raises(SystemExit, match=match) as theirs:
        jax_run(jax_parser().parse_args(BASE + extra + [
            "--no-jax-distributed", "--platform", "cpu"]))
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("config,parallel", [
    ("gpt2_124m", "config"), ("mlp_mnist", "dp"),
    ("bert_base_zero1", "config"), ("resnet50_imagenet", "zero1")])
def test_rejoin_refuses_a_torch_distributed_mode(config, parallel):
    """dp and zero1 across processes would start a torch.distributed
    group, which cannot take a restarted process: refused before the
    rendezvous, pointing to --parallel single or --on-failure stop."""
    argv = ["--config", config, "--parallel", parallel, "--device", "cpu",
            "--model-preset", "tiny", "--on-failure", "rejoin",
            "--coordinator", "127.0.0.1:1", "--ckpt-dir", "/x"]
    with pytest.raises(SystemExit, match="torch.distributed") as e:
        train_cli.run(train_cli.parse_args(argv))
    assert "--parallel single" in str(e.value)
    assert "--on-failure stop" in str(e.value)


def test_rejoin_refuses_zero1_on_a_world_of_one(tmp_path):
    """JAX's mode refusal: ZeRO-1's per-rank chunks recover by a
    relaunch, also where the world is one process (no group across
    processes, so the check after the mode is resolved is the one that
    speaks)."""
    argv = ["--config", "bert_base_zero1", "--model-preset", "tiny",
            "--device", "cpu", "--steps", "1", "--mesh", "dp=1",
            "--on-failure", "rejoin", "--coordinator", "127.0.0.1:0",
            "--serve-coordinator", "--world-size", "1",
            "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(SystemExit,
                       match="supports the replicated-state modes"):
        train_cli.run(train_cli.parse_args(argv))


def test_rejoin_flags_parse_with_jax_defaults():
    from nezha_tpu.cli.train import build_parser as jax_parser

    assert "--rejoin-timeout" not in train_cli.NOT_PORTED_FLAGS
    mine = train_cli.parse_args(["--config", "mlp_mnist"])
    theirs = jax_parser().parse_args(["--config", "mlp_mnist"])
    for name in ("rejoin_timeout", "on_failure", "failure_check_every",
                 "rank_hint"):
        assert getattr(mine, name) == getattr(theirs, name), name
    assert train_cli.parse_args(["--config", "mlp_mnist",
                                 "--rejoin-timeout", "7"]).rejoin_timeout \
        == 7.0


# ------------------------------------------------- the Trainer, stubbed
class HealingPeers:
    """A coordinator group whose rank 1 dies after step ``die_after``:
    reported dead for ``wait_s`` seconds after the first report (the
    replacement's start-up), alive after. During the wait it scrambles
    the trainer's live weights and optimizer state, so that only a reload
    can bring them back; it records what the rescue save had put on disk
    when the wait began."""

    def __init__(self, ck: Path, die_after: int, wait_s: float = 0.3):
        self.ck, self.die_after, self.wait_s = ck, die_after, wait_s
        self.trainer = None
        self.first = None
        self.seen_on_disk = None

    def failed_ranks(self):
        t = self.trainer
        if self.first is None:
            if t.global_step <= self.die_after:
                return []
            self.first = time.monotonic()
            return [1]
        if time.monotonic() - self.first < self.wait_s:
            if self.seen_on_disk is None:
                self.seen_on_disk = sorted(p.name
                                           for p in self.ck.glob("step_*"))
                with torch.no_grad():
                    for p in t.model.parameters():
                        p.fill_(7.0)
                    for _, leaf in _tensors(t.step_fn.opt_state):
                        leaf.fill_(-3.0)
            return [1]
        return []


def _tensors(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, path + (k,))
    elif torch.is_tensor(tree):
        yield path, tree


def _mlp_trainer(ck, peers=None, **kw):
    from nezha_tpu_torch.train.loop import Trainer

    cfg = train_cli.build_config("mlp_mnist", preset="tiny", steps=8,
                                 seed=0, device="cpu")
    trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn,
                      checkpoint_dir=str(ck), process_group=peers,
                      failure_check_every=2 if peers else 0, **kw)
    if peers is not None:
        peers.trainer = trainer
    trainer.initialize()
    return trainer, cfg


def test_trainer_rejoin_saves_first_then_reloads_bitwise(tmp_path):
    from nezha_tpu_torch.train import checkpoint as ckpt

    ck = tmp_path / "ck"
    peers = HealingPeers(ck, die_after=3)
    trainer, cfg = _mlp_trainer(ck, peers, failure_mode="rejoin")
    trainer.fit(cfg.batches(8), 4)
    # The rescue save (step 4) had committed before the first wait poll.
    assert peers.seen_on_disk == ["step_00000004.npz"]
    assert trainer.global_step == 4
    assert [(r["step"], r["failed"]) for r in trainer.rejoins] == [(4, [1])]
    flat, step = ckpt.try_restore(str(ck), {k: v.dtype for k, v in
                                            trainer.state_dict().items()})
    assert step == 4
    live = trainer.state_dict()
    assert sorted(live) == sorted(flat)
    for key in flat:
        assert live[key].tobytes() == np.asarray(flat[key]).tobytes(), key
    # The loop goes on from the reload as an unbroken run would.
    ref, rcfg = _mlp_trainer(tmp_path / "ref")
    ref.fit(rcfg.batches(8), 6)
    healed, hcfg = _mlp_trainer(tmp_path / "ck2",
                                HealingPeers(tmp_path / "ck2", die_after=3),
                                failure_mode="rejoin")
    healed.fit(hcfg.batches(8), 6)
    assert healed.global_step == ref.global_step == 6
    for (n, a), (_, b) in zip(healed.model.state_dict().items(),
                              ref.model.state_dict().items()):
        assert torch.equal(a, b), n


class _StepClock:
    """The clock ``StepTimer`` reads: one second a step (advanced as the
    loop draws each batch) and ``HealingPeers.wait_s`` seconds for the
    heal, so a logged rate depends on the steps a window holds and not
    on how busy the host is."""

    def __init__(self):
        self.now = 100.0
        self.heal_end = None

    def perf_counter(self):
        return self.now

    def ticking(self, batches):
        for b in batches:
            self.now += 1.0
            yield b


def test_trainer_rejoin_restarts_the_rate_window(tmp_path, monkeypatch):
    """The heal wait is not in any logged rate: the step at the heal is
    not logged, and the window logged next opens after the wait and
    counts only the steps after the heal."""
    import types

    from nezha_tpu_torch.obs import metrics as obs_metrics

    clock = _StepClock()
    monkeypatch.setattr(obs_metrics, "time",
                        types.SimpleNamespace(perf_counter=clock.perf_counter))

    class ClockedPeers(HealingPeers):
        def failed_ranks(self):
            first = self.first is None
            failed = super().failed_ranks()
            if failed and first:   # the wait for the replacement
                clock.now += self.wait_s
                clock.heal_end = clock.now
            return failed

    ck = tmp_path / "ck"
    peers = ClockedPeers(ck, die_after=3, wait_s=3.0)
    logged = []
    trainer, cfg = _mlp_trainer(ck, peers, failure_mode="rejoin",
                                log_every=2,
                                metric_logger=lambda s, m: logged.append(m))
    opened = []
    start = trainer._timer.start

    def start_window():
        start()
        opened.append(clock.now)

    trainer._timer.start = start_window
    trainer.fit(clock.ticking(cfg.batches(8)), 6)
    assert [m["step"] for m in logged] == [2, 6]
    # The window logged at step 6 opened when the heal had ended; its two
    # steps (5 and 6) took two seconds. Counted from step 2 it would hold
    # four steps and the wait: 4 / 7 steps/s.
    assert opened[-1] == clock.heal_end
    assert logged[-1]["steps_per_sec"] == 1.0
    assert trainer.rejoins[0]["wait_s"] >= 3.0


def test_trainer_rejoin_timeout_and_recover_fn(tmp_path):
    ck = tmp_path / "ck"
    peers = HealingPeers(ck, die_after=1, wait_s=60.0)
    trainer, cfg = _mlp_trainer(ck, peers, failure_mode="rejoin",
                                rejoin_timeout_s=0.5)
    with pytest.raises(RuntimeError,
                       match=r"peer rank\(s\) \[1\] failed at step 2; no "
                             r"replacement rejoined within 0s"):
        trainer.fit(cfg.batches(8), 4)
    assert sorted(p.name for p in ck.glob("step_*")) == ["step_00000002.npz"]
    calls = []
    ck2 = tmp_path / "ck2"
    trainer, cfg = _mlp_trainer(ck2, HealingPeers(ck2, die_after=1),
                                failure_mode="rejoin",
                                recover_fn=lambda: calls.append(1))
    trainer.fit(cfg.batches(8), 3)
    assert calls == [1]


def test_trainer_rejoin_option_checks_match_jax(tmp_path):
    """JAX's constructor checks, with its messages."""
    from nezha_tpu.models.mlp import MLP as JaxMLP
    from nezha_tpu import optim as jax_optim
    from nezha_tpu.train.loop import Trainer as JaxTrainer
    from nezha_tpu_torch.train.loop import Trainer

    cfg = train_cli.build_config("mlp_mnist", preset="tiny", device="cpu")
    cases = [dict(failure_mode="elastic"),
             dict(failure_mode="rejoin"),
             dict(failure_mode="rejoin", checkpoint_dir=str(tmp_path),
                  on_failure=lambda f: None)]
    for kw in cases:
        with pytest.raises(ValueError) as mine:
            Trainer(cfg.model, cfg.optimizer, cfg.loss_fn, **kw)
        with pytest.raises(ValueError) as theirs:
            JaxTrainer(JaxMLP(), jax_optim.sgd(0.1), lambda *a: 0.0, **kw)
        assert str(mine.value) == str(theirs.value)


# ----------------------------------------------------- the coordinator
def test_crashed_rank_can_rejoin():
    """A rank crashes; its replacement reclaims the slot and clears the
    failure."""
    with dist.Coordinator(world_size=2, heartbeat_timeout_s=0.5) as coord:
        g0 = dist.join("127.0.0.1", coord.port, heartbeat_interval_s=0.1)
        g1 = dist.join("127.0.0.1", coord.port, heartbeat_interval_s=0.1)
        rank1 = g1.rank
        g1.close()  # crash
        deadline = time.time() + 5
        while time.time() < deadline and g0.failed_ranks() != [rank1]:
            time.sleep(0.05)
        assert g0.failed_ranks() == [rank1]
        g1b = dist.join("127.0.0.1", coord.port, rank_hint=rank1)
        assert g1b.rank == rank1
        assert g0.failed_ranks() == []
        g1b.leave()
        g0.leave()


def test_rejoined_rank_resumes_collective_rounds():
    """After one broadcast round, a crashed rank's replacement joins
    round 1, not round 0's stale entry."""
    with dist.Coordinator(world_size=2) as coord:
        g0 = dist.join("127.0.0.1", coord.port)
        g1 = dist.join("127.0.0.1", coord.port)
        r0 = {}

        def round_one():
            r0["v"] = g0.broadcast(b"addr-v1", root=0, timeout_s=10)

        t = threading.Thread(target=round_one)
        t.start()
        assert g1.broadcast(None, root=0, timeout_s=10) == b"addr-v1"
        t.join(timeout=10)
        g1.close()  # crash after round 0
        g1b = dist.join("127.0.0.1", coord.port, rank_hint=1)

        def round_two():
            r0["v2"] = g0.broadcast(b"addr-v2", root=0, timeout_s=10)

        t = threading.Thread(target=round_two)
        t.start()
        got = g1b.broadcast(None, root=0, timeout_s=10)
        t.join(timeout=10)
        assert got == b"addr-v2", "replacement read a stale round"
        g1b.leave()
        g0.leave()
