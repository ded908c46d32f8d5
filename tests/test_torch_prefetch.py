"""The port's prefetcher (``runtime/prefetch.py``) against the JAX
package's on the CPU, and the train CLI's ``--prefetch``.

Exact throughout: a prefetched batch is the bare stream's batch as
``batch_to_device`` makes it, bit for bit (the same keys, integers as
int64), in the same order; the JAX prefetcher yields the same values.
A CLI run fed through the prefetcher ends on the weights of a Trainer fed
the bare stream, bitwise, and so does a prefetched run cut and resumed.
Every wait on a worker thread has a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from nezha_tpu.runtime import Prefetcher as JaxPrefetcher
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.runtime import Prefetcher, prefetch_to_device
from nezha_tpu_torch.train import Trainer, batch_to_device
from nezha_tpu_torch.train import checkpoint as ckpt

JOIN_S = 10.0


def _batches(n, seed=0):
    """Image, label and token arrays of the loaders' dtypes (float32,
    int32, uint16, bool)."""
    r = np.random.RandomState(seed)
    return [{"image": r.rand(2, 4, 4, 3).astype(np.float32),
             "label": r.randint(0, 10, 2).astype(np.int32),
             "tokens": r.randint(0, 60000, (2, 5)).astype(np.uint16),
             "mask": r.rand(2, 5) < 0.5} for _ in range(n)]


def _equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].device == w.device, k
        assert torch.equal(got[k], w), k


def _drain(it, timeout=JOIN_S):
    """Every item of ``it``, read on a thread joined with a timeout."""
    out, err = [], []

    def run():
        try:
            out.extend(it)
        except BaseException as e:  # handed to the test below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the prefetcher did not finish in time"
    return out, err


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_yields_the_bare_stream_in_order(depth):
    src = _batches(7)
    pf = Prefetcher(iter(src), depth=depth, device="cpu")
    got, err = _drain(pf)
    pf.close()
    assert not err and len(got) == len(src)
    for g, b in zip(got, src):
        _equal(g, batch_to_device(b, torch.device("cpu")))
    # The JAX package's prefetcher yields the same values.
    jp = JaxPrefetcher(iter(src), depth=depth)
    want, jerr = _drain(jp)
    jp.close()
    assert not jerr and len(want) == len(got)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_two_workers_yield_every_batch_once():
    src = _batches(9, seed=1)
    pf = prefetch_to_device(iter(src), depth=2, device="cpu")
    assert isinstance(pf, Prefetcher)
    pf = Prefetcher(iter(src), depth=2, device="cpu", num_workers=2)
    got, err = _drain(pf)
    pf.close()
    assert not err
    key = sorted(g["image"].numpy().tobytes() for g in got)
    assert key == sorted(b["image"].tobytes() for b in src)


def _failing(n):
    yield from _batches(n)
    raise ValueError("loader broke")


@pytest.mark.parametrize("cls", [Prefetcher, JaxPrefetcher])
def test_worker_error_is_raised_in_the_consumer(cls):
    kw = {"device": "cpu"} if cls is Prefetcher else {}
    pf = cls(_failing(2), depth=1, **kw)
    got, err = _drain(pf)
    pf.close()
    assert len(got) == 2
    assert len(err) == 1 and isinstance(err[0], ValueError)
    assert "loader broke" in str(err[0])


def _endless():
    b = _batches(1)[0]
    while True:
        yield b


@pytest.mark.parametrize("cls", [Prefetcher, JaxPrefetcher])
def test_close_returns_with_workers_blocked_in_put(cls):
    kw = {"device": "cpu"} if cls is Prefetcher else {}
    pf = cls(_endless(), depth=1, num_workers=2, **kw)
    deadline = time.monotonic() + JOIN_S
    while not pf._q.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf._q.full()   # every worker now waits in put()
    t0 = time.monotonic()
    pf.close(timeout=3.0)
    assert time.monotonic() - t0 < 3.5
    for t in pf._threads:
        t.join(JOIN_S)
        assert not t.is_alive()


def _slow(n, delay):
    for b in _batches(n):
        time.sleep(delay)
        yield b


def test_empty_queue_reads_count_as_stalls():
    pf = Prefetcher(_slow(3, 0.05), depth=2, device="cpu")
    got, err = _drain(pf)
    pf.close()
    assert len(got) == 3 and not err
    assert pf.stalls >= 1 and pf.stall_seconds > 0


ARGV = ["--config", "gpt2_124m", "--model-preset", "tiny", "--device",
        "cpu", "--batch-size", "2", "--seq-len", "32", "--log-every", "0"]


def _final_state(d):
    step = ckpt.latest_step(str(d))
    return ckpt.verify_checkpoint(str(d), step)


@pytest.mark.parametrize("prefetch", ["0", "2"])
def test_cli_prefetch_ends_on_the_bare_trainers_weights(prefetch, tmp_path):
    train_cli.run(train_cli.parse_args(ARGV + [
        "--steps", "3", "--prefetch", prefetch, "--ckpt-dir",
        str(tmp_path)]))
    got = _final_state(tmp_path)
    cfg = train_cli.build_config("gpt2_124m", "tiny", steps=3, device="cpu",
                                 seq_len=32)
    trainer = Trainer(cfg.model, cfg.optimizer, cfg.loss_fn, log_every=0)
    trainer.fit(cfg.batches(2), 3)
    want = trainer.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_cli_prefetched_resume_equals_unbroken(tmp_path):
    train_cli.run(train_cli.parse_args(ARGV + [
        "--steps", "4", "--ckpt-dir", str(tmp_path / "a")]))
    for steps in ("2", "2"):
        train_cli.run(train_cli.parse_args(ARGV + [
            "--steps", steps, "--ckpt-dir", str(tmp_path / "b")]))
    a, b = _final_state(tmp_path / "a"), _final_state(tmp_path / "b")
    assert a.keys() == b.keys() and int(b["opt_state/step"]) == 4
    for k, v in a.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)
