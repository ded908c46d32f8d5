"""The train CLI's logging, profiling and optimizer flags against the JAX
CLI's on the CPU, the Tracer's window, and generate and serve from a
per-shard checkpoint.

Exact throughout: the metrics lines' keys and value types, the flags'
defaults, the refusals' words, the trace window's steps, the restored
variables (bitwise) and the greedy tokens.
"""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch

from nezha_tpu.cli import generate as jax_generate_cli
from nezha_tpu.cli import train as jax_train_cli
from nezha_tpu.obs import trace as jax_trace
from nezha_tpu_torch.cli import generate as generate_cli
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.cli.common import gpt2_for_preset, restore_variables_any
from nezha_tpu_torch.obs import MetricsLogger, Tracer, read_metrics
from nezha_tpu_torch.obs import trace as torch_trace
from nezha_tpu_torch.tensor import memory_metrics, to_device, to_host, \
    tree_bytes
from nezha_tpu_torch.utils import MetricsLogger as UtilsMetricsLogger
from nezha_tpu_torch.utils import Tracer as UtilsTracer

PORTED = ("--prefetch", "--grad-accum", "--optimizer", "--lr",
          "--log-every", "--metrics-file", "--log-memory", "--profile-dir",
          "--profile-steps", "--trace-dir", "--run-dir")
GPT2 = ["--config", "gpt2_124m", "--model-preset", "tiny", "--batch-size",
        "2", "--seq-len", "32"]


def _port_train(argv):
    return train_cli.run(train_cli.parse_args(argv + ["--device", "cpu"]))


def test_ported_flags_parse_with_jax_defaults():
    assert not set(PORTED) & train_cli.NOT_PORTED_FLAGS
    # The graph engine and the scan trunk are ported; --platform is not.
    assert not {"--engine", "--scan-layers",
                "--graph-bf16"} & train_cli.NOT_PORTED_FLAGS
    assert "--platform" in train_cli.NOT_PORTED_FLAGS
    assert not {"--remat", "--microbatches",
                "--moe-experts"} & train_cli.NOT_PORTED_FLAGS
    assert "--rejoin-timeout" not in train_cli.NOT_PORTED_FLAGS
    mine = train_cli.parse_args(["--config", "gpt2_124m"])
    theirs = jax_train_cli.build_parser().parse_args(["--config",
                                                      "gpt2_124m"])
    for name in ("prefetch", "grad_accum", "optimizer", "lr", "log_every",
                 "metrics_file", "log_memory", "profile_dir",
                 "profile_steps", "trace_dir", "run_dir", "microbatches",
                 "moe_experts", "remat", "engine", "graph_bf16",
                 "scan_layers"):
        assert getattr(mine, name) == getattr(theirs, name), name
    assert train_cli.parse_args(["--config", "mlp_mnist", "--trace-dir",
                                 "/t"]).profile_dir == "/t"
    assert sorted(train_cli.OPTIMIZERS) == sorted(
        jax_train_cli.build_parser()._option_string_actions[
            "--optimizer"].choices)


# (argv, whether the port refuses it at parse time or in the run)
REFUSALS = [
    (["--config", "mlp_mnist", "--lr", "0.1"], "parse"),
    (["--config", "mlp_mnist", "--optimizer", "sgd"], "parse"),
    (["--config", "mlp_mnist", "--optimizer", "sgd", "--lr", "0"], "parse"),
    (["--config", "gpt2_124m", "--optimizer", "lars", "--lr", "0.1",
      "--wd-exclude-1d"], "parse"),
    (["--config", "resnet50_imagenet", "--wd-exclude-1d"], "parse"),
    (["--config", "mlp_mnist", "--grad-accum", "0"], "parse"),
    (["--config", "mlp_mnist", "--profile-dir", "/p", "--profile-steps",
      "0:3"], "parse"),
    (["--config", "mlp_mnist", "--profile-steps", "1:3"], "parse"),
    (["--config", "mlp_mnist", "--trace-dir", "/a", "--profile-dir", "/b"],
     "parse"),
    (["--config", "bert_base_zero1", "--model-preset", "tiny", "--parallel",
      "zero1", "--mesh", "dp=1", "--optimizer", "lamb", "--lr", "0.1"],
     "run"),
]


@pytest.mark.parametrize("argv,where", REFUSALS)
def test_refusals_are_jax_words(argv, where, capsys):
    with pytest.raises(SystemExit) as e:
        jax_train_cli.main(argv)
    want = str(e.value.code)
    assert want and not want.isdigit()
    with pytest.raises(SystemExit) as e:
        args = train_cli.parse_args(argv + ["--device", "cpu"])
        assert where == "run"
        train_cli.run(args)
    got = str(e.value.code) + capsys.readouterr().err
    assert want in got


def _window_lines(path):
    return [r for r in read_metrics(path) if "loss" in r]


def test_metrics_file_has_jax_keys_and_types(tmp_path):
    jax_train_cli.main(GPT2 + ["--steps", "2", "--log-every", "1",
                               "--parallel", "single", "--metrics-file",
                               str(tmp_path / "jax.jsonl")])
    _port_train(GPT2 + ["--steps", "2", "--log-every", "1",
                        "--metrics-file", str(tmp_path / "port.jsonl"),
                        "--log-memory"])
    want = _window_lines(tmp_path / "jax.jsonl")
    got = _window_lines(tmp_path / "port.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        # --log-memory adds nothing on the CPU, as in JAX off the TPU.
        assert g.keys() == w.keys()
        assert {k: type(v) for k, v in g.items()} == \
            {k: type(v) for k, v in w.items()}


def test_log_every_sets_the_window(tmp_path):
    _port_train(GPT2 + ["--steps", "6", "--log-every", "3",
                        "--metrics-file", str(tmp_path / "m.jsonl")])
    assert [r["step"] for r in _window_lines(tmp_path / "m.jsonl")] == [3, 6]
    _port_train(GPT2 + ["--steps", "2", "--log-every", "0",
                        "--metrics-file", str(tmp_path / "none.jsonl")])
    assert _window_lines(tmp_path / "none.jsonl") == []


def test_metrics_logger_keeps_ints(tmp_path):
    assert UtilsMetricsLogger is MetricsLogger
    for i, mode in enumerate(("a", "w")):
        path = tmp_path / f"m{i}.jsonl"
        with MetricsLogger(str(path), mode=mode) as log:
            log(3, {"step": 3, "loss": torch.tensor(1.5), "n": 7,
                    "ok": True, "nested": {"a": 1}})
        (rec,) = read_metrics(str(path))
        assert rec["step"] == 3 and isinstance(rec["step"], int)
        assert rec["loss"] == 1.5 and rec["n"] == 7 and rec["ok"] is True
        assert rec["nested"] == {"a": 1} and isinstance(rec["ts"], float)


def test_memory_helpers_on_the_cpu():
    tree = {"a": np.ones((2, 3), np.float32), "b": [np.zeros(4, np.int64)]}
    dev = to_device(tree, "cpu")
    assert torch.is_tensor(dev["a"]) and dev["b"][0].dtype == torch.int64
    back = to_host(dev)
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert tree_bytes(tree) == tree_bytes(dev) == 2 * 3 * 4 + 4 * 8
    assert memory_metrics("cpu") == {}


class _FakeProfiler:
    def __init__(self, log):
        self.log = log

    def stop(self):
        self.log.append("stop")

    def export_chrome_trace(self, path):
        self.log.append(os.path.basename(path))


@pytest.mark.parametrize("start,count,steps", [
    (3, 2, range(1, 9)), (3, 2, range(10, 16)), (1, 1, range(1, 5))])
def test_tracer_window_matches_jax(start, count, steps, tmp_path,
                                   monkeypatch):
    """The window opens at the first step at or after ``start`` (the
    rebase after a resume) and closes ``count`` steps later, once."""
    events = {"jax": [], "port": []}
    monkeypatch.setattr(jax_trace.jax.profiler, "start_trace",
                        lambda d: events["jax"].append("start"))
    monkeypatch.setattr(jax_trace.jax.profiler, "stop_trace",
                        lambda: events["jax"].append("stop"))

    def fake_start():
        events["port"].append("start")
        return _FakeProfiler(events["port"])

    monkeypatch.setattr(torch_trace, "_start_profiler", fake_start)
    jt = jax_trace.Tracer(str(tmp_path), start_step=start, num_steps=count)
    tt = Tracer(str(tmp_path), start_step=start, num_steps=count)
    seen = {"jax": [], "port": []}
    for step in steps:
        jt.maybe_trace(step)
        tt.maybe_trace(step)
        seen["jax"].append(jt._active)
        seen["port"].append(tt.active)
    assert seen["port"] == seen["jax"] and any(seen["port"])
    assert events["port"][0] == "start" and events["port"][1] == "stop"
    assert events["jax"] == ["start", "stop"]
    opened = steps[seen["port"].index(True)]
    assert events["port"][2] == \
        f"trace_steps{opened + 1}-{opened + count}_pid{os.getpid()}.json"
    assert Tracer(None).maybe_trace(5) is None
    assert UtilsTracer is Tracer


def _traces(d):
    return sorted(os.path.basename(p) for p in glob.glob(f"{d}/*.json"))


def test_cli_profile_window_whole_run_and_resume(tmp_path):
    pid = os.getpid()
    _port_train(GPT2 + ["--steps", "5", "--profile-dir", str(tmp_path / "w"),
                        "--profile-steps", "2:2"])
    assert _traces(tmp_path / "w") == [f"trace_steps3-4_pid{pid}.json"]
    with open(tmp_path / "w" / f"trace_steps3-4_pid{pid}.json") as f:
        assert json.load(f)["traceEvents"]
    _port_train(GPT2 + ["--steps", "2", "--trace-dir", str(tmp_path / "all")])
    assert _traces(tmp_path / "all") == [f"trace_pid{pid}.json"]
    ck = str(tmp_path / "ck")
    _port_train(GPT2 + ["--steps", "3", "--ckpt-dir", ck])
    _port_train(GPT2 + ["--steps", "3", "--ckpt-dir", ck, "--profile-dir",
                        str(tmp_path / "r"), "--profile-steps", "1:2"])
    # Resumed at step 3: the window opens after step 4, the first it sees.
    assert _traces(tmp_path / "r") == [f"trace_steps5-6_pid{pid}.json"]


# ----------------------------------------- generate/serve from a sharded save
@pytest.fixture(scope="module")
def two_saves(tmp_path_factory):
    """The same two steps of the tiny GPT-2 by ZeRO-1 at world 1 (a
    per-shard save) and single-device (a dense npz)."""
    d = tmp_path_factory.mktemp("saves")
    base = ["--config", "gpt2_124m", "--model-preset", "tiny",
            "--batch-size", "2", "--steps", "2", "--device", "cpu"]
    train_cli.run(train_cli.parse_args(base + [
        "--parallel", "zero1", "--mesh", "dp=1", "--ckpt-dir",
        str(d / "sharded")]))
    train_cli.run(train_cli.parse_args(base + [
        "--parallel", "single", "--ckpt-dir", str(d / "dense")]))
    assert os.listdir(d / "sharded") == ["step_00000002.sharded"]
    return d


def test_sharded_variables_restore_bitwise(two_saves):
    models = {}
    for name in ("sharded", "dense"):
        models[name] = gpt2_for_preset("tiny", seed=1, device="cpu")
        assert restore_variables_any(str(two_saves / name),
                                     models[name]) == 2
    a, b = models["sharded"].state_dict(), models["dense"].state_dict()
    for k, v in b.items():
        assert torch.equal(a[k], v), k


GEN = ["--model-preset", "tiny", "--prompt-tokens", "5,17,3,42",
       "--max-new-tokens", "8", "--temperature", "0"]


def test_generate_from_sharded_gives_the_dense_tokens(two_saves):
    got = {name: generate_cli.run(generate_cli.build_parser().parse_args(
        ["--ckpt-dir", str(two_saves / name), "--device", "cpu"] + GEN))
        for name in ("sharded", "dense")}
    assert got["sharded"]["tokens"] == got["dense"]["tokens"]
    # The JAX CLI reads the port's per-shard save to the same tokens.
    want = jax_generate_cli.run(jax_generate_cli.build_parser().parse_args(
        ["--ckpt-dir", str(two_saves / "sharded")] + GEN))
    assert got["sharded"]["tokens"] == want["tokens"]


def test_serve_from_sharded_gives_the_dense_tokens(two_saves):
    reqs = "".join(json.dumps({"id": f"r{i}", "prompt_tokens": p,
                               "max_new_tokens": 6}) + "\n"
                   for i, p in enumerate([[5, 17, 3], [9, 9, 2, 7, 1]]))
    tokens = {}
    for name in ("sharded", "dense"):
        args = serve_cli.build_parser().parse_args([
            "--ckpt-dir", str(two_saves / name), "--model-preset", "tiny",
            "--device", "cpu", "--max-len", "32", "--eos-id", "-1"])
        out = io.StringIO()
        serve_cli.run_stdio(serve_cli.build_scheduler(args), args,
                            stdin=io.StringIO(reqs), stdout=out)
        tokens[name] = {r["id"]: r["tokens"] for r in map(
            json.loads, out.getvalue().splitlines())}
    assert tokens["sharded"] == tokens["dense"] and len(tokens["dense"]) == 2
