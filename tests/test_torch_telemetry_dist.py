"""The train side's telemetry across processes, on the CPU over gloo: the
train CLI's ``--run-dir`` at world 2 writes one run dir a rank
(``rank0/``, ``rank1/``) that JAX's ``check_run_dir`` and the port's
copy pass, with the coordinator's spans and counters and one
``all_reduce`` record a step; and the per-collective payload rows of the
port's dp and ZeRO-1 steps at world 2 (fp32 and the int8 wire) equal the
records of JAX's ``make_dp_train_step`` / ``make_zero1_train_step``
traced once on a dp=2 mesh of its host devices. JAX counts once per
traced program, the port once per call: the port's ``calls`` is the
number of steps, and its payload per call is JAX's per program."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nezha_tpu import obs as jobs
from nezha_tpu import optim as jax_optim
from nezha_tpu import parallel as jax_parallel
from nezha_tpu.analysis.telemetry_schema import check_run_dir
from nezha_tpu.cli.train import TINY_BERT_KW, TINY_GPT2_KW
from nezha_tpu.models.bert import Bert as JaxBert
from nezha_tpu.models.bert import BertConfig as JaxBertConfig
from nezha_tpu.models.bert import mlm_loss as jax_mlm_loss
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu_torch import dist
from nezha_tpu_torch.analysis import telemetry_schema as schema
from nezha_tpu_torch.models.convert import bert_from_jax, params_from_jax
from nezha_tpu_torch.parallel.quantized import wire_payload_bytes
from torch_dist_worker import run_world

ROOT = Path(__file__).resolve().parents[1]
STEPS = 2


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


# ------------------------------------------------------- the CLI at world 2
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


@pytest.fixture(scope="module")
def world2_run(tmp_path_factory):
    """gpt2_124m dp at world 2 through the coordinator, with --run-dir:
    -> (the run dir, the ranks' stderr)."""
    run = tmp_path_factory.mktemp("dist") / "run"
    argv = [sys.executable, "-m", "nezha_tpu_torch.cli.train", "--device",
            "cpu", "--model-preset", "tiny", "--config", "gpt2_124m",
            "--steps", "4", "--batch-size", "4", "--seq-len", "32",
            "--log-every", "2", "--run-dir", str(run)]
    with dist.Coordinator(world_size=2) as coord:
        procs = [subprocess.Popen(
            argv + ["--coordinator", f"127.0.0.1:{coord.port}",
                    "--rank-hint", str(r)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=_env())
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=180) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return run, [err for _, err in outs]


def test_world2_run_dirs_pass_both_schema_checks(world2_run):
    run, _ = world2_run
    assert sorted(p.name for p in run.iterdir()) == ["rank0", "rank1"]
    for r in ("rank0", "rank1"):
        assert check_run_dir(str(run / r)) == []
        assert schema.check_run_dir(str(run / r)) == []


def test_world2_run_dirs_count_the_steps_and_the_gradients(world2_run):
    """Each rank: ``train.steps`` 4, one ``all_reduce`` record a step of
    the gradients' fp32 bytes, the coordinator's counters and spans."""
    from nezha_tpu_torch.cli.train import build_config

    run, errs = world2_run
    model = build_config("gpt2_124m", "tiny", seq_len=32, device="cpu").model
    grad_bytes = sum(p.numel() * 4 for p in model.parameters())
    for rank, r in enumerate(("rank0", "rank1")):
        s = json.loads((run / r / "summary.json").read_text())
        c = s["counters"]
        assert c["train.steps"] == 4
        assert s["collectives"]["all_reduce"] == {
            "calls": 4, "payload_bytes": 4 * grad_bytes}
        assert c["dist.join_retries_total"] == 0
        assert c["dist.heartbeat_lost_total"] == 0
        spans = [json.loads(x) for x in
                 (run / r / "spans.jsonl").read_text().splitlines()]
        names = [x["name"] for x in spans]
        assert names.count("dist.join") == 1 and "dist.barrier" in names
        assert "dist.leave" in names and "train.first_step" in names
        join = spans[names.index("dist.join")]["attrs"]
        assert (join["rank"], join["world"]) == (rank, 2)
        assert f"[rank {rank}] INFO nezha_tpu_torch.cli: joined world: " \
               f"rank {rank} / 2" in errs[rank]


# ------------------------------------------------------------ payload rows
def _jax_records(mode, grad_reduce, jm, variables, loss, batches):
    """JAX's step traced once on a dp=2 mesh under an enabled registry ->
    its collective rows (one record an op a traced program)."""
    mesh = jax_parallel.make_mesh({"dp": 2}, devices=jax.devices()[:2])
    opt = jax_optim.momentum(0.1, 0.9)
    jobs.REGISTRY.reset()
    jobs.enable()
    try:
        if mode == "zero1":
            state = {"variables": jax_parallel.replicate(mesh, variables),
                     "opt_state": jax_parallel.zero1_init_opt_state(
                         opt, variables["params"], mesh),
                     "rng": jax_parallel.replicate(
                         mesh, jax.random.PRNGKey(3))}
            step = jax_parallel.make_zero1_train_step(
                jm, opt, loss, mesh, donate=False, grad_reduce=grad_reduce)
        else:
            state = jax_parallel.replicate(mesh, {
                "variables": variables,
                "opt_state": opt.init(variables["params"]),
                "rng": jax.random.PRNGKey(3)})
            step = jax_parallel.make_dp_train_step(
                jm, opt, loss, mesh, donate=False, grad_reduce=grad_reduce)
        for b in batches:
            state, _ = step(state, jax_parallel.shard_batch(
                mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        return jobs.REGISTRY.snapshot()["collectives"]
    finally:
        jobs.disable()


def _batches(spec, rows=4):
    r = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        if spec == "gpt2":
            out.append({"tokens": r.randint(0, 512, (rows, 33)).astype(
                np.int32)})
        else:
            ids = r.randint(5, 512, (rows, 32)).astype(np.int32)
            labels = np.where(r.rand(rows, 32) < 0.3, ids, -100).astype(
                np.int32)
            out.append({"tokens": np.where(labels >= 0, 1, ids).astype(
                np.int32), "labels": labels,
                "segment_ids": np.zeros_like(ids)})
    return out


@pytest.mark.parametrize("mode,grad_reduce", [
    ("dp", "fp32"), ("dp", "int8"), ("zero1", "fp32"), ("zero1", "int8")])
def test_payload_rows_equal_jax(mode, grad_reduce, tmp_path):
    spec = "gpt2" if mode == "dp" else "bert"
    if spec == "gpt2":
        jm, loss = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW)), jax_lm_loss
    else:
        jm, loss = JaxBert(JaxBertConfig(**TINY_BERT_KW)), jax_mlm_loss
    jv = jm.init(jax.random.PRNGKey(0))
    params = _flatten(jv["params"])
    sd = (params_from_jax if spec == "gpt2" else bert_from_jax)(params)
    batches = _batches(spec)
    want = _jax_records(mode, grad_reduce, jm, jv, loss, batches)
    ranks = run_world("train", 2, {
        "model": spec, "opt": ("momentum", 0.1, 0.9), "mode": mode,
        "grad_reduce": grad_reduce, "telemetry": True,
        "state_dict": {k: v.numpy() for k, v in sd.items()},
        "batches": batches}, tmp_path)
    want = {op: row for op, row in want.items() if row["calls"]}
    ops = {"dp": {"fp32": {"all_reduce"},
                  "int8": {"all_reduce", "all_reduce_int8"}},
           "zero1": {"fp32": {"reduce_scatter", "all_gather"},
                     "int8": {"reduce_scatter", "all_gather",
                              "reduce_scatter_int8", "all_gather_int8"}}}
    assert set(want) == ops[mode][grad_reduce]
    for r in ranks:
        got = {op: row for op, row in r["collectives"].items()
               if row["calls"]}
        assert set(got) == set(want)
        for op, row in want.items():
            assert row["calls"] == 1
            assert got[op]["calls"] == STEPS, op
            assert got[op]["payload_bytes"] == \
                STEPS * row["payload_bytes"], op
    if mode == "dp" and grad_reduce == "int8":
        # The int8 leaves at the wire's width, the rest at fp32.
        quant = [v.size for v in params.values() if v.size >= 4096]
        assert want["all_reduce_int8"]["payload_bytes"] == sum(
            wire_payload_bytes(n) for n in quant)
