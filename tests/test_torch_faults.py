"""``nezha_tpu_torch.faults`` against the JAX package's ``faults``: the
plan grammar and its seeded hit schedule rule for rule and hit for hit,
``corrupt`` poisoning the same row on a torch tensor without a host copy,
the fault-point registry (an ``ast`` walk of both trees: every point the
port places has JAX's name, and every serve-side name of JAX's frozen
registry has a port site), and the serving loop's isolation of injected
faults to one request with no slot or block leaked (tiny GPT-2 on the
CPU)."""

import ast
import os

import numpy as np
import pytest
import torch

from nezha_tpu import faults as jfaults
from nezha_tpu.analysis.rules.fault_points import EXPECTED_POINTS
from nezha_tpu_torch import faults, obs
from nezha_tpu_torch.cli.common import gpt2_for_preset
from nezha_tpu_torch.faults import FaultPlan, InjectedFault
from nezha_tpu_torch.serve import (Engine, FinishReason, Request, Scheduler,
                                   ServeConfig)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLANS = ["serve.step:error@2",
         "serve.step:error@1x3;serve.prefill:delay=0.001@2",
         "serve.step.logits:nan%0.5;serve.prefill:error%0.25",
         "replica.kv_pull:error@3x*;router.probe:inf@1",
         "scheduler.preempt:zero@2x2;serve.kv.bind:error%1"]
POINTS = ["serve.step", "serve.prefill", "serve.step.logits",
          "replica.kv_pull", "router.probe", "scheduler.preempt",
          "serve.kv.bind"]


@pytest.fixture(autouse=True)
def _no_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _rule_fields(rule):
    return (rule.point, rule.action, rule.at, rule.times, rule.p,
            rule.delay_s)


@pytest.mark.parametrize("spec", PLANS)
@pytest.mark.parametrize("seed", [0, 7])
def test_plan_parse_and_schedule_equal_jax(spec, seed):
    mine = FaultPlan.parse(spec, seed=seed)
    theirs = jfaults.FaultPlan.parse(spec, seed=seed)
    assert [_rule_fields(r) for r in mine.rules] == [
        _rule_fields(r) for r in theirs.rules]
    rng = np.random.RandomState(seed)
    for _ in range(200):
        point = POINTS[rng.randint(len(POINTS))]
        a, b = mine.hit(point), theirs.hit(point)
        assert (None if a is None else _rule_fields(a)) == (
            None if b is None else _rule_fields(b))
        if a is not None:
            mine.record_injection(point)
            theirs.record_injection(point)
            n = int(rng.randint(1, 9))
            assert mine.choose(n) == theirs.choose(n)
    assert mine.hit_counts == theirs.hit_counts
    assert mine.injected_counts == theirs.injected_counts


@pytest.mark.parametrize("bad", ["", "serve.step", "serve.step:boom",
                                 "serve.step:error=1", "x:delay",
                                 "x:error@0", "x:error%2",
                                 "x:error@2%0.5", "x:error x0"])
def test_plan_refusals_match_jax(bad):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


def test_point_noop_error_and_delay():
    faults.point("serve.step")          # no plan: nothing
    faults.install(FaultPlan.parse("serve.step:error@2;serve.prefill:"
                                   "delay=0.001@1"))
    faults.point("serve.step")
    with pytest.raises(InjectedFault):
        faults.point("serve.step")
    faults.point("serve.prefill")
    assert faults.active().injected_counts == {"serve.step": 1,
                                               "serve.prefill": 1}


@pytest.mark.parametrize("action", ["nan", "inf", "zero"])
@pytest.mark.parametrize("seed", [0, 3])
def test_corrupt_poisons_the_row_jax_poisons(action, seed, monkeypatch):
    spec = f"serve.step.logits:{action}@2"
    x = np.arange(6 * 5, dtype=np.float32).reshape(6, 5) + 1.0
    rows = [1, 2, 4, 5]
    jfaults.install(jfaults.FaultPlan.parse(spec, seed=seed))
    faults.install(FaultPlan.parse(spec, seed=seed))
    t = torch.tensor(x)
    calls = []

    def lazy():
        calls.append(1)
        return rows

    # The first hit fires nothing: rows are never evaluated.
    assert jfaults.corrupt("serve.step.logits", x, rows=rows) is x
    assert faults.corrupt("serve.step.logits", t, rows=lazy) is t
    assert calls == []
    want = np.asarray(jfaults.corrupt("serve.step.logits", x, rows=rows))

    def no_host(*a, **k):
        raise AssertionError("corrupt copied the tensor to the host")

    monkeypatch.setattr(torch.Tensor, "numpy", no_host)
    monkeypatch.setattr(torch.Tensor, "cpu", no_host)
    monkeypatch.setattr(torch.Tensor, "tolist", no_host)
    got = faults.corrupt("serve.step.logits", t, rows=lazy)
    monkeypatch.undo()
    assert calls == [1]
    assert isinstance(got, torch.Tensor) and got is not t
    assert got.device == t.device and got.dtype == t.dtype
    assert torch.equal(t, torch.tensor(x))         # the input untouched
    np.testing.assert_array_equal(got.numpy(), want)
    poisoned = [r for r in range(6)
                if not np.array_equal(want[r], x[r])]
    assert len(poisoned) == 1 and poisoned[0] in rows


def test_corrupt_whole_tensor_and_empty_rows():
    faults.install(FaultPlan.parse("a.b:inf@1;c.d:nan@1"))
    t = torch.ones(3, 4)
    got = faults.corrupt("a.b", t)
    assert torch.isinf(got).all() and torch.equal(t, torch.ones(3, 4))
    # No eligible row: nothing poisoned, nothing counted.
    assert faults.corrupt("c.d", t, rows=[]) is t
    assert faults.active().injected_counts == {"a.b": 1}


def test_injections_count_into_the_registry(tmp_path):
    obs.start_run(str(tmp_path))
    try:
        faults.install(FaultPlan.parse("x.y:error@1;x.z:nan@1"))
        with pytest.raises(InjectedFault):
            faults.point("x.y")
        faults.corrupt("x.z", torch.zeros(2))
        assert obs.counter("faults.injected_total").value == 2
    finally:
        obs.end_run()


def test_install_from_env_leaves_a_plan_alone_when_unset():
    plan = faults.install(FaultPlan.parse("a.b:error@1"))
    assert faults.install_from_env({}) is None and faults.active() is plan
    got = faults.install_from_env({"NEZHA_FAULT_PLAN": "c.d:error@2",
                                   "NEZHA_FAULT_SEED": "5"})
    assert faults.active() is got and got.seed == 5
    jgot = jfaults.install_from_env({"NEZHA_FAULT_PLAN": "c.d:error@2",
                                     "NEZHA_FAULT_SEED": "5"})
    assert [_rule_fields(r) for r in got.rules] == [
        _rule_fields(r) for r in jgot.rules]


# ------------------------------------------------------------- registry
def _sites(package: str, exclude: str):
    """{point name: [files]} of every faults.point/corrupt call with a
    literal name under ``package``."""
    out = {}
    base = os.path.join(ROOT, package)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, ROOT)
            if rel.startswith(exclude):
                continue
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if (isinstance(fn, ast.Attribute)
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id == "faults"
                        and fn.attr in ("point", "corrupt")
                        and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    out.setdefault(node.args[0].value, []).append(rel)
    return out


SERVE_SIDE = ("serve.", "scheduler.", "replica.", "router.", "supervisor.")


def test_fault_point_names_match_jax_registry():
    mine = _sites("nezha_tpu_torch", "nezha_tpu_torch/faults/")
    theirs = _sites("nezha_tpu", "nezha_tpu/faults/")
    assert set(theirs) == EXPECTED_POINTS
    assert set(mine) <= EXPECTED_POINTS, set(mine) - EXPECTED_POINTS
    assert {n for n in EXPECTED_POINTS if n.startswith(SERVE_SIDE)} <= set(
        mine), {n for n in EXPECTED_POINTS if n.startswith(SERVE_SIDE)} - set(
        mine)
    dup = {n: f for n, f in mine.items() if len(f) > 1}
    assert dup == {}, dup


# ------------------------------------------------------------ serve loop
SCFG = ServeConfig(max_batch_size=3, max_len=48, max_prefill_len=8,
                   prefill_buckets=(4, 8), k_max=16, queue_capacity=4,
                   kv_block_size=8, cache_dtype=torch.float32)


@pytest.fixture(scope="module")
def engine():
    model = gpt2_for_preset("tiny", seed=0, device="cpu")
    return Engine(model, SCFG)


def _drain(sched, max_iters=400):
    sched.run_until_idle(max_iters=max_iters)
    assert not sched.has_work(), "scheduler did not drain"


def _clean(engine):
    assert engine.pool.num_free == SCFG.max_batch_size
    engine.pool.leak_check()


def test_prefill_fault_retires_only_the_victim(engine):
    faults.install(FaultPlan.parse("serve.prefill:error@2"))
    sched = Scheduler(engine)
    ids = [sched.submit(Request(prompt=[5 + i, 17, 3], max_new_tokens=3))
           for i in range(3)]
    _drain(sched)
    res = [sched.results[i] for i in ids]
    assert [r.finish_reason for r in res] == ["length", "error", "length"]
    assert "InjectedFault" in res[1].error
    _clean(engine)


def test_step_fault_is_absorbed_by_the_bounded_retry(engine):
    faults.install(FaultPlan.parse("serve.step:error@2"))
    sched = Scheduler(engine)
    a = sched.submit(Request(prompt=[5, 17, 3], max_new_tokens=4))
    b = sched.submit(Request(prompt=[9, 2], max_new_tokens=4))
    _drain(sched)
    for rid in (a, b):
        assert sched.results[rid].finish_reason == "length"
        assert len(sched.results[rid].tokens) == 4
    assert faults.active().injected_counts == {"serve.step": 1}
    _clean(engine)
    faults.install(FaultPlan.parse("serve.step:error@1x2"))
    sched = Scheduler(engine)
    sched.submit(Request(prompt=[5, 17], max_new_tokens=2))
    with pytest.raises(InjectedFault):
        sched.step()
    faults.clear()
    _drain(sched)
    _clean(engine)


@pytest.mark.parametrize("point", ["serve.step.logits",
                                   "serve.prefill.logits"])
def test_nan_burst_retires_one_row(engine, point):
    faults.install(FaultPlan.parse(f"{point}:nan@2"))
    sched = Scheduler(engine)
    ids = [sched.submit(Request(prompt=[3 + i, 4, 5], max_new_tokens=5))
           for i in range(2)]
    _drain(sched)
    reasons = sorted(sched.results[i].finish_reason for i in ids)
    assert reasons == ["error", "length"]
    victim = next(sched.results[i] for i in ids
                  if sched.results[i].finish_reason == "error")
    assert victim.error == "non-finite logits"
    _clean(engine)


def test_kv_bind_fault_is_typed_backpressure(engine):
    # The first decode window's bind fails: the row retires with the
    # exhaustion error, its neighbour keeps decoding.
    sched = Scheduler(engine)
    a = sched.submit(Request(prompt=[1, 2, 3], max_new_tokens=12))
    b = sched.submit(Request(prompt=[4, 5, 6], max_new_tokens=12))
    sched.step()
    faults.install(FaultPlan.parse("serve.kv.bind:error@1"))
    _drain(sched)
    reasons = sorted(sched.results[i].finish_reason for i in (a, b))
    assert reasons == ["error", "length"]
    victim = next(sched.results[i] for i in (a, b)
                  if sched.results[i].finish_reason == "error")
    assert "kv blocks exhausted" in victim.error
    _clean(engine)


def test_preempt_fault_leaves_the_victim_decoding():
    model = gpt2_for_preset("tiny", seed=0, device="cpu")
    eng = Engine(model, ServeConfig(
        max_batch_size=1, max_len=48, max_prefill_len=8,
        prefill_buckets=(4, 8), kv_block_size=8, queue_capacity=4,
        cache_dtype=torch.float32, preemption=True))
    faults.install(FaultPlan.parse("scheduler.preempt:error@1"))
    sched = Scheduler(eng)
    bg = sched.submit(Request(prompt=[1, 2, 3], max_new_tokens=6,
                              priority="background"))
    sched.step()
    vip = sched.submit(Request(prompt=[4, 5, 6], max_new_tokens=2))
    with sched._lock:
        sched._admit()    # the first hit is vetoed: bg keeps decoding
    assert sched.preemptions == 0 and sched.queue_depth == 1
    with sched._lock:
        sched._admit()    # the second is not armed: it preempts
    assert sched.preemptions == 1 and sched.queue_depth == 0
    _drain(sched)
    assert sched.results[bg].finish_reason == FinishReason.LENGTH
    assert sched.results[vip].finish_reason == FinishReason.LENGTH
    eng.pool.leak_check()
