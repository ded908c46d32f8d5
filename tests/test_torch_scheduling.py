"""Multi-tenant scheduling in the port against the JAX package (tiny
preset, f32 model and pools, weights carried by ``params_from_jax``):
WFQ grant order (the default 4:2:1 split, custom weights and tenants,
one lane as the exact FIFO) against JAX's scheduler on the same
submissions; typed per-tenant caps; preemption (off never fires; a
preempted background decode resumes to the uninterrupted stream on the
paged and dense layouts and under speculative decoding, with the resume's
prefix hit; the deadline while suspended; the preemption budget; the SLO
burn widening the quota); and the serve CLI's scheduling flags over
stdin."""

import dataclasses
import io
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.serve import Engine as JaxEngine
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu_torch.cli import serve as cli_serve
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.serve import (PRIORITIES, Engine, FinishReason,
                                   QueueFull, Request, Scheduler,
                                   ServeConfig, SpeculativeConfig,
                                   TenantOverLimit)
from nezha_tpu_torch.serve.scheduler import _Live

# Two slots on purpose: one background decode and one free slot make the
# second interactive arrival exactly the preemption trigger.
PKW = dict(max_batch_size=2, max_len=48, max_prefill_len=8,
           prefill_buckets=(4, 8), k_max=16, queue_capacity=8,
           kv_block_size=4, preemption=True, preemption_budget=2)
PCFG = ServeConfig(**PKW, cache_dtype=torch.float32)
DCFG = dataclasses.replace(PCFG, kv_layout="dense")


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _lively(tree, rng):
    """Scaled-up weights: the small init repeats one token, and a stream
    of one token would hide a resume that lost its place."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _lively(val, rng)
        elif key == "scale":
            out[key] = jnp.asarray(1 + 0.2 * rng.randn(*val.shape),
                                   jnp.float32)
        elif key in ("bias", "b"):
            out[key] = jnp.asarray(0.1 * rng.randn(*val.shape), jnp.float32)
        else:
            out[key] = val * 8
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW))
    jv = jm.init(jax.random.PRNGKey(0))
    jv = {"params": _lively(jv["params"], np.random.RandomState(0)),
          "state": jv["state"]}
    tm = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


@pytest.fixture(scope="module")
def paged_engine(models):
    return Engine(models[2], PCFG)


def _drain(sched, max_iters=300):
    sched.run_until_idle(max_iters=max_iters)
    assert not sched.has_work(), "scheduler did not drain"


def _submit(sched, rid, prompt, priority="interactive", tenant="default",
            max_new=4, deadline_s=None, make=Request):
    return sched.submit(make(
        prompt=prompt, max_new_tokens=max_new, priority=priority,
        tenant_id=tenant, deadline_s=deadline_s, request_id=rid))


# ------------------------------------------------------------------ WFQ
def test_wfq_weight_conservation(paged_engine):
    """Under a full backlog in every lane the default weights grant 4
    interactive, 2 batch and 1 background per 7, in JAX's exact
    virtual-time order; background is served within the first 7."""
    sched = Scheduler(paged_engine)
    _submit(sched, "g0", [1, 2, 3], priority="background")
    for i in range(2):
        _submit(sched, f"b{i}", [1, 2, 3], priority="batch")
    for i in range(4):
        _submit(sched, f"i{i}", [1, 2, 3], priority="interactive")
    with sched._lock:
        order = [sched._pop_next().req.priority for _ in range(7)]
    assert order == ["interactive", "batch", "background",
                     "interactive", "interactive", "batch",
                     "interactive"]
    assert sched.queue_depth == 0


@pytest.mark.parametrize("weights", [None, {"interactive": 3, "batch": 5,
                                            "background": 2}])
def test_wfq_grants_match_jax(models, weights):
    """A seeded backlog over three lanes and three tenants, with idle
    gaps: the port's grants are JAX's, request for request."""
    jm, jv, tm = models
    eng = Engine(tm, dataclasses.replace(PCFG, queue_capacity=64,
                                         priority_weights=weights))
    jeng = JaxEngine(jm, jv, JaxServeConfig(
        **{**PKW, "queue_capacity": 64}, cache_dtype=jnp.float32,
        priority_weights=weights))
    ours, theirs = Scheduler(eng), JaxScheduler(jeng)
    rng = np.random.RandomState(5)
    got, want = [], []
    for wave in range(4):
        for i in range(int(rng.randint(3, 12))):
            pri = PRIORITIES[rng.randint(3)]
            tenant = f"t{rng.randint(3)}"
            rid = f"w{wave}r{i}"
            _submit(ours, rid, [1, 2], pri, tenant)
            _submit(theirs, rid, [1, 2], pri, tenant, make=JaxRequest)
        pops = int(rng.randint(2, 9))
        with ours._lock, theirs._lock:
            got += [ours._pop_next() for _ in range(pops)]
            want += [theirs._pop_next() for _ in range(pops)]
    with ours._lock, theirs._lock:
        while theirs.queue_depth:
            got.append(ours._pop_next())
            want.append(theirs._pop_next())
        assert ours._pop_next() is None
    assert [g and g.request_id for g in got] == [
        w and w.request_id for w in want]
    assert ours._lane_vt == pytest.approx(theirs._lane_vt)


def test_wfq_tenant_round_robin(paged_engine):
    sched = Scheduler(paged_engine)
    for i in range(3):
        _submit(sched, f"a{i}", [1, 2], priority="batch", tenant="acme")
    for i in range(2):
        _submit(sched, f"x{i}", [1, 2], priority="batch", tenant="xcorp")
    with sched._lock:
        order = [sched._pop_next().request_id for _ in range(5)]
    assert order == ["a0", "x0", "a1", "x1", "a2"]


def test_wfq_single_lane_is_exact_fifo(paged_engine):
    sched = Scheduler(paged_engine)
    for i in range(6):
        _submit(sched, f"r{i}", [1, 2, 3])
    with sched._lock:
        order = [sched._pop_next().request_id for _ in range(6)]
    assert order == [f"r{i}" for i in range(6)]


def test_priority_and_tenant_validation(paged_engine):
    sched = Scheduler(paged_engine)
    with pytest.raises(ValueError, match="priority"):
        sched.submit(Request(prompt=[1], priority="urgent"))
    with pytest.raises(ValueError, match="tenant_id"):
        sched.submit(Request(prompt=[1], tenant_id=""))
    assert tuple(PRIORITIES) == ("interactive", "batch", "background")
    for bad in ({"interactive": 1}, {"interactive": 0, "batch": 1,
                                     "background": 1}, [("a", "b")]):
        with pytest.raises(ValueError, match="priority_weights"):
            ServeConfig(priority_weights=bad)
    assert ServeConfig(priority_weights=[("batch", 2), ("interactive", 1),
                                         ("background", 3)]
                       ).priority_weights == (("interactive", 1),
                                              ("batch", 2),
                                              ("background", 3))


def test_tenant_over_limit_typed(models):
    """The per-tenant cap fails typed (a QueueFull that names the
    tenant), across lanes, while other tenants still admit."""
    engine = Engine(models[2], dataclasses.replace(PCFG,
                                                   tenant_queue_cap=2))
    sched = Scheduler(engine)
    _submit(sched, "a0", [1, 2], tenant="acme")
    _submit(sched, "a1", [1, 2], tenant="acme")
    with pytest.raises(TenantOverLimit, match="acme"):
        _submit(sched, "a2", [1, 2], tenant="acme")
    assert issubclass(TenantOverLimit, QueueFull)
    _submit(sched, "x0", [1, 2], tenant="xcorp")
    assert sched.tenant_queue_depths() == {"acme": 2, "xcorp": 1}
    with pytest.raises(TenantOverLimit):
        _submit(sched, "a3", [1, 2], tenant="acme", priority="batch")
    _drain(sched)
    assert sched.tenant_queue_depths() == {}
    assert sorted(sched.results) == ["a0", "a1", "x0"]


def test_preemption_off_never_fires(models):
    engine = Engine(models[2], dataclasses.replace(PCFG, preemption=False))
    sched = Scheduler(engine)
    target = _Live(req=Request(prompt=[1], priority="interactive"),
                   request_id="t", submit_t=0.0, deadline_t=None)
    with sched._lock:
        assert sched._maybe_preempt(target, 0) is False


# ----------------------------------------------------------- preemption
PROMPT = [5, 9, 14, 20, 27, 35]


def _reference(engine, max_new=12):
    sched = Scheduler(engine)
    _submit(sched, "ref", PROMPT, priority="background", max_new=max_new)
    _drain(sched)
    res = sched.results["ref"]
    assert res.finish_reason == FinishReason.LENGTH
    return res.tokens


def _preempt_resume_case(engine):
    """A background decode suspended mid-stream by two interactive
    arrivals resumes and emits exactly the uninterrupted stream."""
    ref = _reference(engine)
    hits = getattr(engine.pool, "prefix_hits", 0)
    sched = Scheduler(engine)
    _submit(sched, "bg", PROMPT, priority="background", max_new=12)
    sched.step()
    with sched._lock:
        (bg,) = sched._live.values()
        assert len(bg.tokens) >= 1
    _submit(sched, "i0", [2, 4, 6], max_new=4)
    _submit(sched, "i1", [3, 5, 7], max_new=4)
    sched.step()
    assert sched.preempted_count == 1 and sched.preemptions == 1
    _drain(sched)
    assert sched.preempted_count == 0 and sched.resumes == 1
    for rid in ("i0", "i1"):
        assert sched.results[rid].finish_reason == FinishReason.LENGTH
    res = sched.results["bg"]
    assert res.finish_reason == FinishReason.LENGTH
    assert res.tokens == ref, "the resume is not the uninterrupted stream"
    assert len(set(ref)) > 3                 # a stream that can lose its place
    assert engine.pool.num_free == engine.cfg.max_batch_size
    engine.pool.leak_check()
    return ref, getattr(engine.pool, "prefix_hits", 0) - hits


def test_preempt_resume_tokens_equal_paged(models, paged_engine):
    """Paged: the victim's blocks go to the trie, and the resume is a
    prefix hit that prefills only its tail. The stream also equals what
    JAX's scheduler serves in the same scenario."""
    ref, hits = _preempt_resume_case(paged_engine)
    assert hits >= 1
    jm, jv, _ = models
    jeng = JaxEngine(jm, jv, JaxServeConfig(**PKW,
                                            cache_dtype=jnp.float32))
    jsched = JaxScheduler(jeng)
    _submit(jsched, "ref", PROMPT, priority="background", max_new=12,
            make=JaxRequest)
    _drain(jsched)
    assert jsched.results["ref"].tokens == ref


def test_preempt_resume_tokens_equal_dense(models):
    _, hits = _preempt_resume_case(Engine(models[2], DCFG))
    assert hits == 0                       # a cold re-prefill


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_preempt_resume_under_speculative_decoding(models, layout):
    """The draft pool follows the victim out and back in: the resumed
    stream is the uninterrupted one and neither pool leaks."""
    cfg = dataclasses.replace(PCFG, kv_layout=layout,
                              speculative=SpeculativeConfig(draft_k=2,
                                                            draft_layers=1))
    engine = Engine(models[2], cfg)
    _preempt_resume_case(engine)
    engine.draft_pool.leak_check()
    assert engine.spec_verifies > 0


def test_deadline_while_preempted(paged_engine):
    """A deadline keeps running while a request is suspended: it retires
    DEADLINE with the tokens it has, and never resumes. (The deadline is
    moved into the past once the request is suspended, so that a loaded
    machine cannot let it expire before the preemption.)"""
    sched = Scheduler(paged_engine)
    _submit(sched, "bg", [1, 2, 3, 4, 5, 6], priority="background",
            max_new=30, deadline_s=60.0)
    sched.step()
    _submit(sched, "i0", [2, 4, 6], max_new=3)
    _submit(sched, "i1", [3, 5, 7], max_new=3)
    sched.step()
    assert sched.preempted_count == 1
    with sched._lock:
        sched._preempted["bg"].deadline_t = time.monotonic() - 1.0
    sched.step()
    res = sched.results["bg"]
    assert res.finish_reason == FinishReason.DEADLINE
    assert 1 <= len(res.tokens) < 30
    assert sched.preempted_count == 0
    _drain(sched)
    assert paged_engine.pool.num_free == PCFG.max_batch_size
    paged_engine.pool.leak_check()


def test_preemption_budget_anti_thrash(paged_engine):
    sched = Scheduler(paged_engine)
    _submit(sched, "bg", [1, 2, 3], priority="background", max_new=6)
    sched.step()
    with sched._lock:
        (victim,) = sched._live.values()
        victim.preempt_count = PCFG.preemption_budget
    _submit(sched, "i0", [2, 4, 6], max_new=3)
    _submit(sched, "i1", [3, 5, 7], max_new=3)
    sched.step()
    assert sched.preempted_count == 0
    assert sched.queue_depth == 1
    _drain(sched)
    assert sched.results["bg"].finish_reason == FinishReason.LENGTH
    assert len(sched.results["bg"].tokens) == 6


def test_slo_burn_widens_preemption_quota(paged_engine):
    sched = Scheduler(paged_engine)
    _submit(sched, "g0", [1, 2, 3], priority="background", max_new=10)
    _submit(sched, "g1", [4, 5, 6], priority="background", max_new=10)
    sched.step()
    with sched._lock:
        assert len(sched._live) == 2
    _submit(sched, "i0", [2, 4, 6], max_new=3)
    _submit(sched, "i1", [3, 5, 7], max_new=3)
    with sched._lock:
        sched._admit()
    assert sched.preempted_count == 1
    assert sched.queue_depth == 1
    sched.slo_tracker = types.SimpleNamespace(burn_rate=lambda: 2.0)
    with sched._lock:
        sched._admit()
    assert sched.preempted_count == 2
    assert sched.queue_depth == 0
    sched.slo_tracker = None
    _drain(sched)
    assert {r.finish_reason for r in sched.results.values()} == {
        FinishReason.LENGTH}
    paged_engine.pool.leak_check()


# ------------------------------------------------------------------ CLI
CLI = ["--random-init", "--model-preset", "tiny", "--device", "cpu",
       "--max-len", "64", "--max-prefill-len", "16", "--kv-block-size",
       "8", "--max-new-tokens", "48"]


def _cli(argv, lines):
    import json
    args = cli_serve.build_parser().parse_args(argv)
    sched = cli_serve.build_scheduler(args)
    out = io.StringIO()
    stdin = io.StringIO("".join(json.dumps(x) + "\n" for x in lines))
    assert cli_serve.run_stdio(sched, args, stdin=stdin, stdout=out) == 0
    return sched, {o["id"]: o for o in map(json.loads,
                                           out.getvalue().splitlines())}


def test_cli_scheduling_flags():
    """One slot held by a long request of tenant x; tenant t's second
    queued request is over its cap of 1 and gets the typed error line;
    weights, the preemption flags and the request fields parse."""
    sched, out = _cli(CLI + [
        "--max-batch-size", "1", "--tenant-queue-cap", "1",
        "--priority-weights", "interactive=3, batch=2,background=1",
        "--preemption", "on", "--preemption-budget", "1"], [
        {"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 40,
         "tenant_id": "x", "priority": "background"},
        {"id": "b", "prompt_tokens": [5, 17, 3], "max_new_tokens": 4,
         "tenant_id": "t", "priority": "batch"},
        {"id": "c", "prompt_tokens": [5, 17, 4], "max_new_tokens": 4,
         "tenant_id": "t"},
        {"id": "d", "prompt_tokens": [1], "priority": 3}])
    assert out["c"]["event"] == "error"
    assert out["c"]["error_type"] == "tenant_over_limit"
    assert "'t'" in out["c"]["error"]
    assert out["d"]["event"] == "error" and "priority" in out["d"]["error"]
    assert out["a"]["finish_reason"] == out["b"]["finish_reason"] == "length"
    cfg = sched.engine.cfg
    assert cfg.priority_weights == (("interactive", 3), ("batch", 2),
                                    ("background", 1))
    assert (cfg.preemption, cfg.preemption_budget,
            cfg.tenant_queue_cap) == (True, 1, 1)


@pytest.mark.parametrize("argv,match", [
    (["--priority-weights", "interactive=4,batch"], "class=int"),
    (["--priority-weights", "interactive=4,batch=2"], "priority_weights"),
    (["--tenant-queue-cap", "0"], "tenant_queue_cap"),
    (["--preemption-budget", "-1"], "preemption_budget")])
def test_cli_scheduling_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_serve.main(CLI + argv)
