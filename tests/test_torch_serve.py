"""The port's Engine + Scheduler against the JAX Engine + Scheduler on the
same weights (tiny preset, f32 model and f32 KV pools, greedy): token
lists must be identical for a short prompt, a prompt chunked past
max_prefill_len (the prefill kernel at start > 0), and requests sharing a
32-token prefix (a prefix-cache hit, and one that copies a shared block
on write). Plus what the port alone can pin: sampling laws, typed
refusals of settings it does not serve, and the stdio front end."""

import json
import subprocess
import sys
from pathlib import Path

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
from nezha_tpu.serve.sampling import filter_logits as jax_filter_logits
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.serve import (Engine, NotPortedError, Request,
                                   Scheduler, ServeConfig, filter_logits,
                                   sample_tokens)

SERVE_KW = dict(max_batch_size=3, max_len=96, max_prefill_len=16,
                kv_block_size=8, k_max=16)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


def _torch_sched(tm):
    return Scheduler(Engine(tm, ServeConfig(**SERVE_KW,
                                            cache_dtype=torch.float32)))


def _run(sched, make_request, waves):
    """Submit each wave of (id, prompt, max_new) together and drain it."""
    for wave in waves:
        for rid, prompt, max_new in wave:
            sched.submit(make_request(prompt=list(prompt),
                                      max_new_tokens=max_new,
                                      request_id=rid))
        sched.run_until_idle(max_iters=200)
        assert not sched.has_work()
    return {rid: res for rid, res in sched.results.items()}


def test_greedy_tokens_identical_to_jax(models):
    jm, jv, tm = models
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 512, 32).tolist()
    waves = [
        [("short", rng.randint(0, 512, 5), 10),
         ("chunked", rng.randint(0, 512, 40), 12)],
        [("donor", prefix + rng.randint(0, 512, 5).tolist(), 8)],
        # "cow" IS the shared prefix: the hit is capped at 31 positions,
        # so its first write lands in a shared block and copies it;
        # "hit" extends the prefix and writes past the shared blocks.
        [("cow", prefix, 8),
         ("hit", prefix + rng.randint(0, 512, 7).tolist(), 8)],
    ]
    jsched = JaxScheduler(JaxEngine(jm, jv, JaxServeConfig(
        **SERVE_KW, cache_dtype=jnp.float32)))
    want = _run(jsched, JaxRequest, waves)
    tsched = _torch_sched(tm)
    got = _run(tsched, Request, waves)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason == "length"
    pool = tsched.engine.pool
    assert pool.prefix_hits >= 2 and pool.cow_copies >= 1
    pool.leak_check()


def test_sampling_top_k_one_is_greedy_and_seeded(models):
    _, _, tm = models
    sched = _torch_sched(tm)
    prompt = list(range(3, 12))
    greedy = Request(prompt=prompt, max_new_tokens=8, request_id="g")
    topk1 = Request(prompt=prompt, max_new_tokens=8, temperature=0.9,
                    top_k=1, seed=3, request_id="k1")
    s1 = Request(prompt=prompt, max_new_tokens=8, temperature=1.0,
                 seed=7, request_id="s1")
    s2 = Request(prompt=prompt, max_new_tokens=8, temperature=1.0,
                 seed=7, request_id="s2")
    for r in (greedy, topk1, s1):
        sched.submit(r)
    sched.run_until_idle(max_iters=100)
    sched.submit(s2)           # alone in the batch: neighbours differ
    sched.run_until_idle(max_iters=100)
    res = sched.results
    assert res["k1"].tokens == res["g"].tokens
    assert res["s1"].tokens == res["s2"].tokens
    sched.engine.pool.leak_check()


def test_filter_logits_matches_jax():
    """Per-row temperature / top-k / top-p truncation keeps exactly the
    support JAX keeps, with the same scaled values (f32, atol 1e-6)."""
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 40).astype(np.float32) * 3
    temp = np.asarray([0.5, 1.0, 2.0, 0.0, 1.3, 0.7], np.float32)
    top_k = np.asarray([0, 1, 5, 3, 40, 9], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 0.0, 0.95, 0.3], np.float32)
    want = np.asarray(jax_filter_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), 16))
    got = filter_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                        torch.from_numpy(top_k), torch.from_numpy(top_p),
                        16).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], atol=1e-6, rtol=0)


def test_decode_horizon_invariant(models):
    """A request's tokens do not depend on the decode horizon — greedy or
    sampled: a sampled row's generator advances once per emitted token,
    and a row that finishes mid-block stops emitting (budgets of 5 and 7
    end inside a horizon-4 block)."""
    _, _, tm = models
    results = []
    for horizon in (1, 4):
        sched = Scheduler(Engine(tm, ServeConfig(
            **SERVE_KW, cache_dtype=torch.float32, decode_horizon=horizon)))
        sched.submit(Request(prompt=list(range(7, 20)), max_new_tokens=5,
                             request_id="g"))
        sched.submit(Request(prompt=list(range(30, 41)), max_new_tokens=7,
                             temperature=0.8, top_p=0.9, seed=11,
                             request_id="s"))
        sched.run_until_idle(max_iters=100)
        sched.engine.pool.leak_check()
        results.append({k: r.tokens for k, r in sched.results.items()})
    assert results[0] == results[1]
    assert len(results[0]["g"]) == 5 and len(results[0]["s"]) == 7


def test_sampled_support_respects_top_k():
    gen = torch.Generator().manual_seed(0)
    n, v, k = 4000, 32, 3
    logits = torch.randn(1, v, generator=gen).expand(n, v).contiguous()
    u = torch.rand(n, generator=gen)
    toks = sample_tokens(logits, u, torch.full((n,), 2.0),
                         torch.full((n,), k, dtype=torch.int32),
                         torch.ones(n), k_max=8)
    allowed = set(torch.topk(logits[0], k).indices.tolist())
    assert set(toks.tolist()) == allowed


@pytest.mark.parametrize("field,valid,invalid", [
    ("kv_host_blocks", None, {"kv_host_blocks": 4}),
    ("speculative", {}, {"speculative": {"draft_k": 0}}),
    ("kv_layout", "dense", {"kv_layout": "ring"}),
    ("priority_weights", {"interactive": 4, "batch": 2, "background": 1},
     {"priority_weights": {"interactive": 1}}),
    ("tenant_queue_cap", 2, {"tenant_queue_cap": 0}),
    ("preemption", True, {"preemption": True, "preemption_budget": -1})])
def test_out_of_slice_settings_refused_typed(field, valid, invalid):
    """The host KV tier is still refused typed. The other settings this
    test once refused are served now: a valid value builds a ServeConfig,
    and an invalid one raises the ValueError JAX's ServeConfig raises."""
    assert issubclass(NotPortedError, ValueError)
    if valid is None:
        with pytest.raises(NotPortedError, match=field):
            ServeConfig(**invalid)
        return
    assert ServeConfig(**{field: valid}) is not None
    bad = list(invalid)[-1]
    with pytest.raises(ValueError, match=bad) as info:
        ServeConfig(**invalid)
    assert not isinstance(info.value, NotPortedError)
    with pytest.raises(ValueError, match=bad):
        JaxServeConfig(**invalid)


def test_serveconfig_kv_dtype_validation():
    """JAX ``test_kv_quant.py:524``: an unknown KV dtype is a ValueError,
    and int8 needs the paged layout."""
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeConfig(kv_dtype="fp8")
    with pytest.raises(ValueError, match="paged"):
        ServeConfig(kv_layout="dense", kv_dtype="int8")
    assert ServeConfig(kv_dtype="int8").kv_dtype == "int8"


def test_stdio_jsonl_server():
    lines = [{"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 4},
             {"id": "b", "prompt_tokens": list(range(1, 30)),
              "max_new_tokens": 3, "temperature": 0.7, "seed": 1}]
    proc = subprocess.run(
        [sys.executable, "-m", "nezha_tpu_torch.cli.serve", "--random-init",
         "--model-preset", "tiny", "--device", "cpu", "--max-len", "64",
         "--max-prefill-len", "16", "--kv-block-size", "8"],
        input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    out = {o["id"]: o for o in map(json.loads, proc.stdout.splitlines())}
    assert len(out["a"]["tokens"]) == 4 and len(out["b"]["tokens"]) == 3
    assert out["a"]["finish_reason"] == "length"
