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
    ("kv_host_blocks", {"kv_host_blocks": 4, "kv_dtype": "int8"},
     {"kv_host_blocks": 4}),
    ("speculative", {"speculative": {}}, {"speculative": {"draft_k": 0}}),
    ("kv_layout", {"kv_layout": "dense"}, {"kv_layout": "ring"}),
    ("priority_weights",
     {"priority_weights": {"interactive": 4, "batch": 2, "background": 1}},
     {"priority_weights": {"interactive": 1}}),
    ("tenant_queue_cap", {"tenant_queue_cap": 2}, {"tenant_queue_cap": 0}),
    ("preemption", {"preemption": True},
     {"preemption": True, "preemption_budget": -1})])
def test_out_of_slice_settings_refused_typed(field, valid, invalid):
    """The settings this test once refused as not ported are all served
    now, the host KV tier last: a valid setting builds a ServeConfig, and
    an invalid one raises the ValueError JAX's ServeConfig raises (the
    host tier on a bf16 pool: "int8"), never NotPortedError."""
    assert issubclass(NotPortedError, ValueError)
    cfg = ServeConfig(**valid)
    assert getattr(cfg, field) is not None
    bad = "int8" if field == "kv_host_blocks" else list(invalid)[-1]
    with pytest.raises(ValueError, match=bad) as info:
        ServeConfig(**invalid)
    assert not isinstance(info.value, NotPortedError)
    with pytest.raises(ValueError, match=bad) as want:
        JaxServeConfig(**invalid)
    assert str(info.value) == str(want.value)


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


# ---------------------------------------------------------- prefill_impl
@pytest.mark.parametrize("value", ["bogus", "flash"])
def test_prefill_impl_validation_matches_jax(value, models):
    """``ServeConfig.prefill_impl`` takes JAX's values with JAX's message
    (and the model's config refuses an unknown one); the engine's
    override reaches the model (the same tensors under a
    replaced config) and leaves the caller's model as it was."""
    with pytest.raises(ValueError) as mine:
        ServeConfig(prefill_impl=value)
    with pytest.raises(ValueError) as theirs:
        JaxServeConfig(prefill_impl=value)
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="prefill_impl"):
        GPT2(GPT2Config(**TINY_GPT2_KW, prefill_impl=value), device="cpu")
    _, _, tm = models
    for ok in (None, "auto", "kernel", "xla"):
        assert ServeConfig(prefill_impl=ok).prefill_impl == ok
        eng = Engine(tm, ServeConfig(**SERVE_KW, prefill_impl=ok))
        assert eng.model.cfg.prefill_impl == (ok or "auto")
    assert tm.cfg.prefill_impl == "auto"


def _spy_prefill_kernels(monkeypatch):
    """Count calls of the flash-prefill wrappers the model reaches."""
    import nezha_tpu_torch.models.gpt2 as gpt2_mod
    calls = {"n": 0}
    inner = gpt2_mod.paged_prefill_attention

    def spy(*a, **kw):
        calls["n"] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(gpt2_mod, "paged_prefill_attention", spy)
    return calls


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefill_impl_xla_forward_matches_jax_composed(kv_dtype,
                                                      monkeypatch):
    """``prefill_impl="xla"`` on both sides, the tiny preset over paged
    pools: a chunk at position 0 padded past the prompt, a chunk at a
    mid-block offset, another row's chunk. Logits within 1e-4 of JAX's
    (f32 model); float pools within 1e-6; int8 pools as
    ``tests/test_torch_int8_serve.py`` holds them (the two packages'
    f32 K/V differ in the last bits, which can move a block's scale by
    1e-6 relative and a value by one int8 step): scales within 1e-6
    relative, values within one step, each chunk's error sample within
    4e-5 relative. No flash-prefill wrapper is called."""
    calls = _spy_prefill_kernels(monkeypatch)
    kw = dict(TINY_GPT2_KW, prefill_impl="xla")
    jm = JaxGPT2(JaxGPT2Config(**kw))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    cfg = JaxGPT2Config(**kw)
    bs, m, n_blocks = 8, 6, 16
    d = cfg.hidden_size // cfg.num_heads
    rng = np.random.RandomState(1)
    tab = np.zeros((2, m), np.int32)
    tab[0] = rng.permutation(np.arange(1, n_blocks))[:m]
    tab[1, :2] = [b for b in range(1, n_blocks) if b not in tab[0]][:2]
    shape = (n_blocks, cfg.num_heads, bs, d)
    if kv_dtype == "int8":
        sshape = (n_blocks, cfg.num_heads)
        jcache = [{"k": jnp.zeros(shape, jnp.int8),
                   "v": jnp.zeros(shape, jnp.int8),
                   "k_scale": jnp.zeros(sshape), "v_scale": jnp.zeros(sshape)}
                  for _ in range(cfg.num_layers)]
    else:
        jcache = [{"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
                  for _ in range(cfg.num_layers)]
    keys = list(jcache[0])
    tcache = [{k: torch.from_numpy(np.array(v)) for k, v in c.items()}
              for c in jcache]

    def run(tokens, row_tab, pos):
        nonlocal jcache
        jrows = [{**c, "tables": jnp.asarray(row_tab)} for c in jcache]
        want, states = jm.apply(jv, jnp.asarray(tokens), cache=jrows,
                                pos=pos)
        new = [states[f"h{i}"]["attn"]["cache"]
               for i in range(cfg.num_layers)]
        jcache = [{k: c[k] for k in keys} for c in new]
        trows = [{**c, "tables": torch.from_numpy(row_tab)} for c in tcache]
        with torch.no_grad():
            got = tm(torch.from_numpy(tokens), cache=trows, pos=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        for jc, tc in zip(new, trows):
            assert ("qerr" in jc) == ("qerr" in tc)
            if "qerr" in jc:
                assert tc["qerr"].item() == pytest.approx(
                    float(jc["qerr"]), rel=4e-5, abs=0.0)
        for jc, tc in zip(jcache, tcache):
            for name in keys:
                if name.endswith("_scale"):
                    np.testing.assert_allclose(tc[name][1:].numpy(),
                                               np.asarray(jc[name])[1:],
                                               rtol=1e-6, atol=0)
                elif kv_dtype == "int8":
                    step = np.abs(tc[name][1:].numpy().astype(np.int32)
                                  - np.asarray(jc[name])[1:].astype(
                                      np.int32))
                    assert step.max() <= 1, name
                else:
                    np.testing.assert_allclose(tc[name].numpy(),
                                               np.asarray(jc[name]),
                                               atol=1e-6, rtol=0)

    prompt = rng.randint(0, 512, 21)
    chunk = np.zeros((1, 16), np.int64)
    chunk[0, :13] = prompt[:13]
    run(chunk, tab[:1], 0)
    run(prompt[None, 13:21], tab[:1], 13)              # mid-block start
    run(prompt[None, :8], tab[1:], 0)
    assert calls["n"] == 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_impl_xla_greedy_tokens_equal_jax(models, kv_dtype,
                                                  monkeypatch):
    """Engines with ``prefill_impl="xla"`` on both sides (f32 pools, or
    int8): greedy tokens equal over a short, a chunked and two
    prefix-sharing prompts; the port never calls a flash-prefill
    wrapper, and its tokens equal its own kernel engine's."""
    jm, jv, tm = models
    calls = _spy_prefill_kernels(monkeypatch)
    rng = np.random.RandomState(4)
    prefix = rng.randint(0, 512, 24).tolist()
    waves = [[("short", rng.randint(0, 512, 5), 8),
              ("chunked", rng.randint(0, 512, 40), 8)],
             [("donor", prefix + rng.randint(0, 512, 5).tolist(), 6)],
             [("hit", prefix + rng.randint(0, 512, 7).tolist(), 6)]]
    kw = dict(SERVE_KW, kv_dtype=kv_dtype)
    jsched = JaxScheduler(JaxEngine(jm, jv, JaxServeConfig(
        **kw, cache_dtype=jnp.float32, prefill_impl="xla")))
    want = _run(jsched, JaxRequest, waves)
    tsched = Scheduler(Engine(tm, ServeConfig(
        **kw, cache_dtype=torch.float32, prefill_impl="xla")))
    got = _run(tsched, Request, waves)
    assert calls["n"] == 0
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    assert tsched.engine.pool.prefix_hits >= 1
    tsched.engine.pool.leak_check()
    kernels = _run(Scheduler(Engine(tm, ServeConfig(
        **kw, cache_dtype=torch.float32))), Request, waves)
    assert calls["n"] > 0
    assert {r: x.tokens for r, x in kernels.items()} == {
        r: x.tokens for r, x in got.items()}
