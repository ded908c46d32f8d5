"""The port's int8 host KV tier (``PagedSlotPool(host_blocks=...)``,
``ServeConfig.kv_host_blocks``) against the JAX package's, after
``tests/test_kv_host_tier.py``, on the tiny preset with JAX's weights
(``params_from_jax``), f32 models, int8 pools, greedy:

- config and pool validation, with JAX's messages word for word;
- demote then promote bit identity (a promoted block is the evicted one's
  bytes), and a promoted revisit's tokens equal to a cold engine's;
- the same traffic through JAX's engine: the same blocks demoted and
  promoted under the same keys in the same LRU order, the same ledgers and
  tokens; each demoted payload is bitwise the pool's block at eviction on
  both sides, and across the packages within the int8 pools' own
  tolerance (JAX requantizes under jit, which rounds about one scale in
  twenty one ulp the other way, ROADMAP C8: scales within 1e-6 relative,
  values within one int8 step);
- the LRU cap, a promote racing eviction, the aligned-prompt admission
  budget, a failed promote whose restore re-applies the cap, and a failed
  promote degrading to a cold prefill;
- a seeded multi-turn churn with ``leak_check`` after every drain;
- bf16 pools and a disabled tier unchanged; the CLI's plumbing."""

import dataclasses

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.serve import Engine as JaxEngine
from nezha_tpu.serve import PagedSlotPool as JaxPagedSlotPool
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.serve import (Engine, KVBlocksExhausted, PagedSlotPool,
                                   Request, Scheduler, ServeConfig)
from nezha_tpu_torch.serve.slots import _gather_blocks_quantized

# tests/test_kv_host_tier.py's serving shapes: blocks of 4 and a small
# block budget, so eviction (hence demotion) fires at test sizes.
HKW = dict(max_batch_size=2, max_len=32, max_prefill_len=8,
           prefill_buckets=(4, 8), k_max=16, queue_capacity=8,
           kv_block_size=4, kv_num_blocks=9, kv_dtype="int8",
           kv_host_blocks=16)
HCFG = ServeConfig(**HKW, cache_dtype=torch.float32)
JHCFG = JaxServeConfig(**HKW, cache_dtype=jnp.float32)


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


def _drain(sched, max_iters=400):
    sched.run_until_idle(max_iters=max_iters)
    assert not sched.has_work(), "scheduler did not drain"


def _gather_host(pool, blocks):
    idx = torch.tensor([int(b) for b in blocks], dtype=torch.long)
    return [{k: v.numpy() for k, v in layer.items()}
            for layer in _gather_blocks_quantized(pool.caches, idx)]


def _assert_payload_equal(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert set(la) == set(lb) == {"k", "v", "k_scale", "v_scale"}
        for key in la:
            np.testing.assert_array_equal(la[key], lb[key])


def _prompt(n, mul=3, add=5):
    return [(mul * i + add) % 97 for i in range(n)]


# -------------------------------------------------- config validation
def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kw", [
    dict(kv_host_blocks=-1), dict(kv_host_blocks=8),
    dict(kv_layout="dense", kv_host_blocks=8),
    dict(kv_dtype="int8", prefix_cache=False, kv_host_blocks=8),
    dict(kv_dtype="int8", kv_eviction="none", kv_host_blocks=8)])
def test_host_tier_config_validation_matches_jax(kw):
    assert _message(lambda: ServeConfig(**kw)) == _message(
        lambda: JaxServeConfig(**kw))
    ok = dict(kv_dtype="int8", kv_host_blocks=8)
    assert ServeConfig(**ok).kv_host_blocks == 8


@pytest.mark.parametrize("kw", [
    dict(host_blocks=4), dict(host_blocks=-1),
    dict(quantized=True, prefix_cache=False, host_blocks=4)])
def test_host_tier_pool_validation_matches_jax(models, kw):
    jm, _, tm = models
    got = _message(lambda: PagedSlotPool(tm.cfg, 1, 16, block_size=4,
                                         device="cpu", **kw))
    assert got == _message(lambda: JaxPagedSlotPool(jm, 1, 16, block_size=4,
                                                    **kw))


# ------------------------------------------------- demote -> promote
def test_demote_promote_bit_identity_and_token_parity(models):
    """A demoted block's int8 payload and scales come back bit-identical
    on promotion (against a gather taken before the eviction), and the
    promoted revisit decodes what a cold engine does."""
    _, _, tm = models
    eng = Engine(tm, HCFG)
    sched = Scheduler(eng)
    prompt_a = _prompt(10)                      # two full blocks
    sched.submit(Request(prompt=prompt_a, max_new_tokens=2, request_id="a"))
    _drain(sched)
    cached = eng.pool.trie.match(prompt_a)
    assert len(cached) == 2
    before = _gather_host(eng.pool, cached)
    # A 30-token prompt binds every usable block: A's two are demoted.
    sched.submit(Request(prompt=_prompt(30, 7, 1), max_new_tokens=2,
                         request_id="b"))
    _drain(sched)
    pool = eng.pool
    assert pool.trie.match(prompt_a) == []
    assert pool.demotions >= 2 and pool.host_blocks_used >= 2
    _assert_payload_equal([{k: v[:1] for k, v in layer.items()}
                           for layer in before],
                          pool._host_tier[tuple(prompt_a[:4])])
    _assert_payload_equal([{k: v[1:2] for k, v in layer.items()}
                           for layer in before],
                          pool._host_tier[tuple(prompt_a[:8])])
    prompt_a2 = prompt_a[:8] + [33, 44]
    sched.submit(Request(prompt=prompt_a2, max_new_tokens=2,
                         request_id="a2"))
    _drain(sched)
    assert pool.promotions >= 2 and pool.fleet_hits["host"] >= 1
    promoted = pool.trie.match(prompt_a2)
    assert len(promoted) == 2
    _assert_payload_equal(before, _gather_host(pool, promoted))
    assert tuple(prompt_a[:4]) not in pool._host_tier
    assert tuple(prompt_a[:8]) not in pool._host_tier
    pool.leak_check()
    cold = Scheduler(Engine(tm, dataclasses.replace(
        HCFG, kv_host_blocks=0, prefix_cache=False)))
    cold.submit(Request(prompt=prompt_a2, max_new_tokens=2, request_id="c"))
    _drain(cold)
    assert sched.results["a2"].tokens == cold.results["c"].tokens
    assert sched.results["a2"].finish_reason == "length"


def _churn(sched, make_request, users, turns=3, new=3):
    """Round-robin turns over ``users`` (each turn: the user's first two
    blocks, two of its last answer's tokens and one more), drained a turn
    at a time, ``leak_check`` after every drain. -> every result's
    tokens, in order."""
    prompts = [list(u) for u in users]
    out = []
    for turn in range(turns):
        rids = []
        for u, p in enumerate(prompts):
            rid = f"u{u}t{turn}"
            sched.submit(make_request(prompt=p, max_new_tokens=new,
                                      request_id=rid))
            rids.append(rid)
        _drain(sched)
        sched.engine.pool.leak_check()
        for u, rid in enumerate(rids):
            res = sched.results[rid]
            assert res.finish_reason == "length", res.error
            out.append(res.tokens)
            prompts[u] = users[u][:8] + res.tokens[:2] + [u + turn]
    return out


@pytest.fixture
def pallas_load(monkeypatch):
    # jax 0.9.0 dropped pl.load, which prefill_attention.py:212 calls in
    # the int8 kernel's write; a plain ref read does the same.
    monkeypatch.setattr(jax.experimental.pallas, "load",
                        lambda ref, idx: ref[idx], raising=False)


def test_same_traffic_as_jax_demotes_and_promotes_the_same(models,
                                                           pallas_load):
    """The port and JAX under one seeded multi-turn churn: equal greedy
    tokens, demotion and promotion counts, host-tier keys in LRU order and
    ``fleet_hits``. Each demoted entry is bitwise what its pool held for
    that block when it was evicted (``_demote`` wrapped to gather first);
    across packages the entries agree within the int8 pools' tolerance.
    JAX runs its Pallas kernels (interpret mode), as the port runs its
    kernels' plain versions: its composed prefill attends the chunk's
    quantized K/V where the kernels attend the fresh ones."""
    jm, jv, tm = models
    users = [_prompt(10, 13 * u + 3, 5) for u in range(4)]
    eng = Engine(tm, HCFG)
    jeng = JaxEngine(jm, jv, dataclasses.replace(
        JHCFG, prefill_impl="kernel", decode_impl="kernel"))
    seen = []
    inner = eng.pool._demote

    def demote(path, block):
        seen.append((tuple(path), _gather_host(eng.pool, [block])))
        inner(path, block)

    eng.pool._demote = demote
    got = _churn(Scheduler(eng), Request, users)
    want = _churn(JaxScheduler(jeng), JaxRequest, users)
    assert got == want
    pool, jpool = eng.pool, jeng.pool
    assert pool.demotions == jpool.demotions == len(seen) > 0
    assert pool.promotions == jpool.promotions > 0
    assert pool.promote_failures == jpool.promote_failures == 0
    assert pool.fleet_hits == jpool.fleet_hits
    assert list(pool._host_tier) == list(jpool._host_tier)
    assert pool.host_bytes_resident == jpool.host_bytes_resident
    last = dict(seen)
    for key, entry in pool._host_tier.items():
        _assert_payload_equal(last[key], entry)
        for mine, theirs in zip(entry, jpool._host_tier[key]):
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(mine[name], theirs[name],
                                           rtol=1e-6, atol=0)
            for name in ("k", "v"):
                step = np.abs(mine[name].astype(np.int32)
                              - theirs[name].astype(np.int32))
                assert step.max() <= 1, name


def test_host_lru_budget_cap(models):
    _, _, tm = models
    eng = Engine(tm, dataclasses.replace(HCFG, kv_host_blocks=2))
    sched = Scheduler(eng)
    prompts = [_prompt(10, 3, 11 * u + 5) for u in range(3)]
    for u, p in enumerate(prompts):
        sched.submit(Request(prompt=p, max_new_tokens=2, request_id=f"u{u}"))
        _drain(sched)
    sched.submit(Request(prompt=_prompt(30, 7, 2), max_new_tokens=2))
    _drain(sched)
    pool = eng.pool
    assert pool.demotions > 2
    assert pool.host_blocks_used <= 2
    assert pool.host_bytes_resident == sum(
        pool._entry_bytes(e) for e in pool._host_tier.values())
    pool.leak_check()
    assert tuple(prompts[0][:4]) not in pool._host_tier
    pool._host_bytes += 1
    with pytest.raises(AssertionError, match="byte books"):
        pool.leak_check()
    pool._host_bytes -= 1
    n = pool.host_blocks_used
    assert pool.clear_host_tier() == n > 0
    assert pool.host_blocks_used == 0 and pool.host_bytes_resident == 0
    pool.leak_check()


def _cached(pool, toks, end):
    s = pool.alloc()
    pool.bind_for_prompt(s, toks)
    pool.prepare_write(s, 0, end)
    pool.register_prefix(s, toks)
    return s


def test_promote_racing_concurrent_eviction(models):
    """A promotion whose own allocations evict (hence demote) other
    entries: the popped entries cannot be raced away, the third party
    lands in the tier, and the promoted bytes are the demoted ones."""
    _, _, tm = models
    pool = PagedSlotPool(tm.cfg, 3, 16, torch.float32, block_size=4,
                         num_blocks=6, quantized=True, host_blocks=8,
                         device="cpu")
    t1, t2, t3 = _prompt(9, 3, 1), _prompt(9, 5, 2), _prompt(12, 7, 3)
    s = _cached(pool, t1, 9)
    t1_bytes = _gather_host(pool, pool.tables_host[s, :2])
    pool.free(s)
    pool.free(_cached(pool, t2, 9))
    s3 = pool.alloc()
    pool.bind_for_prompt(s3, t3)
    pool.prepare_write(s3, 0, 12)
    assert pool.demotions == 2 and pool.trie.match(t1) == []
    s4 = pool.alloc()
    assert pool.bind_for_prompt(s4, t1) == 8
    assert pool.promotions == 2 and pool.demotions == 4
    assert pool.trie.match(t2) == [] and tuple(t2[:4]) in pool._host_tier
    _assert_payload_equal(t1_bytes, _gather_host(pool,
                                                 pool.tables_host[s4, :2]))
    pool.leak_check()
    pool.free(s4)
    pool.free(s3)
    pool.leak_check()
    pool.clear_prefix_cache()
    assert pool.blocks_used == 0
    assert pool.clear_host_tier() > 0
    pool.leak_check()


def test_promote_never_exceeds_admission_budget_on_aligned_prompt(models):
    """A block-aligned prompt's last block always re-runs, so it is not
    promoted (it would be copied on write at once): the promote-path
    prefill allocates no more than the cold footprint admission
    budgeted."""
    _, _, tm = models
    eng = Engine(tm, HCFG)
    sched = Scheduler(eng)
    prompt = _prompt(8)                          # exactly two blocks
    sched.submit(Request(prompt=prompt, max_new_tokens=2))
    _drain(sched)
    sched.submit(Request(prompt=_prompt(30, 7, 1), max_new_tokens=2))
    _drain(sched)
    assert eng.pool.host_blocks_used >= 2
    need = eng.prefill_blocks_needed(len(prompt))
    used_before = eng.pool.blocks_used
    slot = eng.pool.alloc()
    eng.prefill(slot, prompt, max_new_tokens=2)
    assert eng.pool.promotions == 1
    assert eng.pool.blocks_used - used_before <= need
    eng.pool.free(slot)
    eng.pool.leak_check()


def test_failed_promote_restore_reapplies_host_budget_cap(models):
    """A promote that runs out of blocks mid-allocation, after its first
    allocation demoted a third party into a tier at its cap: the restore
    trims back to the cap, both tiers' books balance. The pool is sized
    so that the second allocation finds nothing to evict (JAX's test
    injects a fault there)."""
    _, _, tm = models
    pool = PagedSlotPool(tm.cfg, 3, 20, torch.float32, block_size=4,
                         num_blocks=7, quantized=True, host_blocks=2,
                         device="cpu")
    t1, t2 = _prompt(9, 3, 1), _prompt(5, 5, 2)
    pool.free(_cached(pool, t1, 9))             # t1: 2 cached blocks
    pool.free(_cached(pool, t2, 5))             # t2: 1 cached block
    s3 = pool.alloc()
    pool.bind_for_prompt(s3, _prompt(20, 7, 3))
    pool.prepare_write(s3, 0, 20)               # demotes t1's chain
    assert pool.host_blocks_used == 2 and pool.demotions == 2
    s4 = pool.alloc()
    assert pool.bind_for_prompt(s4, t1) == 0     # degraded: cold
    assert pool.promote_failures == 1 and pool.promotions == 0
    assert pool.demotions == 3                   # t2's block, mid-promote
    assert list(pool._host_tier) == [tuple(t1[:4]), tuple(t1[:8])]
    pool.leak_check()
    pool.free(s4)
    pool.free(s3)
    pool.clear_prefix_cache()
    pool.clear_host_tier()
    pool.leak_check()
    assert pool.blocks_used == 0


def test_failed_promote_degrades_to_cold_prefill(models, monkeypatch):
    """A promote whose allocation raises KVBlocksExhausted degrades the
    request to a cold prefill: served, tokens equal a cold engine's,
    ``promote_failures`` counted, the entries left resident. Under the
    scheduler's admission budget a tight pool cannot get here (a cold
    prefill that fits leaves room for the promote, whose span it
    contains), so the exhaustion is raised by a test-local wrapper of the
    pool's allocator, as JAX's test injects its fault."""
    _, _, tm = models
    eng = Engine(tm, HCFG)
    sched = Scheduler(eng)
    prompt = _prompt(10)
    sched.submit(Request(prompt=prompt, max_new_tokens=2))
    _drain(sched)
    sched.submit(Request(prompt=_prompt(30, 7, 1), max_new_tokens=2))
    _drain(sched)
    assert eng.pool.host_blocks_used >= 2
    cold = Scheduler(Engine(tm, dataclasses.replace(
        HCFG, kv_host_blocks=0, prefix_cache=False)))
    cold.submit(Request(prompt=prompt, max_new_tokens=2, request_id="c"))
    _drain(cold)
    inner = eng.pool._alloc_block
    calls = {"n": 0}

    def exhausted_once(slot):
        calls["n"] += 1
        if calls["n"] == 1:
            raise KVBlocksExhausted("test: no block", slot=slot)
        return inner(slot)

    real = eng.pool._promote

    def promote(*a):
        monkeypatch.setattr(eng.pool, "_alloc_block", exhausted_once)
        try:
            return real(*a)
        finally:
            monkeypatch.setattr(eng.pool, "_alloc_block", inner)

    monkeypatch.setattr(eng.pool, "_promote", promote)
    sched.submit(Request(prompt=prompt, max_new_tokens=2, request_id="r1"))
    _drain(sched)
    res = sched.results["r1"]
    assert res.finish_reason == "length"
    assert res.tokens == cold.results["c"].tokens
    assert eng.pool.promotions == 0 and eng.pool.promote_failures == 1
    assert tuple(prompt[:4]) in eng.pool._host_tier
    eng.pool.leak_check()


def test_seeded_multiturn_churn_zero_leaks(models):
    """Templated churn with greedy and sampled requests: every request
    answered, the books of both tiers balanced after every drain, and
    both tiers empty once the caches are cleared."""
    _, _, tm = models
    cfg = dataclasses.replace(HCFG, queue_capacity=32)
    eng = Engine(tm, cfg)
    sched = Scheduler(eng)
    users = [_prompt(10, 13 * u + 3, 5) for u in range(4)]
    for wave in range(5):
        rids = []
        for i in range(4):
            k = 4 * wave + i
            prompt = (users[i][:8] + [k % 97, (2 * k) % 97]
                      if wave else users[i])
            rids.append(sched.submit(Request(
                prompt=prompt, max_new_tokens=4,
                temperature=0.8 if k % 3 == 0 else 0.0,
                top_k=10 if k % 3 == 0 else None, seed=k,
                request_id=f"c{k}")))
        _drain(sched)
        eng.pool.leak_check()
        assert {sched.results[r].finish_reason for r in rids} == {"length"}
    assert eng.pool.demotions > 0 and eng.pool.promotions > 0
    assert eng.pool.num_free == cfg.max_batch_size
    eng.pool.clear_prefix_cache()
    eng.pool.clear_host_tier()
    eng.pool.leak_check()
    assert eng.pool.blocks_used == 0 and eng.pool.host_blocks_used == 0


def test_no_host_tier_and_bf16_pools_unchanged(models):
    _, _, tm = models
    for cfg in (dataclasses.replace(HCFG, kv_host_blocks=0),
                dataclasses.replace(HCFG, kv_host_blocks=0, kv_dtype="bf16"),
                dataclasses.replace(HCFG, kv_host_blocks=0, kv_dtype="bf16",
                                    kv_eviction="none")):
        eng = Engine(tm, cfg)
        sched = Scheduler(eng)
        sched.submit(Request(prompt=_prompt(10), max_new_tokens=2))
        _drain(sched)
        sched.submit(Request(prompt=_prompt(30, 7, 1), max_new_tokens=2))
        _drain(sched)
        assert eng.pool.demotions == eng.pool.promotions == 0
        assert eng.pool.host_blocks_used == eng.pool.host_bytes_resident == 0
        assert eng.pool.fleet_hits["host"] == 0
        eng.pool.leak_check()


def test_serve_cli_host_blocks_plumbing():
    """``--kv-host-blocks`` parses (off by default) and reaches the target
    pool; an invalid combination exits with ServeConfig's reason."""
    parse = serve_cli.build_parser().parse_args
    base = ["--random-init", "--model-preset", "tiny", "--device", "cpu",
            "--max-len", "64", "--max-prefill-len", "16",
            "--kv-block-size", "8"]
    assert parse(base).kv_host_blocks == 0
    args = parse(base + ["--kv-dtype", "int8", "--kv-host-blocks", "48"])
    assert args.kv_host_blocks == 48
    sched = serve_cli.build_scheduler(args)
    assert sched.engine.pool.host_blocks == 48
    with pytest.raises(SystemExit, match="int8"):
        serve_cli.build_scheduler(parse(base + ["--kv-host-blocks", "8"]))
    spec = serve_cli.build_scheduler(parse(base + [
        "--kv-dtype", "int8", "--kv-host-blocks", "8", "--speculative",
        "--draft-layers", "1"]))
    assert spec.engine.pool.host_blocks == 8
    assert spec.engine.draft_pool.host_blocks == 0
