"""The rest of sharded serving in the port (``serve/sharded``) against
the JAX package, after ``tests/test_sharded.py``: every serve path JAX
runs under ``--mesh`` runs under the port's mesh (``[cpu] * M``), on the
JAX tests' tiny model (vocab 64, 2 layers, 4 heads, hidden 32, JAX's
init with the attention and MLP matrices scaled by 6) and f32 pools:

- speculative decoding at M=2 (a one-layer self-draft, an identity
  self-draft, an explicit draft model): greedy tokens equal to JAX's
  ``ShardedEngine`` and JAX's single-device engine; int8 pools equal to
  the port's one-device speculative engine; both pools head-sharded,
  mirrored and leak-free; the draft pool counted by ``memory_report``;
- ``decode_impl``/``prefill_impl`` "xla" and the forced kernels
  (``tests/test_sharded.py:149``) against JAX's sharded engine;
- the int8 host tier at M=2 (demotions, promotions, full-head entries,
  tokens) against JAX's mesh-2 host tier on the same churn;
- gather-on-export: a mesh-2 export is its shards' head groups
  concatenated, bitwise; against JAX's mesh-2 export within two int8
  steps (JAX quantizes under jit, ROADMAP C8); the same blocks installed
  into a mesh-2 and a one-device pool export bitwise alike;
  scatter-on-install from a JAX export, whose migrated request decodes
  JAX's tokens; ``/kv_export`` and ``/kv_ack`` answering on a mesh;
- seeded chaos with speculation and the host tier on, no leak on any
  shard (``tests/test_sharded.py:300``), and the serve CLI's ``--mesh``
  with ``--speculative`` and ``--kv-host-blocks``."""

import io
import json

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.serve import Engine as JaxEngine
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu.serve import migrate as jax_migrate
from nezha_tpu.serve.engine import SpeculativeConfig as JaxSpecConfig
from nezha_tpu.serve.sharded import ShardedEngine as JaxShardedEngine
from nezha_tpu_torch import faults
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.models import GPT2, GPT2Config
from nezha_tpu_torch.serve import (Engine, Request, Scheduler, ServeConfig,
                                   ShardedEngine, SpeculativeConfig,
                                   migrate)
from nezha_tpu_torch.serve.sharded.pool import ShardedPagedSlotPool
from nezha_tpu_torch.serve.slots import _gather_blocks_quantized
from test_torch_sharded import CFG, make_pair

# tests/test_sharded.py's SCFG, and its prompts.
SKW = dict(max_batch_size=3, max_len=32, max_prefill_len=8,
           prefill_buckets=(4, 8), k_max=16, queue_capacity=8)
PROMPTS = [[3, 5, 7, 9], [11, 2, 4], [1, 2, 3, 4, 5, 6, 7, 8, 9],
           [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9]]
# Blocks of 4 and a small budget: eviction (hence demotion) fires.
HKW = dict(SKW, max_batch_size=2, kv_block_size=4, kv_num_blocks=9,
           kv_dtype="int8", kv_host_blocks=16)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture
def pallas_load(monkeypatch):
    # jax 0.9.0 dropped pl.load, which the JAX int8 prefill kernel's
    # write calls; a plain ref read does the same.
    monkeypatch.setattr(jax.experimental.pallas, "load",
                        lambda ref, idx: ref[idx], raising=False)


def _greedy(engine, make_request, prompts=PROMPTS, max_new=6):
    sched = (Scheduler if make_request is Request else JaxScheduler)(engine)
    for i, p in enumerate(prompts):
        sched.submit(make_request(prompt=list(p), max_new_tokens=max_new,
                                  request_id=f"r{i}"))
    sched.run_until_idle(max_iters=400)
    assert not sched.has_work()
    return {k: v.tokens for k, v in sched.results.items()}


def _cfg(**kw):
    return ServeConfig(**{**SKW, **kw}, cache_dtype=torch.float32)


def _jcfg(**kw):
    return JaxServeConfig(**{**SKW, **kw}, cache_dtype=jnp.float32)


def _draft_from(tm, layers=1):
    """An explicit draft model: the target's first ``layers`` blocks,
    copied into a model of their own."""
    draft = GPT2(GPT2Config(**{**CFG, "num_layers": layers}), device="cpu")
    sd = tm.state_dict()
    draft.load_state_dict({k: sd[k] for k in draft.state_dict()})
    return draft


# ------------------------------------------------ speculative decoding
@pytest.mark.parametrize("draft", ["self1", "identity", "explicit"])
def test_spec_greedy_matches_jax_sharded_and_single(pair, draft):
    """Speculative serving at M=2: JAX's sharded and single-device
    speculative engines and the port's agree token for token; the draft
    pool is head-sharded and mirrored; a self-draft shares the target's
    placed shards; ``memory_report`` counts the draft pool."""
    jm, jv, tm = pair
    layers = None if draft == "identity" else 1
    spec = SpeculativeConfig(draft_k=2, draft_layers=layers)
    kw = {}
    if draft == "explicit":
        kw = dict(draft_model=_draft_from(tm))
        spec = SpeculativeConfig(draft_k=2)
    eng = ShardedEngine(tm, _cfg(speculative=spec), mesh_devices=2, **kw)
    got = _greedy(eng, Request)
    jspec = JaxSpecConfig(draft_k=2, draft_layers=layers or 2)
    want = _greedy(JaxShardedEngine(jm, jv, _jcfg(speculative=jspec),
                                    mesh_devices=2), JaxRequest)
    assert got == want
    assert got == _greedy(JaxEngine(jm, jv, _jcfg(speculative=jspec)),
                          JaxRequest)
    assert eng.spec_verifies > 0 and eng.spec_accepted > 0
    assert isinstance(eng.draft_pool, ShardedPagedSlotPool)
    assert eng.pool.mirror is eng.draft_pool
    if draft != "explicit":
        assert eng.draft_model.shards is eng.model.shards
    rep = eng.memory_report()
    one = sum(t.numel() * t.element_size()
              for _, layer in eng.pool.layer_states() for t in layer.values())
    assert rep["kv_capacity_bytes"] > one
    eng.pool.leak_check()        # recurses into the draft pool


def test_int8_spec_matches_one_device(pair):
    """int8 pools under speculation: the mesh-2 engine's greedy tokens
    equal the port's one-device speculative and classic int8 engines'."""
    _, _, tm = pair
    spec = SpeculativeConfig(draft_k=3)
    cfg = _cfg(kv_dtype="int8", speculative=spec)
    got = _greedy(ShardedEngine(tm, cfg, mesh_devices=2), Request)
    assert got == _greedy(Engine(tm, cfg), Request)
    assert got == _greedy(Engine(tm, _cfg(kv_dtype="int8")), Request)


# ----------------------------------------------- impls and the kernels
@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_impls_and_forced_kernel_match_jax(pair, impl):
    """``decode_impl``/``prefill_impl`` "xla" (the composed attention on
    each shard) and "kernel" (JAX's forced nested kernels, interpret
    mode) give JAX's sharded engine's greedy tokens."""
    jm, jv, tm = pair
    prompts = PROMPTS[:2] if impl == "kernel" else PROMPTS
    kw = dict(decode_impl=impl, prefill_impl=impl)
    got = _greedy(ShardedEngine(tm, _cfg(**kw), mesh_devices=2), Request,
                  prompts, max_new=4)
    want = _greedy(JaxShardedEngine(jm, jv, _jcfg(**kw), mesh_devices=2),
                   JaxRequest, prompts, max_new=4)
    assert got == want


# --------------------------------------------------------- host tier
def _churn(sched, make_request, users, turns=3, new=3):
    prompts = [list(u) for u in users]
    out = []
    for turn in range(turns):
        rids = []
        for u, p in enumerate(prompts):
            rid = f"u{u}t{turn}"
            sched.submit(make_request(prompt=p, max_new_tokens=new,
                                      request_id=rid))
            rids.append(rid)
        sched.run_until_idle(max_iters=400)
        assert not sched.has_work()
        sched.engine.pool.leak_check()
        for u, rid in enumerate(rids):
            res = sched.results[rid]
            assert res.finish_reason == "length", res.error
            out.append(res.tokens)
            prompts[u] = users[u][:8] + res.tokens[:2] + [u + turn]
    return out


def test_host_tier_mesh2_matches_jax(pair, pallas_load):
    """The int8 host tier on a mesh-2 pool: the same churn as JAX's
    mesh-2 engine (its nested kernels, interpret mode, as the port runs
    its kernels' plain versions) gives the same tokens, demotions,
    promotions and host keys in LRU order; every entry holds every head,
    bitwise the shards' blocks at eviction gathered in shard order, and
    within two int8 steps of JAX's entry (C8); the one-device port serves
    the same tokens with the same ledgers."""
    jm, jv, tm = pair
    users = [[(13 * u + 3 * i + 5) % 64 for i in range(10)]
             for u in range(4)]
    cfg = ServeConfig(**HKW, cache_dtype=torch.float32)
    eng = ShardedEngine(tm, cfg, mesh_devices=2)
    pool = eng.pool
    seen = {}
    inner = pool._demote

    def demote(path, block):
        idx = torch.tensor([int(block)])
        seen[tuple(path)] = [
            {k: torch.cat([_gather_blocks_quantized(
                pool.shard_caches(r), idx)[li][k] for r in range(2)],
                dim=1).numpy() for k in ("k", "v", "k_scale", "v_scale")}
            for li in range(pool.num_layers)]
        inner(path, block)

    pool._demote = demote
    got = _churn(Scheduler(eng), Request, users)
    jeng = JaxShardedEngine(jm, jv, JaxServeConfig(
        **HKW, cache_dtype=jnp.float32, prefill_impl="kernel",
        decode_impl="kernel"), mesh_devices=2)
    assert got == _churn(JaxScheduler(jeng), JaxRequest, users)
    jpool = jeng.pool
    assert pool.demotions == jpool.demotions > 0
    assert pool.promotions == jpool.promotions > 0
    assert list(pool._host_tier) == list(jpool._host_tier)
    for key, entry in pool._host_tier.items():
        assert entry[0]["k"].shape == (1, CFG["num_heads"], 4, 8)
        for mine, at_evict, theirs in zip(entry, seen[key],
                                          jpool._host_tier[key]):
            for name in mine:
                np.testing.assert_array_equal(mine[name], at_evict[name])
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(mine[name], theirs[name],
                                           rtol=1e-5)
            for name in ("k", "v"):
                step = np.abs(mine[name].astype(np.int32)
                              - np.asarray(theirs[name]).astype(np.int32))
                assert step.max() <= 2, name
    one = Engine(tm, cfg)
    assert _churn(Scheduler(one), Request, users) == got
    assert (one.pool.demotions, one.pool.promotions) == (
        pool.demotions, pool.promotions)


# ------------------------------------------------------------- the wire
def _park(sched, prompt, rid="m", new=4):
    sched.submit((Request if isinstance(sched, Scheduler) else JaxRequest)(
        prompt=prompt, max_new_tokens=new, request_id=rid,
        prefill_only=True))
    sched.run_until_idle(max_iters=100)


def test_gather_on_export_bitwise_and_against_jax(pair):
    """A mesh-2 int8 source's export is its shards' head groups
    concatenated in shard order, bitwise, full heads on the wire; a f32
    source's against JAX's mesh-2 export within two int8 steps (scales
    within 1e-5); the same payload installed into a mesh-2 and a
    one-device pool (scatter-on-install) exports bitwise alike."""
    jm, jv, tm = pair
    prompt = PROMPTS[3]                  # 19 tokens: 4 blocks of 4
    src = Scheduler(ShardedEngine(tm, _cfg(kv_block_size=4,
                                           kv_dtype="int8"),
                                  mesh_devices=2))
    _park(src, prompt)
    tokens, layers, nbytes = migrate.decode_wire(src.export_parked("m"))
    pool = src.engine.pool
    blocks = pool.tables_host[src._parked["m"][0], :4]
    idx = torch.as_tensor(blocks.astype(np.int64))
    shards = [_gather_blocks_quantized(pool.shard_caches(r), idx)
              for r in range(2)]
    assert layers[0]["k"].shape == (4, CFG["num_heads"], 4, 8)
    for li, layer in enumerate(layers):
        for key, arr in layer.items():
            want = torch.cat([s[li][key] for s in shards], dim=1).numpy()
            np.testing.assert_array_equal(arr, want)
    # f32 sources, port against JAX, both at M=2.
    fsrc = Scheduler(ShardedEngine(tm, _cfg(kv_block_size=4),
                                   mesh_devices=2))
    jsrc = JaxScheduler(JaxShardedEngine(jm, jv, _jcfg(kv_block_size=4),
                                         mesh_devices=2))
    _park(fsrc, prompt)
    _park(jsrc, prompt)
    mine = migrate.decode_wire(fsrc.export_parked("m"))
    theirs = jax_migrate.decode_wire(jsrc.export_parked("m"))
    assert mine[0] == theirs[0] and mine[2] == theirs[2]
    for a, b in zip(mine[1], theirs[1]):
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(a[name], b[name], rtol=1e-5)
        for name in ("k", "v"):
            step = np.abs(a[name].astype(np.int32) - b[name].astype(np.int32))
            assert step.max() <= 2, name
    # Scatter-on-install, then gather-on-export, against one device.
    dsts = [Scheduler(ShardedEngine(tm, _cfg(kv_block_size=4,
                                             kv_dtype="int8"),
                                    mesh_devices=2)),
            Scheduler(Engine(tm, _cfg(kv_block_size=4, kv_dtype="int8")))]
    outs = []
    for dst in dsts:
        assert dst.install_migrated(tokens, layers, nbytes) == 4
        outs.append(dst.export_prefix(prompt))
    assert outs[0] == outs[1] == migrate.encode_wire(tokens, layers, 4)
    for s in [src, fsrc] + dsts:
        s.engine.pool.leak_check()


def test_install_into_mesh_from_jax_export(pair):
    """JAX's one-device export installs into a port mesh-2 pool; the
    migrated request prefix-hits and decodes the tokens JAX's own
    destination decodes from the same wire. ``/kv_export`` (both modes)
    and ``/kv_ack`` answer on the mesh."""
    jm, jv, tm = pair
    prompt = PROMPTS[3]
    jsrc = JaxScheduler(JaxEngine(jm, jv, _jcfg(kv_block_size=4)))
    _park(jsrc, prompt)
    wire = jsrc.export_parked("m")
    jdst = JaxScheduler(JaxEngine(jm, jv, _jcfg(kv_block_size=4)))
    jdst.install_migrated(*jax_migrate.decode_wire(wire))
    want = _greedy(jdst.engine, JaxRequest, [prompt])
    dst = Scheduler(ShardedEngine(tm, _cfg(kv_block_size=4),
                                  mesh_devices=2))
    assert dst.install_migrated(*migrate.decode_wire(wire)) == 4
    hits = dst.engine.pool.prefix_hits
    dst.submit(Request(prompt=prompt, max_new_tokens=6, request_id="r0"))
    dst.run_until_idle(max_iters=100)
    assert {"r0": dst.results["r0"].tokens} == want
    assert dst.engine.pool.prefix_hits == hits + 1
    _park(dst, prompt, rid="p")
    code, body = migrate.handle_kv_export(dst, {"request_id": "p"})
    assert code == 200 and body["nblocks"] == 4
    code, body = migrate.handle_kv_export(dst, {"tokens": prompt})
    assert code == 200 and body["nblocks"] == 4
    code, body = migrate.handle_kv_ack(dst, {"request_id": "p"})
    assert code == 200 and body["released"] is True
    dst.engine.pool.leak_check()


# ---------------------------------------------------------- chaos, CLI
def test_chaos_mesh2_spec_and_host_tier_zero_leaks(pair):
    """Seeded prefill errors, NaN bursts at the verify and KV bind
    failures against a mesh-2 engine with speculation and the host tier
    on: every request retires typed, every slot frees in both pools, and
    every shard's books balance."""
    _, _, tm = pair
    cfg = ServeConfig(**{**HKW, "queue_capacity": 16},
                      speculative=SpeculativeConfig(draft_k=2),
                      cache_dtype=torch.float32)
    eng = ShardedEngine(tm, cfg, mesh_devices=2)
    sched = Scheduler(eng)
    faults.install(faults.FaultPlan.parse(
        "serve.prefill:error@3;serve.spec.verify:nan@4;"
        "serve.kv.bind:error@9", seed=7))
    try:
        for i in range(10):
            sched.submit(Request(prompt=[(3 + 5 * i) % 64, 2, 9, 4, 1],
                                 max_new_tokens=4, request_id=f"c{i}",
                                 seed=i))
        sched.run_until_idle(max_iters=600)
    finally:
        faults.install(None)
    assert not sched.has_work() and len(sched.results) == 10
    reasons = {r.finish_reason for r in sched.results.values()}
    assert reasons <= {"length", "error", "eos"} and "error" in reasons
    assert eng.pool.num_free == eng.draft_pool.num_free == 2
    eng.pool.leak_check()


def test_cli_mesh_speculative_host_tier_and_impls():
    """``--mesh 2`` with ``--speculative``, ``--kv-host-blocks`` and the
    ``xla`` impls builds a sharded engine with a sharded draft pool and a
    host tier, and serves stdio lines with the one-device CLI's greedy
    tokens."""
    base = ["--random-init", "--model-preset", "tiny", "--device", "cpu",
            "--max-len", "64", "--max-prefill-len", "16", "--kv-block-size",
            "8", "--kv-dtype", "int8", "--speculative", "--draft-k", "2",
            "--draft-layers", "1", "--kv-host-blocks", "8",
            "--decode-impl", "xla", "--prefill-impl", "xla"]
    lines = [{"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 5},
             {"id": "b", "prompt_tokens": list(range(1, 30)),
              "max_new_tokens": 4}]
    outs = []
    for mesh in ("1", "2"):
        args = serve_cli.build_parser().parse_args(base + ["--mesh", mesh])
        sched = serve_cli.build_scheduler(args)
        out = io.StringIO()
        stdin = io.StringIO("".join(json.dumps(x) + "\n" for x in lines))
        assert serve_cli.run_stdio(sched, args, stdin=stdin,
                                   stdout=out) == 0
        outs.append({o["id"]: o["tokens"] for o in
                     map(json.loads, out.getvalue().splitlines())
                     if "id" in o})
        if mesh == "2":
            eng = sched.engine
            assert isinstance(eng, ShardedEngine)
            assert isinstance(eng.draft_pool, ShardedPagedSlotPool)
            assert eng.pool.host_blocks == 8
            assert eng.cfg.decode_impl == eng.cfg.prefill_impl == "xla"
    assert outs[0] == outs[1] and len(outs[0]) == 2
