"""The port's KV block wire (``serve/migrate.py``, the pool's export and
install, the scheduler's park) against the JAX package's, after
``tests/test_migration.py``, on the tiny preset with JAX's weights
(``params_from_jax``), f32 models and f32 pools, greedy:

- the wire codec's round trip and validation, and ``encode_wire`` of the
  same arrays equal to JAX's object key for key (both ways decodable);
- the pool's export of the same blocks against JAX's: int8 bitwise; a
  float pool's quantized export within one ulp of scale and one int8 step
  of JAX's, whose quantizer runs under jit (ROADMAP C8);
- park, export, install and ACK on float and int8 pools (int8 blocks
  arrive bitwise, greedy tokens equal a local decode), resume, the TTL,
  ``cancel_remaining`` over every kind of request, a typed install
  exhaustion, an empty install that counts nothing;
- across packages: JAX's ``export_parked`` installed by the port decodes
  the port's greedy tokens equal to JAX's, and the reverse;
- the peer pull: ``export_prefix_payload`` extended through the host tier,
  ``origin="peer"`` and the ``fleet_hits`` ledger, against JAX's;
- the dense engine's and the sharded engine's typed refusals, and the
  speculative engine's park (target pool only, the draft freed by the
  mirror)."""

import time

import jax
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
from nezha_tpu.serve import migrate as jax_migrate
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.serve import (Engine, FinishReason, KVBlocksExhausted,
                                   PagedSlotPool, Request, Scheduler,
                                   ServeConfig, ShardedEngine,
                                   SpeculativeConfig, migrate)
from nezha_tpu_torch.serve.migrate import MigrationError

SERVE_KW = dict(max_batch_size=2, max_len=64, max_prefill_len=16,
                kv_block_size=8, queue_capacity=8)


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


def _sched(tm, **kw):
    return Scheduler(Engine(tm, ServeConfig(**{**SERVE_KW, **kw},
                                            cache_dtype=torch.float32)))


def _jax_sched(jm, jv, **kw):
    return JaxScheduler(JaxEngine(jm, jv, JaxServeConfig(
        **{**SERVE_KW, **kw}, cache_dtype=jnp.float32)))


def _prompt(n, vocab=512, salt=0):
    return [(7 * i + 3 + 11 * salt) % vocab for i in range(n)]


def _park(sched, prompt, rid, new=6, request=Request):
    sched.submit(request(prompt=prompt, max_new_tokens=new, request_id=rid,
                         prefill_only=True))
    sched.run_until_idle()
    assert sched.results[rid].finish_reason == FinishReason.PREFILLED


def _serve(sched, prompt, rid, new=6, request=Request):
    sched.submit(request(prompt=prompt, max_new_tokens=new, request_id=rid))
    sched.run_until_idle()
    assert not sched.has_work()
    return sched.results[rid]


def _random_layers(n, heads=4, bs=8, d=16, layers=2, seed=0):
    rng = np.random.RandomState(seed)
    return [{"k": rng.randint(-127, 128, (n, heads, bs, d)).astype(np.int8),
             "v": rng.randint(-127, 128, (n, heads, bs, d)).astype(np.int8),
             "k_scale": rng.rand(n, heads).astype(np.float32),
             "v_scale": rng.rand(n, heads).astype(np.float32)}
            for _ in range(layers)]


# ----------------------------------------------------------- wire codec
def test_wire_codec_roundtrip_and_validation(models):
    _, _, tm = models
    sched = _sched(tm)
    prompt = _prompt(21)
    _park(sched, prompt, "w", new=4)
    wire = sched.export_parked("w")
    assert wire["nblocks"] == 2 and wire["block_size"] == 8
    tokens, layers, nbytes = migrate.decode_wire(wire)
    assert tokens == prompt[:16]
    assert nbytes == wire["nbytes"] > 0
    assert layers[0]["k"].dtype == np.int8
    assert layers[0]["k_scale"].dtype == np.float32
    with pytest.raises(MigrationError):
        migrate.decode_wire(dict(wire, nblocks=3))
    with pytest.raises(MigrationError):
        migrate.decode_wire({"v": 99})
    with pytest.raises(MigrationError):
        migrate.decode_wire(dict(wire, num_layers=7))
    assert sched.ack_parked("w")
    sched.engine.pool.leak_check()


def test_encode_wire_equals_jax_object_key_for_key():
    """The wire is byte-compatible both ways: the same arrays encode to
    the same object, and each side decodes the other's bytes."""
    assert migrate.WIRE_VERSION == jax_migrate.WIRE_VERSION
    layers = _random_layers(3)
    toks = _prompt(24)
    mine = migrate.encode_wire(toks, layers, 8)
    theirs = jax_migrate.encode_wire(toks, layers, 8)
    assert list(mine) == list(theirs)
    for key in theirs:
        assert mine[key] == theirs[key], key
    for decode, wire in ((migrate.decode_wire, theirs),
                         (jax_migrate.decode_wire, mine)):
        t, got, nbytes = decode(wire)
        assert t == toks and nbytes == wire["nbytes"]
        for a, b in zip(got, layers):
            for key in b:
                np.testing.assert_array_equal(a[key], b[key])
    assert migrate.encode_wire([], [], 8) == jax_migrate.encode_wire(
        [], [], 8)


def _fill_pools(jpool, tpool, rng, quantized):
    """The same random content in both packages' pools."""
    new = []
    for layer in tpool.caches:
        host = {}
        for key, t in layer.items():
            if t.dtype == torch.int8:
                arr = rng.randint(-127, 128, tuple(t.shape)).astype(np.int8)
            else:
                arr = (rng.randn(*t.shape) * (0.05 if quantized else 1)
                       ).astype(np.float32)
                if quantized:
                    arr = np.abs(arr)
            t.copy_(torch.from_numpy(arr))
            host[key] = jnp.asarray(arr)
        new.append(host)
    jpool.caches = new


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "f32"])
def test_export_block_payload_against_jax(models, quantized):
    """The same blocks exported by both packages: an int8 pool ships
    them verbatim (bitwise); a float pool quantizes on export, where
    JAX's jitted quantizer may round a scale one ulp the other way
    (ROADMAP C8): scales within 2^-23 relative and values within one
    int8 step."""
    jm, _, tm = models
    kw = dict(block_size=8, num_blocks=12, quantized=quantized)
    tpool = PagedSlotPool(tm.cfg, 2, 64, torch.float32, device="cpu", **kw)
    jpool = JaxPagedSlotPool(jm, 2, 64, jnp.float32, **kw)
    _fill_pools(jpool, tpool, np.random.RandomState(3), quantized)
    prompt = _prompt(30)
    for pool in (tpool, jpool):
        slot = pool.alloc()
        pool.bind_for_prompt(slot, prompt)
        pool.prepare_write(slot, 0, 30)
    got, nbytes = tpool.export_block_payload(0 if tpool._bound[0] else 1, 3)
    want, jbytes = jpool.export_block_payload(
        0 if jpool._bound[0] else 1, 3)
    assert nbytes == jbytes
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            assert g[key].shape == w[key].shape
            if quantized:
                np.testing.assert_array_equal(g[key], w[key])
            elif key.endswith("_scale"):
                np.testing.assert_allclose(g[key], w[key], rtol=2 ** -23,
                                           atol=0)
            else:
                step = np.abs(g[key].astype(np.int32)
                              - w[key].astype(np.int32))
                assert step.max() <= 1, key
    with pytest.raises(ValueError, match="cannot export"):
        tpool.export_block_payload(0 if tpool._bound[0] else 1, 9)


# ------------------------------------------------- scheduler lifecycle
def test_park_export_install_ack_float(models):
    """The two-phase handoff: park on A, install into B's prefix cache,
    the ACK releases A (once); B's admission is a prefix hit; both books
    balance."""
    _, _, tm = models
    sa, sb = _sched(tm), _sched(tm)
    prompt = _prompt(21)
    _park(sa, prompt, "m")
    assert sa.parked_count == 1
    tokens, layers, nbytes = migrate.decode_wire(sa.export_parked("m"))
    assert sb.install_migrated(tokens, layers, nbytes) == 2
    assert (sb.migrations, sb.migration_bytes) == (1, nbytes)
    assert sa.ack_parked("m") is True
    assert sa.ack_parked("m") is False
    assert sa.parked_count == 0
    sa.engine.pool.leak_check()
    res = _serve(sb, prompt, "m")
    assert res.finish_reason == "length" and len(res.tokens) == 6
    assert sb.engine.pool.prefix_hits == 1
    sb.engine.pool.leak_check()


def test_int8_migration_is_bit_identical(models):
    """int8 pools ship their blocks verbatim: the destination holds the
    source's bytes, and the migrated request decodes what a local int8
    decode does."""
    _, _, tm = models
    src, dst, ref = (_sched(tm, kv_dtype="int8") for _ in range(3))
    prompt = _prompt(29)
    want = _serve(ref, prompt, "r", new=8).tokens
    _park(src, prompt, "p", new=8)
    slot = src._parked["p"][0]
    sent, _ = src.engine.pool.export_block_payload(slot, 3)
    tokens, layers, nbytes = migrate.decode_wire(src.export_parked("p"))
    assert dst.install_migrated(tokens, layers, nbytes) == 3
    arrived = dst.engine.pool._gather_wire(dst.engine.pool.trie.match(prompt))
    for a, b in zip(sent, arrived):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert src.ack_parked("p")
    assert _serve(dst, prompt, "p", new=8).tokens == want
    src.engine.pool.leak_check()
    dst.engine.pool.leak_check()


def test_resume_parked_local_decode(models):
    _, _, tm = models
    sched, ref = _sched(tm), _sched(tm)
    prompt = _prompt(21)
    _park(sched, prompt, "loc")
    assert sched.resume_parked("loc") is True
    assert sched.resume_parked("loc") is False
    sched.run_until_idle()
    res = sched.results["loc"]
    assert res.finish_reason == "length" and len(res.tokens) == 6
    assert res.tokens == _serve(ref, prompt, "x").tokens
    assert sched.parked_count == 0
    sched.engine.pool.leak_check()


def test_parked_ttl_expiry_frees_blocks(models):
    _, _, tm = models
    sched = _sched(tm)
    sched.parked_ttl_s = 0.02
    _park(sched, _prompt(21), "exp", new=4)
    assert sched.parked_count == 1
    time.sleep(0.05)
    sched.step()
    assert sched.parked_count == 0
    with pytest.raises(KeyError):
        sched.export_parked("exp")
    pool = sched.engine.pool
    pool.leak_check()
    # What remains is the prompt's full blocks, held by the cache alone.
    assert pool.blocks_used == pool.trie_only_blocks


def test_cancel_remaining_sweeps_every_kind(models):
    """The drain's cutoff: queued, live and preempted requests retire
    with the reason and are counted; parks are released uncounted (their
    answer, "prefilled", was given)."""
    _, _, tm = models
    sched = _sched(tm, max_batch_size=1)
    _park(sched, _prompt(21), "d", new=4)
    assert sched.resume_parked("d")       # live in the one slot
    sched.step()
    sched.submit(Request(prompt=_prompt(9, salt=1), max_new_tokens=4,
                         request_id="q"))
    assert sched.queue_depth == 1
    assert sched.cancel_remaining(FinishReason.DEADLINE) == 2
    assert {sched.results[r].finish_reason for r in ("d", "q")} == {
        "deadline"}

    other = _sched(tm, preemption=True)
    _park(other, _prompt(17, salt=4), "pk", new=2)     # holds one slot
    other.submit(Request(prompt=_prompt(12, salt=2), max_new_tokens=20,
                         request_id="bg", priority="background"))
    other.step()
    other.submit(Request(prompt=_prompt(10, salt=3), max_new_tokens=4,
                         request_id="hi"))
    other.step()
    assert (other.preempted_count, other.parked_count) == (1, 1)
    assert other.cancel_remaining(FinishReason.ERROR, error="stop") == 2
    assert other.preempted_count == other.parked_count == 0
    assert other.results["bg"].finish_reason == "error"
    assert other.results["hi"].error == "stop"
    for s in (sched, other):
        assert not s.has_work()
        s.engine.pool.leak_check()
        assert s.engine.pool.num_free == s.engine.cfg.max_batch_size


def test_install_exhaustion_is_typed_and_leak_free(models):
    _, _, tm = models
    src = _sched(tm)
    dst = _sched(tm, kv_num_blocks=3)          # scratch + 2 usable
    _park(src, _prompt(33), "x", new=4)        # 4 full blocks of 8
    tokens, layers, nbytes = migrate.decode_wire(src.export_parked("x"))
    with pytest.raises(KVBlocksExhausted):
        dst.install_migrated(tokens, layers, nbytes)
    dst.engine.pool.leak_check()
    assert dst.engine.pool.blocks_used == 0
    assert dst.migrations == 0
    with pytest.raises(ValueError, match="geometry"):
        _sched(tm).install_migrated(tokens, layers[:2], nbytes)
    with pytest.raises(ValueError, match="key them"):
        _sched(tm).install_migrated(tokens[:10], layers, nbytes)
    src.ack_parked("x")
    src.engine.pool.leak_check()


def test_empty_install_does_not_count_a_migration(models):
    _, _, tm = models
    sched, dst = _sched(tm), _sched(tm)
    _park(sched, _prompt(5), "tiny", new=2)    # under one block
    wire = sched.export_parked("tiny")
    assert wire["nblocks"] == 0
    assert dst.install_migrated(*migrate.decode_wire(wire)) == 0
    assert (dst.migrations, dst.migration_bytes) == (0, 0)
    sched.ack_parked("tiny")
    _park(sched, _prompt(21), "full", new=2)
    decoded = migrate.decode_wire(sched.export_parked("full"))
    assert dst.install_migrated(*decoded) == 2
    assert dst.install_migrated(*decoded) == 0     # already cached
    assert (dst.migrations, dst.migration_bytes) == (1, decoded[2])
    sched.ack_parked("full")
    for s in (sched, dst):
        s.engine.pool.leak_check()


def test_duplicate_park_id_is_an_error(models):
    _, _, tm = models
    sched = _sched(tm)
    _park(sched, _prompt(21), "dup", new=2)
    sched.submit(Request(prompt=_prompt(21), max_new_tokens=2,
                         request_id="dup", prefill_only=True))
    sched.run_until_idle()
    res = sched.results["dup"]
    assert res.finish_reason == "error" and "already parked" in res.error
    assert sched.parked_count == 1
    sched.ack_parked("dup")
    sched.engine.pool.leak_check()


# ------------------------------------------------------ across packages
@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_migration_across_packages(models, direction, kv_dtype):
    """One package's park exported, installed by the other: the
    destination's greedy tokens equal the source package's local decode
    (int8: the blocks arrive verbatim; bf16 here means the f32 pool, whose
    export is quantized, so the source package's own migrated decode is
    the reference)."""
    jm, jv, tm = models
    prompt = _prompt(29, salt=5)
    js = lambda: _jax_sched(jm, jv, kv_dtype=kv_dtype)   # noqa: E731
    ts = lambda: _sched(tm, kv_dtype=kv_dtype)            # noqa: E731
    if direction == "jax_to_port":
        src, dst, mk_src, mk_dst = js(), ts(), JaxRequest, Request
        ref_src, ref_dst, decode = js(), js(), jax_migrate.decode_wire
    else:
        src, dst, mk_src, mk_dst = ts(), js(), Request, JaxRequest
        ref_src, ref_dst, decode = ts(), ts(), migrate.decode_wire
    _park(src, prompt, "p", new=8, request=mk_src)
    wire = src.export_parked("p")
    assert dst.install_migrated(*decode(wire)) == 3
    got = _serve(dst, prompt, "p", new=8, request=mk_dst).tokens
    if kv_dtype == "int8":
        _park(ref_src, prompt, "r", new=8, request=mk_src)
        assert ref_src.resume_parked("r")
        ref_src.run_until_idle()
        want = ref_src.results["r"].tokens
    else:
        _park(ref_src, prompt, "r", new=8, request=mk_src)
        ref_dst.install_migrated(*decode(ref_src.export_parked("r")))
        want = _serve(ref_dst, prompt, "r", new=8, request=mk_src).tokens
    assert got == want
    assert len(set(got)) > 1 or len(got) == 8
    src.ack_parked("p")
    src.engine.pool.leak_check()
    dst.engine.pool.leak_check()


# ------------------------------------------------------------ peer pull
def _tier_sched(tm_or_jm, jv=None):
    kw = dict(max_batch_size=2, max_len=32, max_prefill_len=8,
              prefill_buckets=(4, 8), kv_block_size=4, kv_num_blocks=9,
              kv_dtype="int8", kv_host_blocks=16, queue_capacity=8)
    if jv is None:
        return Scheduler(Engine(tm_or_jm, ServeConfig(
            **kw, cache_dtype=torch.float32)))
    return JaxScheduler(JaxEngine(tm_or_jm, jv, JaxServeConfig(
        **kw, cache_dtype=jnp.float32)))


def test_peer_pull_through_host_tier_and_fleet_hits(models):
    """``export_prefix_payload`` covers the device trie match and the
    host-tier blocks after it, read-only; the destination installs it
    tagged ``origin="peer"``, so its first reuse counts a peer hit (then
    the blocks are plain device cache). Coverage, tokens, counters and
    ledgers as JAX's on the same traffic; the host-tier part of the
    payload is the demoted entries' bytes."""
    jm, jv, tm = models
    prompt = [(3 * i + 5) % 97 for i in range(10)]
    wide = [(7 * i + 1) % 97 for i in range(30)]
    out = {}
    for name, (sched, request) in {
            "port": (_tier_sched(tm), Request),
            "jax": (_tier_sched(jm, jv), JaxRequest)}.items():
        _serve(sched, prompt, "a", new=2, request=request)
        _serve(sched, wide, "b", new=2, request=request)  # demotes a's
        pool = sched.engine.pool
        assert pool.trie.match(prompt) == []
        assert pool.host_blocks_used >= 2
        before = (pool.host_blocks_used, len(pool.trie),
                  pool._refs.copy())
        covered, layers, nbytes = pool.export_prefix_payload(prompt + [1])
        assert before[:2] == (pool.host_blocks_used, len(pool.trie))
        np.testing.assert_array_equal(before[2], pool._refs)
        assert pool.export_prefix_payload([0, 0]) == ([], [], 0)
        out[name] = (sched, covered, layers, nbytes)
    tsched, covered, layers, nbytes = out["port"]
    _, jcovered, jlayers, jbytes = out["jax"]
    assert covered == jcovered == prompt[:8] and nbytes == jbytes
    tpool = tsched.engine.pool
    entries = [tpool._host_tier[tuple(prompt[:4])],
               tpool._host_tier[tuple(prompt[:8])]]
    for li, layer in enumerate(layers):
        for key in layer:
            np.testing.assert_array_equal(
                layer[key], np.concatenate([e[li][key] for e in entries]))
    wire = tsched.export_prefix(prompt + [1])
    assert wire["tokens"] == prompt[:8] and wire["nblocks"] == 2

    ledgers = {}
    for name, (mk, request, decode) in {
            "port": (lambda: _tier_sched(tm), Request,
                     migrate.decode_wire),
            "jax": (lambda: _tier_sched(jm, jv), JaxRequest,
                    jax_migrate.decode_wire)}.items():
        dst = mk()
        t, lay, nb = decode(wire)
        assert dst.install_pulled(t, lay, nb) == 2
        _serve(dst, prompt, "c", new=2, request=request)
        _serve(dst, prompt[:8] + [9, 9], "d", new=2, request=request)
        pool = dst.engine.pool
        ledgers[name] = (dict(pool.fleet_hits), pool.prefix_hits)
        pool.leak_check()
        if name == "port":
            assert dst.pull_bytes == nb and dst.migrations == 0
            assert not pool._peer_blocks
    assert ledgers["port"] == ledgers["jax"]
    assert ledgers["port"][0]["peer"] == 1
    assert ledgers["port"][0]["device"] == 1


# ------------------------------------------------------------- refusals
def test_dense_engine_refuses_the_wire_typed(models):
    _, _, tm = models
    sched = _sched(tm, kv_layout="dense")
    _park(sched, _prompt(21), "d", new=2)
    with pytest.raises(MigrationError, match="dense") as info:
        sched.export_parked("d")
    assert info.value.kind == "migration_failed"
    with pytest.raises(MigrationError) as info:
        sched.export_prefix(_prompt(21))
    assert info.value.kind == "kv_pull_failed"
    with pytest.raises(MigrationError):
        sched.install_migrated([], [], 0)
    assert sched.ack_parked("d")
    sched.engine.pool.leak_check()


def test_sharded_engine_refuses_tier_and_wire_typed(models):
    """Under a mesh the host tier and the wire are served (gather-on-
    export, scatter-on-install); what stays refused is refused as on one
    device and in JAX: a host tier over a bf16 pool (ValueError naming
    int8, never NotPortedError) and a dense layout, which has no blocks.
    ``/kv_export`` of a mesh-2 park answers 200 with the one-device
    wire."""
    _, _, tm = models
    with pytest.raises(ValueError, match="int8") as info:
        ShardedEngine(tm, ServeConfig(**SERVE_KW, kv_host_blocks=8,
                                      cache_dtype=torch.float32),
                      mesh_devices=2)
    assert not isinstance(info.value, NotPortedError)
    with pytest.raises(ValueError, match="paged"):
        ShardedEngine(tm, ServeConfig(**SERVE_KW, kv_layout="dense"),
                      mesh_devices=2)
    sched = Scheduler(ShardedEngine(tm, ServeConfig(
        **SERVE_KW, cache_dtype=torch.float32), mesh_devices=2))
    one = _sched(tm)
    prompt = _prompt(21)
    _park(sched, prompt, "s", new=2)
    _park(one, prompt, "s", new=2)
    code, body = migrate.handle_kv_export(sched, {"request_id": "s"})
    want = one.export_parked("s")
    assert code == 200
    assert {k: v for k, v in body.items() if k != "layers"} == \
        {k: v for k, v in want.items() if k != "layers"}
    got_layers = migrate.decode_wire(body)[1]
    for a, b in zip(got_layers, migrate.decode_wire(want)[1]):
        assert {k: (v.shape, v.dtype) for k, v in a.items()} == \
            {k: (v.shape, v.dtype) for k, v in b.items()}
    code, body = migrate.handle_kv_export(sched, {"tokens": prompt})
    assert code == 200 and body["nblocks"] == 2
    assert sched.install_migrated(*migrate.decode_wire(migrate.encode_wire(
        _prompt(8, salt=3), _random_layers(1, layers=4), 8))) == 1
    for s_ in (sched, one):
        assert s_.ack_parked("s")
        s_.engine.pool.leak_check()


def test_speculative_park_ships_target_pool_and_frees_draft(models):
    """A speculative engine parks like any other; export ships the
    target pool's blocks only (the destination prefills its own draft),
    and the ACK frees the draft pool's slot through the mirror."""
    _, _, tm = models
    spec = SpeculativeConfig(draft_k=2, draft_layers=1)
    src = _sched(tm, speculative=spec)
    dst, ref = _sched(tm, speculative=spec), _sched(tm)
    prompt = _prompt(21)
    _park(src, prompt, "p")
    assert src.engine.draft_pool.num_free == SERVE_KW["max_batch_size"] - 1
    wire = src.export_parked("p")
    assert wire["num_layers"] == tm.cfg.num_layers
    assert dst.install_migrated(*migrate.decode_wire(wire)) == 2
    assert src.ack_parked("p")
    assert src.engine.draft_pool.num_free == SERVE_KW["max_batch_size"]
    assert _serve(dst, prompt, "p").tokens == _serve(ref, prompt, "r").tokens
    for s in (src, dst):
        s.engine.pool.leak_check()
