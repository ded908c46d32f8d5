"""The fleet KV cache (``serve/fleetcache``, the pool's ``digest_entries``,
``Scheduler.fleet_digest``, the ``/healthz`` digest) against the JAX
package's, on the tiny preset with JAX's weights, f32 pools, the CPU:

- the same traffic on a JAX and a port scheduler gives byte-equal
  digests (device tier; the host tier through the pool's entries), at
  every truncation;
- coverage, scores and cold placement equal JAX's;
- each package's ``digest_entries_of`` reads the other's ``/healthz``
  (a port ``run_http`` server and a JAX one, in threads);
- a near-miss pick by the port's router carries the peer ``pull_from``
  hint naming the holder, and the pulled prefix installs on the chosen
  replica, whose greedy tokens equal the holder's."""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.cli import serve as jax_cli
from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.serve import Engine as JaxEngine
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu.serve import fleetcache as jfc
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.serve import (Engine, PagedSlotPool, Request,
                                   Scheduler, ServeConfig)
from nezha_tpu_torch.serve import fleetcache as fc
from nezha_tpu_torch.serve.router import Router
from nezha_tpu_torch.serve.supervisor import (RouterConfig, Supervisor,
                                              ThreadBackend)

SERVE_KW = dict(max_batch_size=2, max_len=64, max_prefill_len=16,
                kv_block_size=8, queue_capacity=8)
BASE = ["--random-init", "--model-preset", "tiny", "--device", "cpu",
        "--max-batch-size", "2", "--max-len", "64", "--max-prefill-len",
        "16", "--kv-block-size", "8", "--digest-interval", "0.05"]


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


def _prompt(n, salt=0):
    return [(7 * i + 3 + 11 * salt) % 512 for i in range(n)]


# Prompts sharing prefixes, some revisited: the trie's LRU order moves.
TRAFFIC = [_prompt(30), _prompt(30)[:16] + _prompt(9, 1), _prompt(21, 2),
           _prompt(30), _prompt(40, 3), _prompt(12, 4), _prompt(21, 2)]


def _serve_all(sched, request):
    for i, p in enumerate(TRAFFIC):
        sched.submit(request(prompt=p, max_new_tokens=3,
                             request_id=f"t{i}"))
        sched.run_until_idle()


@pytest.fixture(scope="module")
def served(models):
    jm, jv, tm = models
    js = JaxScheduler(JaxEngine(jm, jv, JaxServeConfig(
        **SERVE_KW, cache_dtype=jnp.float32)))
    ts = Scheduler(Engine(tm, ServeConfig(**SERVE_KW,
                                          cache_dtype=torch.float32)))
    _serve_all(js, JaxRequest)
    _serve_all(ts, Request)
    return js, ts


@pytest.mark.parametrize("max_entries", [1, 3, 5, 256])
def test_digest_byte_equal_to_jax(served, max_entries):
    js, ts = served
    mine = ts.fleet_digest(0.01, max_entries)
    theirs = js.fleet_digest(0.01, max_entries)
    assert json.dumps(mine["fleet_digest"]) == json.dumps(
        theirs["fleet_digest"])
    assert mine["digest_size"] == theirs["digest_size"] == min(
        max_entries, len(js.engine.pool.trie))
    assert list(ts.engine.pool.digest_entries()) == [
        (tuple(p), t) for p, t in js.engine.pool.digest_entries()]


def test_digest_host_tier_entries_and_dense_pool(models):
    jm, jv, tm = models
    pool = PagedSlotPool(tm.cfg, 2, 64, torch.float32, block_size=8,
                         device="cpu")
    # Host-tier keys as a demotion leaves them (the tier's own entry
    # type is irrelevant to the digest): newest first, device wins.
    for key in (tuple(_prompt(8)), tuple(_prompt(16)), tuple(_prompt(8, 5))):
        pool._host_tier[key] = []
    got = fc.build_digest(pool, 8)
    assert got == jfc.build_digest(pool, 8)
    assert list(got.values()) == ["host"] * 3
    assert list(got) == [fc.hash_prefix(k) for k in reversed(
        list(pool._host_tier))]
    dense = Scheduler(Engine(tm, ServeConfig(**SERVE_KW, kv_layout="dense",
                                             cache_dtype=torch.float32)))
    assert dense.fleet_digest() == {"digest_size": 0, "digest_age_s": 0.0}


@pytest.mark.parametrize("bs", [1, 8, 16])
def test_hashes_coverage_scores_and_cold_placement_equal_jax(bs):
    rng = np.random.RandomState(bs)
    toks = rng.randint(0, 50257, 70).tolist()
    assert fc.prefix_hashes(toks, bs) == jfc.prefix_hashes(toks, bs)
    assert fc.hash_prefix(toks) == jfc.hash_prefix(toks)
    hashes = fc.prefix_hashes(toks, bs)
    for cut in (0, 1, len(hashes) // 2, len(hashes)):
        entries = {h: ("device" if i % 2 else "host")
                   for i, h in enumerate(hashes[:cut])}
        entries["ffff"] = "device"
        assert fc.coverage(entries, hashes) == jfc.coverage(entries, hashes)
    for blocks, inflight, queued in ((0, 0, 0), (3, 0, 0), (3, 2, 5),
                                     (9, 1, 0)):
        assert fc.score(blocks, bs, inflight, queued) == jfc.score(
            blocks, bs, inflight, queued)
    for rids in ([], [0], [0, 1], [3, 1, 2]):
        assert fc.place_cold(toks, bs, rids) == jfc.place_cold(toks, bs,
                                                               rids)


def _get_healthz(port):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _post(port, obj):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/generate", body=json.dumps(obj).encode())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _start(run_http, sched, args, *extra):
    ready, drain, box = threading.Event(), threading.Event(), {}

    def cb(server):
        box["port"] = server.server_address[1]
        ready.set()

    th = threading.Thread(target=run_http, args=(sched, args) + extra,
                          kwargs=dict(ready_cb=cb, drain=drain), daemon=True)
    th.start()
    assert ready.wait(120)
    return box["port"], drain, th


def test_each_package_reads_the_others_healthz(served):
    js, ts = served
    targs = serve_cli.build_parser().parse_args(BASE)
    jargs = jax_cli.build_parser().parse_args(
        ["--random-init", "--model-preset", "tiny", "--max-len", "64",
         "--max-prefill-len", "16", "--kv-block-size", "8",
         "--digest-interval", "0.05", "--platform", "cpu"])
    tport, tdrain, tth = _start(serve_cli.run_http, ts, targs, 0)
    jport, jdrain, jth = _start(jax_cli.run_http, js, jargs, None, None, 0)
    try:
        th_, jh = _get_healthz(tport), _get_healthz(jport)
        mine_of_theirs = fc.digest_entries_of(jh)
        theirs_of_mine = jfc.digest_entries_of(th_)
        assert mine_of_theirs == jfc.digest_entries_of(jh)
        assert theirs_of_mine == fc.digest_entries_of(th_)
        assert mine_of_theirs == theirs_of_mine
        assert mine_of_theirs[0] == 8 and len(mine_of_theirs[1]) == len(
            ts.engine.pool.trie)
        assert set(th_) == set(jh)
    finally:
        for d in (tdrain, jdrain):
            d.set()
        tth.join(60)
        jth.join(60)


def test_near_miss_pick_carries_pull_hint_and_installs():
    wargs = serve_cli.build_parser().parse_args(BASE)
    cfg = RouterConfig(replicas=2, probe_interval_s=0.05,
                       restart_backoff_base_s=0.05, affinity_routing=True,
                       digest_interval_s=0.05, drain_timeout_s=5.0)
    sup = Supervisor(ThreadBackend(wargs, drain_timeout_s=5.0), cfg)
    router = Router(sup, cfg)
    sup.start()
    try:
        assert router.wait_live(2, timeout_s=60)
        holder, other = sorted(sup.live_replicas(), key=lambda r: r.rid)
        prompt = _prompt(37, 6)
        code, first = _post(holder.port, {"id": "h", "prompt_tokens": prompt,
                                          "max_new_tokens": 4})
        assert code == 200
        time.sleep(0.1)               # past one digest interval
        router.probe_all()
        holder, other = sorted(sup.live_replicas(), key=lambda r: r.rid)
        # The holder is out of the usable set (say, full): the pick is
        # the other replica, with the holder named as its pull source.
        pick, pull = router._pick([other], [holder, other], prompt)
        assert pick.rid == other.rid
        assert pull == {"host": "127.0.0.1", "port": holder.port,
                        "tokens": prompt[:32], "blocks": 4,
                        "src_rid": holder.rid}
        outcome, got = router._forward_pull(
            other, {"id": "o", "prompt_tokens": prompt,
                    "max_new_tokens": 4}, pull)
        assert outcome == "ok", got
        meta = got["fleet_pull"]
        assert meta["blocks"] == 4 and meta["installed"] == 4
        assert got["tokens"] == first["tokens"]
        assert router.kv_pulls == 1 and router.kv_pull_bytes == meta["bytes"]
        sched = other.handle.worker._sched
        assert sched.engine.pool.fleet_hits["peer"] == 1
        with sched._lock:
            sched.engine.pool.leak_check()
    finally:
        router.stop()
        sup.shutdown()
