"""int8 KV serving (``ServeConfig(kv_dtype="int8")``) in the port against
the JAX package, and the invariants the int8 pool adds:

- GPT-2's paged cache path over int8 pools against JAX ``GPT2.apply`` with
  the Pallas kernels (``prefill_impl``/``decode_impl="kernel"``, interpret
  mode) on the same weights: logits, the pools and their scales;
- the int8 Engine + Scheduler against the JAX int8 engine (greedy tokens
  identical) and against the port's own f32 engine (greedy and sampled);
- scales moving with blocks through copy-on-write, a donor's cache
  surviving a copy, poisoned stale blocks and scale rows never attended,
  horizon invariance, eviction freeing scales, ``leak_check``'s structure
  check, the pool's footprint, and ``--kv-dtype int8`` through the stdio
  server."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

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
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.models.gpt2 import GPT2Config as TorchGPT2Config
from nezha_tpu_torch.serve import (Engine, PagedSlotPool, Request,
                                   Scheduler, ServeConfig)

# test_kv_quant.py's model and QCFG shapes: blocks of 4 so that tiny
# prompts span real blocks (prefix hits, copy-on-write and per-block
# requantization all happen at test sizes).
CFG = dict(vocab_size=97, max_positions=64, num_layers=2, num_heads=4,
           hidden_size=64)
QKW = dict(max_batch_size=3, max_len=48, max_prefill_len=8,
           prefill_buckets=(4, 8), k_max=16, queue_capacity=8,
           kv_block_size=4, kv_dtype="int8")
QCFG = ServeConfig(**QKW, cache_dtype=torch.float32)
FCFG = dataclasses.replace(QCFG, kv_dtype="bf16")   # f32 blocks
REQS = [dict(prompt=[5, 17, 3, 42], max_new_tokens=10),
        dict(prompt=[7, 7], max_new_tokens=9, temperature=0.9, top_k=10,
             seed=7),
        dict(prompt=[(7 * i + 3) % 97 for i in range(20)], max_new_tokens=6)]


@pytest.fixture
def pallas_load(monkeypatch):
    # jax 0.9.0 dropped pl.load, which prefill_attention.py:212 calls in
    # the int8 kernel's write; a plain ref read does the same.
    monkeypatch.setattr(jax.experimental.pallas, "load",
                        lambda ref, idx: ref[idx], raising=False)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


def _pair(kw):
    jm = JaxGPT2(JaxGPT2Config(**kw, prefill_impl="kernel",
                               decode_impl="kernel"))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


@pytest.fixture(scope="module")
def models():
    return _pair(CFG)


def _serve(model, cfg, reqs=REQS):
    eng = Engine(model, cfg)
    sched = Scheduler(eng)
    rids = [sched.submit(Request(**kw)) for kw in reqs]
    sched.run_until_idle(max_iters=400)
    assert not sched.has_work()
    return eng, sched, [sched.results[r].tokens for r in rids]


# ----------------------------------------------------------------- model
def test_paged_int8_forward_matches_jax(pallas_load):
    """The tiny preset over int8 pools: a chunk at position 0 (pads past
    the prompt, as the engine's buckets have), a chunk at a mid-block
    offset, then four decode steps of two rows with row 1 inactive on one
    of them. Logits within 1e-4 of JAX's at every step (f32); every data
    block's scales within 1e-6 relative and its int8 values within one
    step (JAX's prefill kernel runs under jit, which turns amax / 127 into
    a multiply by 1/127: one ulp of scale, which can move a value by one
    step); each
    chunk's error sample within 4e-5 relative (one ulp of scale moves
    q * scale by up to 127 * 2^-23 * scale, 3e-5 of the half-step
    scale / 2 that the error sample is near)."""
    jm, jv, tm = _pair(TINY_GPT2_KW)
    cfg = JaxGPT2Config(**TINY_GPT2_KW)
    bs, m, n_blocks = 8, 6, 16
    d = cfg.hidden_size // cfg.num_heads
    rng = np.random.RandomState(1)
    tab = np.zeros((2, m), np.int32)
    tab[0] = rng.permutation(np.arange(1, n_blocks))[:m]
    tab[1, :2] = [b for b in range(1, n_blocks) if b not in tab[0]][:2]
    shape, sshape = (n_blocks, cfg.num_heads, bs, d), (n_blocks,
                                                       cfg.num_heads)
    jcache = [{"k": jnp.zeros(shape, jnp.int8), "v": jnp.zeros(shape,
                                                              jnp.int8),
               "k_scale": jnp.zeros(sshape), "v_scale": jnp.zeros(sshape)}
              for _ in range(cfg.num_layers)]
    tcache = [{k: torch.from_numpy(np.array(v)) for k, v in c.items()}
              for c in jcache]

    def run(tokens, row_tab, pos, active=None):
        nonlocal jcache
        jrows = [{**c, "tables": jnp.asarray(row_tab)} for c in jcache]
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
        want, states = jm.apply(
            jv, jnp.asarray(tokens), cache=jrows, pos=jpos,
            active=None if active is None else jnp.asarray(active))
        new = [states[f"h{i}"]["attn"]["cache"] for i in range(cfg.num_layers)]
        jcache = [{k: c[k] for k in ("k", "v", "k_scale", "v_scale")}
                  for c in new]
        trows = [{**c, "tables": torch.from_numpy(row_tab)} for c in tcache]
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        with torch.no_grad():
            got = tm(torch.from_numpy(tokens), cache=trows, pos=tpos,
                     active=None if active is None
                     else torch.from_numpy(active))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        for jc, tc in zip(new, trows):
            assert ("qerr" in jc) == ("qerr" in tc)
            if "qerr" in jc:
                assert tc["qerr"].item() == pytest.approx(
                    float(jc["qerr"]), rel=4e-5, abs=0.0)
        for jc, tc in zip(jcache, tcache):
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(tc[name][1:].numpy(),
                                           np.asarray(jc[name])[1:],
                                           rtol=1e-6, atol=0)
            for name in ("k", "v"):
                step = np.abs(tc[name][1:].numpy().astype(np.int32)
                              - np.asarray(jc[name])[1:].astype(np.int32))
                assert step.max() <= 1, name

    prompt = rng.randint(0, 512, 21)
    chunk = np.zeros((1, 16), np.int64)
    chunk[0, :13] = prompt[:13]
    run(chunk, tab[:1], 0)
    run(prompt[None, 13:21], tab[:1], 13)              # mid-block start
    run(prompt[None, :8], tab[1:], 0)
    pos = np.asarray([21, 8], np.int32)
    for step in range(4):
        active = np.asarray([True, step != 2])
        run(rng.randint(0, 512, (2, 1)), tab, pos, active)
        pos = pos + active.astype(np.int32)


# ---------------------------------------------------------------- engine
def test_greedy_tokens_identical_to_jax_int8_engine(models, pallas_load):
    """Greedy requests (one prefilled in three chunks) decode the same
    tokens on the port's int8 engine as on the JAX int8 engine with the
    Pallas kernels; a sampled request draws from torch.Generator on one
    side and jax.random on the other, so it is held to the port's own f32
    engine below instead."""
    jm, jv, tm = models
    greedy = [r for r in REQS if "temperature" not in r]
    jeng = JaxEngine(jm, jv, JaxServeConfig(
        **QKW, cache_dtype=jnp.float32, prefill_impl="kernel",
        decode_impl="kernel"))
    jsched = JaxScheduler(jeng)
    rids = [jsched.submit(JaxRequest(**kw)) for kw in greedy]
    jsched.run_until_idle(max_iters=400)
    want = [jsched.results[r].tokens for r in rids]
    eng, _, got = _serve(tm, QCFG, greedy)
    assert got == want
    eng.pool.leak_check()


def test_int8_engine_matches_f32_engine(models):
    """Greedy, sampled and chunked requests decode token-identically on
    the port's int8 and f32 engines (the tiny model's logit gaps exceed
    the bounded quantization error); one error sample per prefill chunk
    (1 + 1 + 3 chunks), each under the half-step bound of a block whose
    values are activations of this model (well below 1)."""
    _, _, tm = models
    _, _, out_f = _serve(tm, FCFG)
    eng, _, out_q = _serve(tm, QCFG)
    assert out_q == out_f
    assert len(eng.quant_errors) == 5
    assert all(0.0 < e < 0.05 for e in eng.quant_errors)
    assert eng.kernel_launches()["paged_quant_decode"] == 0   # CPU: plain


def test_horizon_bit_identity(models):
    """Horizon 1 and 8 decode the same tokens: each step's block requant
    depends only on the pool and the new row, the same sequence of writes
    whatever the horizon."""
    _, _, tm = models
    reqs = [dict(prompt=[5, 17, 3, 42], max_new_tokens=10),
            dict(prompt=[9, 1], max_new_tokens=12, temperature=0.8,
                 top_k=12, seed=3)]
    outs = [_serve(tm, dataclasses.replace(QCFG, decode_horizon=h),
                   reqs)[2] for h in (1, 8)]
    assert outs[0] == outs[1]


def test_cow_preserves_donor_cache(models):
    """A block-aligned full-prefix hit writes into its last shared block,
    which is copied first with its scale rows: the donor's block and
    scales stay intact, so two more identical requests re-hit and decode
    the donor's tokens."""
    _, _, tm = models
    prompt = [(5 * i + 11) % 97 for i in range(12)]    # exactly 3 blocks
    eng = Engine(tm, QCFG)
    sched = Scheduler(eng)
    a = sched.submit(Request(prompt=prompt, max_new_tokens=6))
    sched.run_until_idle(max_iters=400)
    b = sched.submit(Request(prompt=prompt, max_new_tokens=6))
    c = sched.submit(Request(prompt=prompt, max_new_tokens=6))
    sched.run_until_idle(max_iters=400)
    assert eng.pool.prefix_hits == 2 and eng.pool.cow_copies >= 2
    ref = sched.results[a].tokens
    assert sched.results[b].tokens == ref == sched.results[c].tokens
    assert ref == _serve(tm, FCFG, [dict(prompt=prompt,
                                         max_new_tokens=6)])[2][0]
    eng.pool.leak_check()


def test_scales_move_with_blocks():
    """A copy-on-write copies a block's scale rows with its data; the
    pools are int8 with zeroed [N, H] scales from the start."""
    cfg = TorchGPT2Config(**CFG)
    pool = PagedSlotPool(cfg, capacity=2, max_len=16, block_size=4,
                         quantized=True, device="cpu")
    for layer in pool.caches:
        assert layer["k"].dtype == torch.int8
        assert tuple(layer["k_scale"].shape) == (pool.num_blocks, 4)
        assert torch.all(layer["v_scale"] == 0)
    s = pool.alloc()
    pool.bind_for_prompt(s, [1, 2, 3, 4, 5])
    pool.prepare_write(s, 0, 8)
    b0 = int(pool.tables_host[s, 0])
    for layer in pool.caches:
        layer["k_scale"][b0] = 7.5
        layer["v"][b0] = 3
    pool._refs[b0] += 1                       # a second holder
    pool.prepare_write(s, 0, 4)               # -> copy-on-write of b0
    nb = int(pool.tables_host[s, 0])
    assert nb != b0 and pool.cow_copies == 1
    for layer in pool.caches:
        assert torch.all(layer["k_scale"][nb] == 7.5)
        assert torch.all(layer["v"][nb] == 3)
    pool._release(b0)
    pool.free(s)
    pool.leak_check()


def test_stale_blocks_and_scales_never_attended(models):
    """Retire a request, poison every free block's int8 with +-127 and its
    scale rows with 1e3, then serve a new request through the same
    storage: its tokens equal a clean engine's. This covers attending a
    stale position and folding stale content into a fresh block's
    absmax."""
    _, _, tm = models
    cfg = dataclasses.replace(QCFG, prefix_cache=False)
    eng = Engine(tm, cfg)
    sched = Scheduler(eng)
    sched.submit(Request(prompt=[(7 * i + 1) % 97 for i in range(20)],
                         max_new_tokens=8))
    sched.run_until_idle(max_iters=400)
    free = torch.as_tensor(sorted(eng.pool._free_blocks))
    for layer in eng.pool.caches:
        layer["k"][free], layer["v"][free] = 127, -127
        layer["k_scale"][free], layer["v_scale"][free] = 1e3, 1e3
    prompt = [9, 8, 7, 6, 5]
    r = sched.submit(Request(prompt=prompt, max_new_tokens=8))
    sched.run_until_idle(max_iters=400)
    assert sched.results[r].finish_reason == "length"
    clean = _serve(tm, cfg, [dict(prompt=prompt, max_new_tokens=8)])[2][0]
    assert sched.results[r].tokens == clean
    eng.pool.leak_check()


def test_eviction_frees_scales(models):
    """Eviction works on the int8 pool under pressure, and clearing the
    prefix cache leaves no block in use: a block's scale rows share its
    index, so freeing the block frees them."""
    _, _, tm = models
    cfg = dataclasses.replace(QCFG, max_batch_size=1, kv_num_blocks=8)
    eng = Engine(tm, cfg)
    sched = Scheduler(eng)
    sched.submit(Request(prompt=[(3 * i + 2) % 97 for i in range(12)],
                         max_new_tokens=4))
    sched.run_until_idle(max_iters=400)
    assert len(eng.pool.trie) == 3
    r = sched.submit(Request(prompt=[(5 * i + 1) % 97 for i in range(20)],
                             max_new_tokens=3))
    sched.run_until_idle(max_iters=400)
    assert sched.results[r].finish_reason == "length"
    assert len(eng.pool.trie) < 3 + 5           # eviction happened
    eng.pool.leak_check()
    eng.pool.clear_prefix_cache()
    eng.pool.leak_check()
    assert eng.pool.blocks_used == 0


@pytest.mark.parametrize("fault", ["missing_scale", "dtype_drift",
                                   "misshaped_scale"])
def test_leak_check_catches_broken_structure(fault):
    cfg = TorchGPT2Config(**CFG)
    pool = PagedSlotPool(cfg, capacity=1, max_len=16, block_size=4,
                         quantized=True, device="cpu")
    pool.leak_check()
    layer = pool.caches[1]
    if fault == "missing_scale":
        del layer["v_scale"]
        match = "v_scale"
    elif fault == "dtype_drift":
        layer["k"] = layer["k"].float()
        match = "int8"
    else:
        layer["k_scale"] = layer["k_scale"][:-1]
        match = "k_scale"
    with pytest.raises(AssertionError, match=match):
        pool.leak_check()


def test_bytes_per_block():
    """int8 + scales against f32 at the test shapes (under a third), and
    GPT-2 124M's blocks of 16: 589,824 bytes in bf16, 296,064 in int8."""
    small = TorchGPT2Config(**CFG)
    kw = dict(capacity=1, max_len=16, block_size=4, device="cpu")
    q = PagedSlotPool(small, dtype=torch.float32, quantized=True, **kw)
    f = PagedSlotPool(small, dtype=torch.float32, **kw)
    assert q.bytes_per_block < f.bytes_per_block / 3
    full = TorchGPT2Config()
    kw = dict(capacity=1, max_len=16, block_size=16, num_blocks=2,
              device="cpu")
    assert PagedSlotPool(full, **kw).bytes_per_block == 589_824
    assert PagedSlotPool(full, quantized=True, **kw).bytes_per_block \
        == 296_064


def test_stdio_server_int8():
    lines = [{"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 4},
             {"id": "b", "prompt_tokens": list(range(1, 30)),
              "max_new_tokens": 3, "temperature": 0.7, "seed": 1}]
    proc = subprocess.run(
        [sys.executable, "-m", "nezha_tpu_torch.cli.serve", "--random-init",
         "--model-preset", "tiny", "--device", "cpu", "--max-len", "64",
         "--max-prefill-len", "16", "--kv-block-size", "8",
         "--kv-dtype", "int8"],
        input="".join(json.dumps(x) + "\n" for x in lines),
        capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    out = {o["id"]: o for o in map(json.loads, proc.stdout.splitlines())}
    assert len(out["a"]["tokens"]) == 4 and len(out["b"]["tokens"]) == 3
    assert out["a"]["finish_reason"] == "length"
