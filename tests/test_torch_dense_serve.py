"""The dense KV layout (``ServeConfig(kv_layout="dense")``) in the port
against the JAX package (tiny preset, f32 model and pools, weights
carried by ``params_from_jax``): ``SlotPool``'s books and
``read_slot``/``write_slot`` against JAX's; the dense engine's greedy
tokens against JAX's dense engine and the port's paged one, at horizons
1 and 2, chunked prompts included; its pool's contents after a prefill
and a decode block against JAX's; the ``decode_impl`` override; and the
serve CLI's layout, speculative and bucket flags over stdin, with their
refusals."""

import dataclasses
import io
import json

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
from nezha_tpu.serve.slots import SlotPool as JaxSlotPool
from nezha_tpu.serve.slots import read_slot as jax_read_slot
from nezha_tpu.serve.slots import write_slot as jax_write_slot
from nezha_tpu_torch.cli import serve as cli_serve
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.models.convert import train_state_to_jax
from nezha_tpu_torch.serve import Engine, Request, Scheduler, ServeConfig
from nezha_tpu_torch.serve.slots import SlotPool, read_slot, write_slot

DKW = dict(max_batch_size=3, max_len=48, max_prefill_len=8,
           prefill_buckets=(4, 8), k_max=16, queue_capacity=16,
           kv_layout="dense")
DCFG = ServeConfig(**DKW, cache_dtype=torch.float32)
REQS = [dict(prompt=[5, 17, 3, 42], max_new_tokens=8, request_id="a"),
        dict(prompt=[(3 * i + 2) % 512 for i in range(21)],
             max_new_tokens=6, request_id="b"),
        dict(prompt=[11, 4, 9, 2, 8, 1], max_new_tokens=9, request_id="c"),
        dict(prompt=[7, 7], max_new_tokens=7, request_id="d")]


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _lively(tree, rng):
    """Scaled-up weights: the small init repeats one token."""
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


def _serve(sched, make, reqs=REQS):
    for r in reqs:
        sched.submit(make(**r))
    sched.run_until_idle(max_iters=400)
    assert not sched.has_work(), "scheduler did not drain"
    return {k: (v.tokens, v.finish_reason) for k, v in sched.results.items()}


# ----------------------------------------------------------- the pool
def test_slot_pool_books_match_jax(models):
    jm, _, tm = models
    jpool = JaxSlotPool(jm, 3, 48, jnp.float32)
    pool = SlotPool(tm.cfg, 3, 48, torch.float32, device="cpu")
    assert [tuple(c["k"].shape) for c in pool.caches] == [
        tuple(c["k"].shape) for c in jpool.caches]
    got, want = [], []
    for op in ("alloc", "alloc", "free0", "alloc", "alloc", "alloc",
               "free1", "free2"):
        for p, log in ((pool, got), (jpool, want)):
            if op == "alloc":
                log.append(p.alloc())
            else:
                p.free(int(op[-1]))
            log.append((p.num_free, p.num_active, p.occupancy,
                        p.blocks_used, p.bytes_resident))
    assert got == want
    with pytest.raises(ValueError, match="double free"):
        pool.free(1)
    with pytest.raises(ValueError, match="out of range"):
        pool.free(3)
    pool.leak_check()


def test_read_and_write_slot_match_jax():
    rng = np.random.RandomState(0)
    leaf = rng.randn(3, 2, 10, 4).astype(np.float32)
    chunk = rng.randn(1, 2, 6, 4).astype(np.float32)
    want_r = np.asarray(jax_read_slot(jnp.asarray(leaf), 1))
    want_w = np.asarray(jax_write_slot(jnp.asarray(leaf), jnp.asarray(chunk),
                                       2))
    t = torch.from_numpy(leaf.copy())
    view = read_slot(t, 1)
    np.testing.assert_array_equal(view.numpy(), want_r)
    assert view.data_ptr() == t[1].data_ptr()        # a view: writes land
    np.testing.assert_array_equal(
        write_slot(t, torch.from_numpy(chunk), 2).numpy(), want_w)


# ---------------------------------------------------------- the engine
@pytest.mark.parametrize("horizon", [1, 2])
def test_greedy_tokens_equal_jax_dense_engine(models, horizon):
    """Greedy tokens (and finish reasons) of the dense engine equal JAX's
    dense engine's and the port's paged engine's; a 21-token prompt
    prefills in chunks."""
    jm, jv, tm = models
    cfg = dataclasses.replace(DCFG, decode_horizon=horizon)
    want = _serve(JaxScheduler(JaxEngine(jm, jv, JaxServeConfig(
        **DKW, cache_dtype=jnp.float32, decode_horizon=horizon))),
        JaxRequest)
    eng = Engine(tm, cfg)
    got = _serve(Scheduler(eng), Request)
    assert got == want
    assert len({t for toks, _ in got.values() for t in toks}) > 8
    paged = _serve(Scheduler(Engine(tm, dataclasses.replace(
        cfg, kv_layout="paged", kv_block_size=4))), Request)
    assert got == paged
    assert eng.pool.num_free == cfg.max_batch_size
    eng.pool.leak_check()
    assert not eng.paged and not hasattr(eng.pool, "tables_host")


def test_dense_pool_contents_match_jax(models):
    """After a chunked prefill into slot 1 and one decode block, the
    slot's rows equal JAX's within 1e-5 (f32), its bucket pads included.
    (The pad token an inactive row writes at its frozen position is
    unspecified: the decode kernel gives such a row no attention, JAX's
    composed path some.)"""
    jm, jv, tm = models
    prompt = [(5 * i + 1) % 512 for i in range(13)]
    jeng = JaxEngine(jm, jv, JaxServeConfig(**DKW,
                                            cache_dtype=jnp.float32))
    eng = Engine(tm, DCFG)
    active = np.asarray([False, True, False])
    for e in (jeng, eng):
        e.pool.alloc()
        slot = e.pool.alloc()
        assert slot == 1
        e.prefill(slot, prompt, max_new_tokens=4)
    want_tok, _ = jeng.step(active)
    got_tok, got_e = eng.step(active)
    np.testing.assert_array_equal(got_tok[1], want_tok[1])
    assert got_e.tolist() == [0, 1, 0]
    for jc, tc in zip(jeng.pool.caches, eng.pool.caches):
        for kv in ("k", "v"):
            np.testing.assert_allclose(tc[kv].numpy()[1],
                                       np.asarray(jc[kv])[1], atol=1e-5,
                                       rtol=0)
            assert tc[kv].numpy()[1, :, len(prompt)].any()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_decode_impl_override(models, layout):
    """``decode_impl="xla"`` serves the same greedy tokens through the
    composed decode path, over the caller's own tensors, and leaves the
    caller's model as it was."""
    _, _, tm = models
    base = dataclasses.replace(DCFG, kv_layout=layout, kv_block_size=4)
    want = _serve(Scheduler(Engine(tm, base)), Request)
    eng = Engine(tm, dataclasses.replace(base, decode_impl="xla"))
    assert _serve(Scheduler(eng), Request) == want
    assert eng.model.cfg.decode_impl == "xla"
    assert eng.model.h[1].attn.cfg.decode_impl == "xla"
    assert tm.cfg.decode_impl == tm.h[1].attn.cfg.decode_impl == "auto"
    assert eng.model.h[1].mlp.fc.w is tm.h[1].mlp.fc.w
    with pytest.raises(ValueError, match="decode_impl"):
        ServeConfig(decode_impl="flash")


# ------------------------------------------------------------------ CLI
CLI = ["--random-init", "--model-preset", "tiny", "--device", "cpu",
       "--max-len", "64", "--max-prefill-len", "16", "--kv-block-size",
       "8"]
LINES = [{"id": "a", "prompt_tokens": [5, 17, 3], "max_new_tokens": 6},
         {"id": "b", "prompt_tokens": list(range(1, 30)),
          "max_new_tokens": 5},
         {"id": "c", "prompt_tokens": [9, 9], "max_new_tokens": 5,
          "temperature": 0.8, "seed": 3}]


def _cli(argv):
    args = cli_serve.build_parser().parse_args(CLI + argv)
    sched = cli_serve.build_scheduler(args)
    out = io.StringIO()
    stdin = io.StringIO("".join(json.dumps(x) + "\n" for x in LINES))
    assert cli_serve.run_stdio(sched, args, stdin=stdin, stdout=out) == 0
    res = {o["id"]: o for o in map(json.loads, out.getvalue().splitlines())}
    assert {o["finish_reason"] for o in res.values()} == {"length"}
    return sched.engine, {k: o["tokens"] for k, o in res.items()}


@pytest.fixture(scope="module")
def draft_dirs(tmp_path_factory):
    """A train checkpoint of another tiny GPT-2 and a Hugging Face
    directory of a 2-layer one (both the target's vocabulary)."""
    from nezha_tpu_torch.cli.common import gpt2_for_preset
    from nezha_tpu_torch.models import hf
    from nezha_tpu_torch.train import checkpoint as ckpt

    root = tmp_path_factory.mktemp("drafts")
    model = gpt2_for_preset("tiny", seed=5, device="cpu")
    ckpt.save_checkpoint(str(root / "ckpt"), train_state_to_jax(model), 1)
    hf.random_hf_model("gpt2", seed=2, vocab_size=512, n_positions=96,
                       n_embd=64, n_layer=2, n_head=4).save_pretrained(
                           str(root / "hf"))
    return str(root / "ckpt"), str(root / "hf")


def test_cli_layout_speculative_and_bucket_flags(draft_dirs):
    """``--kv-layout dense``, ``--speculative`` with a self-draft, a
    draft checkpoint and a Hugging Face draft, ``--prefill-buckets`` and
    ``--decode-impl``: every greedy stream is the classic paged one."""
    ckpt_dir, hf_dir = draft_dirs
    _, want = _cli([])
    greedy = {k: v for k, v in want.items() if k != "c"}
    for argv in (["--kv-layout", "dense"],
                 ["--speculative", "--draft-k", "3", "--draft-layers", "1"],
                 ["--speculative", "--kv-layout", "dense",
                  "--draft-ckpt-dir", ckpt_dir],
                 ["--speculative", "--draft-hf-dir", hf_dir,
                  "--decode-horizon", "2"],
                 ["--prefill-buckets", "4,16", "--decode-impl", "xla"]):
        eng, got = _cli(argv)
        assert {k: v for k, v in got.items() if k != "c"} == greedy, argv
        assert len(got["c"]) == 5
    eng, _ = _cli(["--speculative", "--draft-k", "3", "--draft-layers",
                   "1", "--kv-layout", "dense", "--prefill-buckets", "4,16",
                   "--decode-impl", "xla"])
    cfg = eng.cfg
    assert (cfg.kv_layout, cfg.prefill_buckets, cfg.decode_impl) == (
        "dense", (4, 16), "xla")
    assert cfg.speculative.draft_k == 3 and eng.draft_model.cfg.num_layers == 1
    assert eng.spec_verifies > 0


@pytest.mark.parametrize("argv,match", [
    (["--draft-ckpt-dir", "d"], "require --speculative"),
    (["--draft-hf-dir", "d"], "require --speculative"),
    # Speculative serving runs under a mesh now; the dense layout, which
    # has no head-sharded pool, is what a mesh still refuses.
    pytest.param(["--speculative", "--mesh", "2", "--kv-layout", "dense"],
                 "kv_layout='paged'", id="argv2-A6"),
    (["--speculative", "--draft-layers", "9"], "draft_layers"),
    (["--speculative", "--draft-k", "0"], "draft_k"),
    (["--prefill-buckets", "4,x"], "--prefill-buckets"),
    (["--prefill-buckets", "4,8"], "prefill_buckets"),
    (["--kv-layout", "dense", "--kv-dtype", "int8"], "paged")])
def test_cli_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli_serve.main(CLI + argv)
