"""Tensor-sharded serving in the port (``serve/sharded``, ``parallel/mesh``)
against the JAX package, on the JAX tests' tiny model (vocab 64, 2
layers, 4 heads, hidden 32) with f32 pools; the port's mesh is ``[cpu] *
M``, JAX's the suite's forced host devices.

- ``place_variables``: the shards reassemble the full parameters, qkv
  split by whole heads, the embedding vocab-sliced or replicated;
- the port's ``ShardedEngine`` at M=2 against JAX ``ShardedEngine
  (mesh_devices=2)``, replicated prefill, f32 and int8 pools: greedy
  tokens identical over long-bucket prompts and a shared-prefix repeat;
  clean per-shard books after drain;
- the mesh collectives, the chunk planner against JAX's, the new
  ``ServeConfig`` knobs' validation, and the typed refusals of the
  engine and the CLI.

The weights are JAX's init with the attention and MLP matrices scaled
by 6, so that greedy tokens depend on attention (at init scale every
request repeats its last token)."""

import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.serve import Engine as JaxEngine
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu.serve.sharded import ShardedEngine as JaxShardedEngine
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.parallel import (all_to_all, make_mesh, pmax, ppermute,
                                      psum, ring_perm)
from nezha_tpu_torch.serve import (Engine, Request, Scheduler,
                                   ServeConfig, ShardedEngine)
from nezha_tpu_torch.serve.sharded import (ReshardError, place_variables,
                                           reshard_checkpoint,
                                           serve_tp_rules)

CFG = dict(vocab_size=64, max_positions=64, num_layers=2, num_heads=4,
           hidden_size=32)
# JAX's LCFG: two long buckets above max_prefill_len.
KW = dict(max_batch_size=2, max_len=64, max_prefill_len=8,
          prefill_buckets=(4, 8), long_prefill_buckets=(16, 32), k_max=16,
          queue_capacity=8)
WEIGHT_SCALE = 6.0


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


def make_pair(cfg=CFG, **jax_kw):
    """-> (JAX model, its variables, the port's model on the CPU), with
    the same weights."""
    jm = JaxGPT2(JaxGPT2Config(**cfg, **jax_kw))
    jv = jm.init(jax.random.PRNGKey(0))

    def scale(path, x):
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        return x * WEIGHT_SCALE if re.search(r"(attn|mlp)/\w+/w$", key) \
            else x

    jv = {**jv, "params": jax.tree_util.tree_map_with_path(scale,
                                                           jv["params"])}
    tm = GPT2(GPT2Config(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


def waves():
    """Long-bucket prompts (27 pads up to 32, 17 to 32, 12 to 16), short
    ones, two sharing a 16-token block, then a repeat of both kinds."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 64, 16).tolist()
    long_p = rng.randint(0, 64, 27).tolist()
    first = [long_p, rng.randint(0, 64, 17).tolist(),
             rng.randint(0, 64, 12).tolist(), [5, 6, 7],
             prefix + [1, 2, 3], prefix + [9]]
    return [[(f"a{i}", p) for i, p in enumerate(first)],
            [("repeat_prefix", prefix + [1, 2, 3]), ("repeat_long", long_p)]]


def run_waves(engine, make_request, scheduler_cls, max_new=6):
    sched = scheduler_cls(engine)
    for wave in waves():
        for rid, prompt in wave:
            sched.submit(make_request(prompt=list(prompt),
                                      max_new_tokens=max_new,
                                      request_id=rid))
        sched.run_until_idle(max_iters=400)
        assert not sched.has_work()
    return {rid: r.tokens for rid, r in sched.results.items()}


def jax_tokens(jm, jv, m, **cfg_kw):
    cfg = JaxServeConfig(**KW, cache_dtype=jnp.float32, **cfg_kw)
    return run_waves(JaxShardedEngine(jm, jv, cfg, mesh_devices=m),
                     JaxRequest, JaxScheduler)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("vocab", [64, 65])
def test_place_variables_reassembles_with_head_grouped_qkv(vocab):
    """Every shard's parts put back together give the full parameters;
    shard r's qkv columns are the q, k and v columns of heads [r*H/M,
    (r+1)*H/M); the embedding is vocab-sliced when the vocabulary divides
    by M and shared whole otherwise."""
    m = 2
    cfg = GPT2Config(**{**CFG, "vocab_size": vocab})
    model = GPT2(cfg, device="cpu")
    params = dict(model.named_parameters())
    mesh = make_mesh({"tp": m}, device_type="cpu")
    shards = place_variables(params, mesh, serve_tp_rules(cfg, m))
    h, hh = cfg.hidden_size, cfg.hidden_size // m
    for name, full in params.items():
        parts = [s[name] for s in shards]
        if name.endswith("qkv.w") or name.endswith("qkv.b"):
            ax = full.dim() - 1
            for r, part in enumerate(parts):
                for j in range(3):       # q, k, v
                    want = full.narrow(ax, j * h + r * hh, hh)
                    assert torch.equal(part.narrow(ax, j * hh, hh), want)
        elif re.search(r"(attn|mlp)\.proj\.w$|wte\.embedding$", name) and (
                "wte" not in name or vocab % m == 0):
            assert torch.equal(torch.cat(parts, 0), full), name
        elif re.search(r"mlp\.fc\.[wb]$", name):
            assert torch.equal(torch.cat(parts, full.dim() - 1), full), name
        else:
            assert all(p.data_ptr() == full.data_ptr() for p in parts), name
    # reshard_checkpoint is ported (tests/test_torch_reshard.py): a
    # directory with no checkpoint is its typed refusal.
    with pytest.raises(ReshardError, match="no training checkpoint"):
        reshard_checkpoint("ckpt", model, mesh)


# --------------------------------------------------- engine vs JAX, M=2
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_replicated_prefill_greedy_matches_jax(pair, kv_dtype):
    """Replicated prefill on the sharded engine, f32 blocks and int8
    blocks: greedy tokens identical to JAX's sharded engine (int8:
    tokens, as the JAX engine quantizes under jit, ROADMAP C); a prefix
    hit; the per-shard books balance and no bytes stay resident once
    the prefix cache is cleared."""
    jm, jv, tm = pair
    want = jax_tokens(jm, jv, 2, kv_dtype=kv_dtype)
    eng = ShardedEngine(tm, ServeConfig(**KW, cache_dtype=torch.float32,
                                        kv_dtype=kv_dtype), mesh_devices=2)
    got = run_waves(eng, Request, Scheduler)
    assert got == want
    assert len({tuple(t) for t in got.values()}) > 3
    pool = eng.pool
    assert pool.prefix_hits >= 1 and pool.shard_devices == 2
    if kv_dtype == "int8":
        assert eng.quant_errors and max(eng.quant_errors) > 0
    pool.leak_check()
    assert pool.bytes_resident_per_shard * 2 == pool.bytes_resident > 0
    pool.clear_prefix_cache()
    pool.leak_check()
    assert pool.bytes_resident_per_shard == 0


def test_sharded_engine_matches_single_device_engine(pair):
    """M=1 and M=2 meshes serve the single-device engine's tokens."""
    _, _, tm = pair
    cfg = ServeConfig(**KW, cache_dtype=torch.float32)
    want = run_waves(Engine(tm, cfg), Request, Scheduler)
    for m in (1, 2):
        assert run_waves(ShardedEngine(tm, cfg, mesh_devices=m), Request,
                         Scheduler) == want


def test_memory_report_splits_params_and_kv(pair):
    _, _, tm = pair
    eng = ShardedEngine(tm, ServeConfig(**KW, cache_dtype=torch.float32),
                        mesh_devices=4)
    rep = eng.memory_report()
    n_params = sum(p.numel() * 4 for p in tm.parameters())
    assert rep["mesh_devices"] == 4 and rep["params_bytes"] == n_params
    assert rep["kv_capacity_bytes_per_device"] * 4 == \
        rep["kv_capacity_bytes"]
    assert rep["params_bytes_per_device"] < rep["params_bytes"]
    assert rep["bytes_per_device"] < rep["bytes_total"] // 2
    eng.pool.leak_check()


# ----------------------------------------------------------- collectives
def test_mesh_collectives():
    """all_to_all round trip and its tiled layout, ppermute's direction,
    psum and pmax in rank order with the same bits on every shard."""
    m = 4
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 8, 12, 3, generator=gen) for _ in range(m)]
    ys = all_to_all(xs, split_axis=1, concat_axis=2)
    assert ys[1].shape == (2, 2, 48, 3)
    assert torch.equal(ys[1][:, :, 12:24], xs[1][:, 2:4])
    back = all_to_all(ys, split_axis=2, concat_axis=1)
    assert all(torch.equal(a, b) for a, b in zip(back, xs))
    moved = ppermute(xs, ring_perm(m))
    assert all(torch.equal(moved[(r + 1) % m], xs[r]) for r in range(m))
    assert torch.equal(ppermute(xs, [(0, 2)])[1], torch.zeros_like(xs[1]))
    sums = psum(xs)
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert all(torch.equal(s, want) for s in sums)
    assert all(torch.equal(p, torch.stack(xs).amax(0)) for p in pmax(xs))
    mesh = make_mesh({"tp": 3}, device_type="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.size == 3 and mesh.axis_name == "tp"


def test_mesh_refuses_more_cards_than_visible():
    """On cuda the default devices are the visible cards, never one card
    repeated: asking for more is a ValueError (here, with no card, any
    mesh)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="devices"):
        make_mesh({"tp": n + 1}, device_type="cuda")
    with pytest.raises(ValueError, match="visible"):
        make_mesh({"tp": 2}, devices=["cpu"])
    with pytest.raises(ValueError, match="size >= 1"):
        make_mesh({"tp": 0}, device_type="cpu")


# -------------------------------------------------------- chunk planning
def test_plan_chunks_matches_jax_and_reduces_to_classic(pair):
    """The greedy largest-fit planner gives JAX's plan with and without
    long buckets, from cold and from a shared-prefix start; without long
    buckets it is full max_prefill_len strides and a bucketed tail."""
    _, _, tm = pair
    for long_b in ((16, 32), ()):
        kw = {**KW, "long_prefill_buckets": long_b}
        eng = Engine(tm, ServeConfig(**kw, cache_dtype=torch.float32))
        jeng = types.SimpleNamespace(cfg=JaxServeConfig(**kw))
        for n in range(1, 64):
            for start in (0, 16, n - 1):
                if 0 <= start < n:
                    assert eng._plan_chunks(n, start) == \
                        JaxEngine._plan_chunks(jeng, n, start), (n, start)
    assert eng._plan_chunks(27) == [(0, 8, 8), (8, 8, 8), (16, 8, 8),
                                    (24, 3, 4)]
    long_eng = Engine(tm, ServeConfig(**KW, cache_dtype=torch.float32))
    assert long_eng._plan_chunks(27) == [(0, 27, 32)]
    assert long_eng._plan_chunks(33) == [(0, 32, 32), (32, 1, 4)]


# ----------------------------------------------------- validation, refusals
def test_serve_config_validates_seq_knobs():
    with pytest.raises(ValueError, match="prefill_mode"):
        ServeConfig(prefill_mode="tensor")
    with pytest.raises(ValueError, match="seq_prefill_variant"):
        ServeConfig(seq_prefill_variant="striped")
    with pytest.raises(ValueError, match="strictly increasing"):
        ServeConfig(max_len=128, long_prefill_buckets=(64, 48))
    with pytest.raises(ValueError, match="lie in"):
        ServeConfig(max_len=128, max_prefill_len=32,
                    long_prefill_buckets=(32,))
    with pytest.raises(ValueError, match="lie in"):
        ServeConfig(max_len=128, long_prefill_buckets=(256,))
    cfg = ServeConfig(max_len=128, long_prefill_buckets=[64, 128])
    assert cfg.long_prefill_buckets == (64, 128)
    assert cfg.all_prefill_buckets == (8, 16, 32, 64, 128)


def test_sharded_engine_refusals_typed(pair):
    _, _, tm = pair
    seq = ServeConfig(**KW, cache_dtype=torch.float32,
                      prefill_mode="sequence")
    with pytest.raises(ValueError, match="mesh-sharded engine"):
        Engine(tm, seq)
    with pytest.raises(ValueError, match="mesh_devices > 1"):
        ShardedEngine(tm, seq, mesh_devices=1)
    with pytest.raises(ValueError, match=r"offending buckets: \[4\]"):
        ShardedEngine(tm, dataclasses.replace(seq, prefill_buckets=(4, 8)),
                      mesh_devices=8, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="num_heads"):
        ShardedEngine(tm, ServeConfig(**KW), mesh_devices=3)
    with pytest.raises(ValueError, match="visible"):
        ShardedEngine(tm, ServeConfig(**KW), mesh_devices=2,
                      devices=["cpu"])
    with pytest.raises(ValueError, match="mesh_devices must be"):
        ShardedEngine(tm, ServeConfig(**KW), mesh_devices=0)


def test_cli_refuses_sequence_without_mesh_and_missing_cards():
    parse = serve_cli.build_parser().parse_args
    base = ["--random-init", "--model-preset", "tiny"]
    with pytest.raises(SystemExit, match="requires --mesh M with M > 1"):
        serve_cli.build_scheduler(parse(base + [
            "--device", "cpu", "--prefill-mode", "sequence"]))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(SystemExit, match="CUDA card"):
        serve_cli.build_scheduler(parse(base + [
            "--device", "cuda", "--mesh", str(max(n + 1, 2))]))
    with pytest.raises(SystemExit, match="--mesh 3: num_heads"):
        serve_cli.build_scheduler(parse(base + [
            "--device", "cpu", "--mesh", "3"]))
    sched = serve_cli.build_scheduler(parse(base + [
        "--device", "cpu", "--mesh", "2", "--prefill-mode", "sequence",
        "--seq-prefill-variant", "ring", "--max-len", "64",
        "--max-prefill-len", "16", "--long-prefill-buckets", "32,64"]))
    assert isinstance(sched.engine, ShardedEngine)
    assert sched.engine._seq_variant == "ring"
    assert sched.engine.cfg.long_prefill_buckets == (32, 64)
