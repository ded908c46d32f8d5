"""A training checkpoint streamed onto the serve mesh in the port
(``serve/sharded/reshard.py``, ``cli/reshard.py``, ``serve --mesh M
--ckpt-dir``) on the CPU, against the JAX package on the same
checkpoints:

- the shards from a dense npz and from a per-shard save (each leaf stored
  in uneven row pieces over two process files) bitwise equal to
  ``place_variables`` of the dense restore, at M = 2 and 4;
- a CRC mismatch, a missing leaf and a missing process file refused with
  ``ReshardError``, and the serve CLI refusing typed;
- ``cli.reshard --out --verify`` exact, and a changed byte caught;
- the serve checkpoint read across packages, both ways, bitwise;
- ``serve --mesh 2 --ckpt-dir`` greedy tokens equal to JAX's sharded
  engine on JAX's resharded variables.

The model is the tiny preset (4 layers, 4 heads, hidden 64, vocab 512)
with its attention and MLP matrices scaled by 6, so that greedy tokens
depend on attention.
"""

import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu_torch.cli import reshard as reshard_cli
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.cli.common import gpt2_for_preset, restore_variables_any
from nezha_tpu_torch.models.convert import params_to_jax, train_state_to_jax
from nezha_tpu_torch.parallel.mesh import make_mesh
from nezha_tpu_torch.serve.sharded import (ReshardError, place_variables,
                                           reshard_checkpoint,
                                           save_serve_checkpoint,
                                           serve_tp_rules, verify_roundtrip)
from nezha_tpu_torch.train import checkpoint as ckpt
from nezha_tpu_torch.train import sharded_checkpoint as sck

STEP = 7


def _model(seed=0):
    return gpt2_for_preset("tiny", seed=seed, device="cpu")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """-> (dense dir, per-shard dir, the model whose weights they hold)."""
    model = _model(seed=3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if re.search(r"(attn|mlp)\.\w+\.w$", name):
                p.mul_(6.0)
    flat = train_state_to_jax(model, rng=np.asarray([0, 3], np.uint32))
    dense = tmp_path_factory.mktemp("dense")
    ckpt.save_checkpoint(str(dense), flat, STEP)
    # The per-shard layout of a world of two: every leaf cut along its
    # first axis at a third, piece one in process 0's file and piece two
    # in process 1's, so each serve shard's part spans stored pieces.
    sharded = tmp_path_factory.mktemp("sharded")
    for proc in range(2):
        leaves = {}
        for key, arr in flat.items():
            if arr.ndim == 0:
                leaf = sck.whole(arr) if proc == 0 else sck.ShardedLeaf(
                    arr.shape, str(arr.dtype))
            else:
                cut = arr.shape[0] // 3
                lo, hi = (0, cut) if proc == 0 else (cut, arr.shape[0])
                idx = ((lo, hi),) + tuple((0, n) for n in arr.shape[1:])
                leaf = sck.ShardedLeaf(arr.shape, str(arr.dtype),
                                       [(idx, arr[lo:hi].copy())])
            leaves[key] = leaf
        sck.save_sharded(str(sharded), leaves, STEP, proc=proc, world=2)
    return dense, sharded, model


def _mesh(m):
    return make_mesh({"tp": m}, device_type="cpu")


def _assert_shards_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            assert g[name].dtype == w[name].dtype, name
            assert torch.equal(g[name], w[name]), name


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("source", ["dense", "sharded"])
def test_reshard_equals_placed_dense_restore(saved, source, m):
    dense, sharded, _ = saved
    ref = _model()
    restore_variables_any(str(dense), ref)
    mesh, rules = _mesh(m), serve_tp_rules(ref.cfg, m)
    want = place_variables(dict(ref.named_parameters()), mesh, rules)
    got, step = reshard_checkpoint(str(dense if source == "dense"
                                       else sharded), _model(), mesh)
    assert step == STEP
    _assert_shards_equal(got, want)
    # A replicated leaf is one tensor a device: the mesh repeats the CPU.
    assert got[0]["ln_f.scale"] is got[m - 1]["ln_f.scale"]
    assert got[0]["h.0.attn.qkv.w"].shape[1] == 3 * 64 // m


def _rewrite_npz(src_dir, dst_dir, edit):
    path = ckpt.checkpoint_path(str(src_dir), STEP)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    edit(flat)
    dst_dir.mkdir()
    with open(ckpt.checkpoint_path(str(dst_dir), STEP), "wb") as f:
        np.savez(f, **flat)


def test_corrupt_or_missing_leaves_are_refused(saved, tmp_path):
    dense, sharded, _ = saved
    mesh = _mesh(2)
    key = "variables/params/h1/mlp/fc/w"

    def flip(flat):
        arr = flat[key].copy()
        arr.view(np.uint32)[0, 0] ^= 1
        flat[key] = arr

    _rewrite_npz(dense, tmp_path / "crc", flip)
    with pytest.raises(ReshardError, match="CRC32 mismatch for leaf "
                                           "'variables/params/h1/mlp/fc/w'"):
        reshard_checkpoint(str(tmp_path / "crc"), _model(), mesh)
    _rewrite_npz(dense, tmp_path / "gone", lambda flat: flat.pop(key))
    with pytest.raises(ReshardError, match="missing leaf 'params/h1/mlp/fc"
                                           "/w'"):
        reshard_checkpoint(str(tmp_path / "gone"), _model(), mesh)
    # A per-shard save missing process 1's file: torn, so not the newest
    # save; named by its step it cannot cover the slices.
    import shutil
    torn = tmp_path / "torn"
    shutil.copytree(sharded, torn)
    step_dir = sck.step_dir(str(torn), STEP)
    for name in ("shards_p1.npz", "meta_p1.json", "COMPLETE_p1"):
        (step_dir / name).unlink()
    with pytest.raises(ReshardError, match="no training checkpoint"):
        reshard_checkpoint(str(torn), _model(), mesh)
    with pytest.raises(ReshardError, match="stored shards do not cover"):
        reshard_checkpoint(str(torn), _model(), mesh, step=STEP)
    # The serve CLI refuses to start, typed; the reshard CLI exits 1.
    with pytest.raises(SystemExit, match="--mesh 2: reshard refused: CRC32"):
        serve_cli.build_scheduler(serve_cli.build_parser().parse_args(
            ["--ckpt-dir", str(tmp_path / "crc"), "--model-preset", "tiny",
             "--device", "cpu", "--mesh", "2"]))
    assert reshard_cli.main(["--ckpt-dir", str(tmp_path / "gone"),
                             "--mesh", "2", "--model-preset", "tiny",
                             "--device", "cpu"]) == 1


def test_cli_out_verify_is_exact(saved, tmp_path, capsys):
    dense, _, _ = saved
    out = tmp_path / "serve4"
    rc = reshard_cli.main(["--ckpt-dir", str(dense), "--mesh", "4",
                           "--model-preset", "tiny", "--device", "cpu",
                           "--out", str(out), "--verify", "--json"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["roundtrip_ok"] and report["step"] == STEP
    assert report["mesh_devices"] == 4
    assert report["params_bytes"] == sum(
        a.nbytes for k, a in train_state_to_jax(_model()).items()
        if k.startswith("variables/"))
    assert report["params_bytes_per_device"] < report["params_bytes"]
    assert 0 < report["host_rss_before_bytes"] <= \
        report["peak_host_rss_bytes"]
    # The save reads back onto another mesh size as the same weights.
    ref = _model()
    restore_variables_any(str(dense), ref)
    got, _ = reshard_checkpoint(str(out), _model(), _mesh(2))
    _assert_shards_equal(got, place_variables(
        dict(ref.named_parameters()), _mesh(2), serve_tp_rules(ref.cfg, 2)))
    # A changed byte in the save is caught.
    shards, _ = reshard_checkpoint(str(dense), _model(), _mesh(4))
    rules = serve_tp_rules(ref.cfg, 4)
    assert verify_roundtrip(str(out), shards, STEP, rules) == []
    shards[1]["h.2.mlp.proj.w"] = shards[1]["h.2.mlp.proj.w"] + 1
    assert verify_roundtrip(str(out), shards, STEP, rules) == [
        "variables/params/h2/mlp/proj/w"]


def _jax_side(m):
    from nezha_tpu.cli.common import gpt2_for_preset as jax_preset
    from nezha_tpu.parallel.mesh import make_mesh as jax_make_mesh

    model = jax_preset("tiny")
    return model, jax_make_mesh({"tp": m}, devices=jax.devices()[:m])


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(jax.device_get(v))
    return out


def test_serve_checkpoints_cross_packages_bitwise(saved, tmp_path):
    from nezha_tpu.serve.sharded import reshard_checkpoint as jax_reshard
    from nezha_tpu.serve.sharded import (save_serve_checkpoint as
                                         jax_save_serve)

    dense, _, _ = saved
    ref = _model()
    restore_variables_any(str(dense), ref)
    full = params_to_jax(dict(ref.named_parameters()))
    # JAX reads the port's serve checkpoint (written from a mesh of 4).
    shards, step = reshard_checkpoint(str(dense), _model(), _mesh(4))
    save_serve_checkpoint(str(tmp_path / "port"), shards, step,
                          serve_tp_rules(ref.cfg, 4))
    jm, jmesh = _jax_side(2)
    variables, jstep = jax_reshard(str(tmp_path / "port"), jm, jmesh)
    assert jstep == STEP
    got = _flatten(variables["params"])
    assert sorted(got) == sorted(full)
    for k in full:
        assert got[k].tobytes() == full[k].tobytes(), k
    # The port reads JAX's serve checkpoint (written from its mesh of 2).
    variables, _ = jax_reshard(str(dense), jm, jmesh)
    jax_save_serve(str(tmp_path / "jax"), variables, STEP)
    got, step = reshard_checkpoint(str(tmp_path / "jax"), _model(),
                                   _mesh(4))
    assert step == STEP
    _assert_shards_equal(got, place_variables(
        dict(ref.named_parameters()), _mesh(4), serve_tp_rules(ref.cfg, 4)))


PROMPTS = [[5, 17, 3, 99, 250, 7], [400, 2, 2, 31], list(range(40, 60)),
           [1, 2, 3]]


def test_serve_mesh_ckpt_dir_greedy_matches_jax(saved):
    from nezha_tpu.serve import Request as JaxRequest
    from nezha_tpu.serve import Scheduler as JaxScheduler
    from nezha_tpu.serve import ServeConfig as JaxServeConfig
    from nezha_tpu.serve.sharded import ShardedEngine as JaxShardedEngine
    from nezha_tpu.serve.sharded import reshard_checkpoint as jax_reshard

    dense, _, _ = saved
    new = 8
    args = serve_cli.build_parser().parse_args(
        ["--ckpt-dir", str(dense), "--model-preset", "tiny", "--device",
         "cpu", "--mesh", "2", "--cache-dtype", "f32", "--max-new-tokens",
         str(new)])
    sched = serve_cli.build_scheduler(args)
    out = io.StringIO()
    lines = "".join(json.dumps({"id": f"r{i}", "prompt_tokens": p}) + "\n"
                    for i, p in enumerate(PROMPTS))
    serve_cli.run_stdio(sched, args, stdin=io.StringIO(lines), stdout=out)
    mine = {o["id"]: o["tokens"] for o in map(json.loads,
                                              out.getvalue().splitlines())}
    jm, jmesh = _jax_side(2)
    variables, _ = jax_reshard(str(dense), jm, jmesh)
    cfg = JaxServeConfig(max_batch_size=4, max_len=96, max_prefill_len=32,
                         kv_block_size=16, cache_dtype=jnp.float32,
                         k_max=64, queue_capacity=16)
    jsched = JaxScheduler(JaxShardedEngine(jm, variables, cfg,
                                           mesh_devices=2))
    for i, p in enumerate(PROMPTS):
        jsched.submit(JaxRequest(prompt=list(p), max_new_tokens=new,
                                 request_id=f"r{i}"))
    jsched.run_until_idle(max_iters=400)
    theirs = {rid: r.tokens for rid, r in jsched.results.items()}
    assert mine == theirs
    assert all(len(t) == new for t in mine.values())
    # Greedy tokens that depend on attention, not a repeated last token.
    assert any(len(set(t)) > 2 for t in mine.values())
