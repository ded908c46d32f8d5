"""The train CLI's graph engine (``--engine graph``, ``--graph-bf16``) and
``--scan-layers``, and the inference CLIs on their checkpoints, on the CPU
at the tiny presets, against the JAX package's CLIs and programs:

- every config under ``--engine graph`` (gpt2 also ``--graph-bf16``, the
  MLP also dp and ZeRO-1 on ``--mesh dp=2``): the CLI's second step
  equals JAX's graph program applied to the CLI's step-1 checkpoint and
  the stream's second batch (the programs' tolerances of
  ``tests/test_torch_graph_programs.py``), and a ``--run-dir`` summary
  counts the executor's one build and its hits;
- graph checkpoints cross between the packages both ways: one the JAX
  CLI wrote restores into the port's step bitwise, and the JAX CLI
  resumes from one the port wrote;
- ``--scan-layers`` under single, dp and zero1 (GPT-2; BERT under zero1)
  trains bitwise as the unrolled trunk (the losses, and every saved
  weight against the unrolled run's, stacked); gspmd and sp under it are
  refused typed;
- every refusal of the two engines' flags with JAX's words;
- generate, serve, export and reshard from a graph-engine checkpoint and
  from a scan trunk (dense and per-shard): generate and export equal to
  JAX's CLIs on the same checkpoint, serve to generate (so to JAX's
  generate), reshard to the dense restore and (the dense saves: JAX's
  reshard reads a scan trunk from the npz alone) to JAX's reshard of the
  same checkpoint, bitwise.
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from nezha_tpu import data as jdata
from nezha_tpu import models as jmodels
from nezha_tpu.cli import export as jax_export_cli
from nezha_tpu.cli import generate as jax_generate_cli
from nezha_tpu.cli import train as jax_train_cli
from nezha_tpu.graph import programs as jp
from nezha_tpu_torch.cli import export as export_cli
from nezha_tpu_torch.cli import generate as generate_cli
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.cli.common import (TINY_BERT_KW, TINY_GPT2_KW,
                                        gpt2_for_preset,
                                        restore_variables_any)
from nezha_tpu_torch.nn.scan import stack_flat_keys
from nezha_tpu_torch.train import checkpoint as ckpt
from nezha_tpu_torch.train import sharded_checkpoint as sck


def _port(argv):
    return train_cli.run(train_cli.parse_args(argv + ["--device", "cpu"]))


def _npz(d: Path, step: int) -> dict:
    with np.load(ckpt.checkpoint_path(str(d), step)) as z:
        return {k: z[k] for k in z.files if k != ckpt.MANIFEST_KEY}


def _nest(flat: dict) -> dict:
    out = {}
    for key, val in flat.items():
        node = out
        *heads, leaf = key.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = val
    return out


def _second_batch(stream):
    next(stream)
    return next(stream)


# config -> (extra argv, batch size, JAX program over the CLI's step-1
# state, the stream's second batch as the program takes it, loss rtol,
# state atol)
def _graph_case(name):
    cfg = jax_train_cli._configs()
    if name.startswith("mlp"):
        dims = [784, 256, 256, 10]
        prog = jp.make_mlp_graph_train_step(dims, 8, lr=0.1)
        batch = jp.onehot_shard_fn(10)(_second_batch(jdata.mnist_batches(8)))
        return ["--config", "mlp_mnist"], 8, prog, batch, 1e-5, 2e-5
    if name.startswith("gpt2"):
        sched = cfg["gpt2_124m"].graph_opt["schedule"](2)
        bf16 = name == "gpt2_bf16"
        prog = jp.make_gpt2_graph_train_step(
            jmodels.GPT2(jmodels.GPT2Config(**TINY_GPT2_KW)),
            lambda t: float(sched(np.int32(t))), weight_decay=0.1,
            compute_dtype="bfloat16" if bf16 else "float32")
        batch = jp.lm_shard_fn()(_second_batch(jdata.synthetic_token_batches(
            2, seq_len=64, vocab_size=512)))
        argv = ["--config", "gpt2_124m", "--model-preset", "tiny"]
        return (argv + ["--graph-bf16"] * bf16, 2, prog, batch,
                1e-3 if bf16 else 5e-4, 1e-4)
    if name == "bert_base_zero1":
        sched = cfg["bert_base_zero1"].graph_opt["schedule"](2)
        prog = jp.make_bert_graph_train_step(
            jmodels.Bert(jmodels.BertConfig(**TINY_BERT_KW)),
            lambda t: float(sched(np.int32(t))), weight_decay=0.01)
        batch = jp.bert_shard_fn()(_second_batch(jdata.synthetic_mlm_batches(
            2, seq_len=64, vocab_size=512, mask_token=1)))
        return (["--config", name, "--model-preset", "tiny"], 2, prog, batch,
                5e-4, 1e-4)
    wide = name == "wrn101_large_batch"
    prog = jp.make_resnet_graph_train_step(
        jmodels.ResNet((1, 1), num_classes=100, width_factor=2 if wide
                       else 1), lr=0.1)
    batch = jp.image_shard_fn()(_second_batch(jdata.synthetic_image_batches(
        4, image_size=32, num_classes=100)))
    return (["--config", name, "--model-preset", "tiny"], 4, prog, batch,
            1e-4, 1e-4)


@pytest.mark.parametrize("name", ["mlp_mnist", "gpt2_124m", "gpt2_bf16",
                                  "bert_base_zero1", "resnet50_imagenet",
                                  "wrn101_large_batch"])
def test_graph_engine_step_matches_jax(tmp_path, name):
    argv, bs, prog, batch, rtol, atol = _graph_case(name)
    d, run_dir = tmp_path / "ck", tmp_path / "run"
    metrics = tmp_path / "m.jsonl"
    last = _port(argv + ["--engine", "graph", "--steps", "2", "--batch-size",
                         str(bs), "--ckpt-dir", str(d), "--ckpt-every", "1",
                         "--log-every", "1", "--metrics-file", str(metrics),
                         "--run-dir", str(run_dir)])
    assert last["step"] == 2
    losses = [json.loads(l)["loss"] for l in metrics.read_text().splitlines()
              if "loss" in json.loads(l)]
    s1, s2 = _npz(d, 1), _npz(d, 2)
    assert "rng" not in s1 and not any(k.startswith("variables/")
                                       for k in s1)
    state = _nest(s1)
    if "step" in state:
        state["step"] = np.asarray(state["step"], np.int32)
        assert int(state["step"]) == 1
    summary = json.loads((run_dir / "summary.json").read_text())
    assert summary["compile_cache"]["misses"] == 1
    assert summary["compile_cache"]["hits"] == 1
    assert summary["run"]["engine"] == "graph"
    new, m = prog(state, batch)
    np.testing.assert_allclose(losses[1], float(m["loss"]), rtol=rtol)
    want = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(new)[0]}
    assert want.keys() == s2.keys()
    if name == "gpt2_bf16":
        # bf16 products round differently in the two packages: each
        # slot's change over the step must lie within 15% of its norm
        # (twice the bf16-against-fp32 spread of JAX's own update,
        # tests/test_torch_graph_programs.py).
        for slot in ("params", "mu", "nu"):
            ks = [k for k in want if k.startswith(slot + "/")]
            cat = lambda src: np.concatenate([np.ravel(src[k]) for k in ks])
            assert np.linalg.norm(cat(s2) - cat(want)) <= \
                0.15 * np.linalg.norm(cat(want) - cat(s1)), slot
        return
    for k, v in want.items():
        np.testing.assert_allclose(s2[k], v, atol=atol, err_msg=k)


@pytest.mark.parametrize("mode", ["dp", "zero1"])
def test_graph_mlp_dp_and_zero1_track_single(tmp_path, mode):
    """``--parallel dp|zero1 --mesh dp=2`` on ``[cpu] * 2``: the losses
    of the single-device graph engine (to 1e-5), the save in JAX's layout
    (ZeRO-1's ``flat``/``vel``), a resume from it, and the eval on the
    gathered params."""
    base = ["--config", "mlp_mnist", "--engine", "graph", "--batch-size",
            "8", "--log-every", "1"]
    single = _port(base + ["--steps", "3"])
    d = tmp_path / mode
    par = _port(base + ["--steps", "2", "--parallel", mode, "--mesh",
                        "dp=2", "--ckpt-dir", str(d), "--eval",
                        "--eval-batches", "1"])
    assert "eval_accuracy" in par
    keys = set(_npz(d, 2))
    assert keys == ({"flat", "vel"} if mode == "zero1" else
                    {f"{s}/{n}/{p}" for s in ("params", "vel")
                     for n in ("fc0", "fc1", "head") for p in ("w", "b")})
    resumed = _port(base + ["--steps", "1", "--parallel", mode, "--mesh",
                            "dp=2", "--ckpt-dir", str(d)])
    assert resumed["step"] == 3
    np.testing.assert_allclose(resumed["loss"], single["loss"], rtol=1e-5)


def _jax_train(argv):
    jax_train_cli.main(argv + ["--platform", "cpu"])


GPT2_TINY = ["--config", "gpt2_124m", "--model-preset", "tiny",
             "--batch-size", "2", "--engine", "graph"]


def test_graph_checkpoints_cross_between_the_packages(tmp_path, capfd):
    """A JAX graph-engine save restores into the port's graph step leaf
    for leaf, bit for bit, and the port's CLI resumes from it; the JAX
    CLI resumes from the port's save (GPT-2 AdamW state and ZeRO-1's flat
    state)."""
    from nezha_tpu_torch.train.loop import Trainer

    jd = tmp_path / "jax"
    _jax_train(GPT2_TINY + ["--steps", "1", "--ckpt-dir", str(jd)])
    args = train_cli.parse_args(GPT2_TINY + ["--steps", "1", "--device",
                                             "cpu", "--ckpt-dir", str(jd)])
    cfg = train_cli.build_config("gpt2_124m", "tiny", device="cpu")
    _, step = train_cli.build_graph_step(args, cfg, 2, torch.device("cpu"))
    tr = Trainer(cfg.model, None, None, checkpoint_dir=str(jd), step_fn=step)
    assert tr.initialize() == 1
    saved = _npz(jd, 1)
    got = step.state_leaves()
    assert got.keys() == saved.keys()
    for k in saved:
        assert got[k].dtype == saved[k].dtype
        assert got[k].tobytes() == saved[k].tobytes(), k
    capfd.readouterr()
    assert _port(GPT2_TINY + ["--steps", "1", "--ckpt-dir", str(jd)]
                 )["step"] == 2
    assert "resumed from step 1" in capfd.readouterr().err

    for argv in (GPT2_TINY, ["--config", "mlp_mnist", "--engine", "graph",
                             "--batch-size", "8", "--parallel", "zero1",
                             "--mesh", "dp=2"]):
        pd = tmp_path / argv[1]
        _port(argv + ["--steps", "1", "--ckpt-dir", str(pd)])
        port_leaves = _npz(pd, 1)
        capfd.readouterr()
        _jax_train(argv + ["--steps", "1", "--ckpt-dir", str(pd)])
        assert "resumed from step 1" in capfd.readouterr().err
        restored = _npz(pd, 2)
        assert restored.keys() == port_leaves.keys()


SCAN_BASE = ["--config", "gpt2_124m", "--model-preset", "tiny",
             "--batch-size", "2", "--seq-len", "32", "--steps", "2",
             "--log-every", "1"]


def _saved_params(d: Path, sharded: bool) -> dict:
    if not sharded:
        return {k: v for k, v in _npz(d, 2).items()
                if k.startswith("variables/params/")}
    keys = [k for k in sck.checkpoint_keys(str(d), 2)
            if k.startswith("variables/params/")]
    store = sck._ShardStore(sck.step_dir(str(d), 2))
    try:
        return {k: store.read(k, [(0, n) for n in store.leaves[k]["shape"]])
                for k in keys}
    finally:
        store.close()


@pytest.mark.parametrize("config,mode", [
    ("gpt2_124m", "single"), ("gpt2_124m", "dp"), ("gpt2_124m", "zero1"),
    ("bert_base_zero1", "zero1")])
def test_scan_layers_trains_as_the_unrolled_trunk(tmp_path, config, mode):
    base = list(SCAN_BASE)
    base[1] = config
    if config != "gpt2_124m":
        base = base[:6] + base[8:]     # no --seq-len
    mesh = [] if mode == "single" else ["--mesh", "dp=1"]
    runs = {}
    for scan in (False, True):
        d = tmp_path / f"scan{int(scan)}"
        runs[scan] = (_port(base + ["--parallel", mode, "--ckpt-dir", str(d)]
                            + mesh + ["--scan-layers"] * scan), d)
    assert runs[True][0]["loss"] == runs[False][0]["loss"]
    sharded = mode == "zero1"
    unrolled = _saved_params(runs[False][1], sharded)
    scan = _saved_params(runs[True][1], sharded)
    prefix, stacked = (("h", "h_scan") if config == "gpt2_124m"
                       else ("layers", "layers_scan"))
    n = (TINY_GPT2_KW if config == "gpt2_124m" else TINY_BERT_KW)[
        "num_layers"]
    want = stack_flat_keys(unrolled, prefix, n, stacked)
    assert want.keys() == scan.keys()
    for k in want:
        assert want[k].tobytes() == scan[k].tobytes(), k


@pytest.mark.parametrize("mode", ["gspmd", "sp"])
def test_scan_layers_under_gspmd_and_sp_is_refused_typed(mode):
    with pytest.raises(SystemExit, match="ROADMAP A7"):
        train_cli.main(SCAN_BASE + ["--scan-layers", "--parallel", mode,
                                    "--mesh", {"gspmd": "dp=1,tp=2",
                                               "sp": "dp=1,sp=2"}[mode],
                                    "--device", "cpu"])


REFUSALS = [
    ["--config", "gpt2_124m", "--graph-bf16"],
    ["--config", "mlp_mnist", "--engine", "graph", "--graph-bf16"],
    ["--config", "gpt2_124m", "--engine", "graph", "--optimizer", "adamw",
     "--lr", "1e-3"],
    ["--config", "gpt2_124m", "--engine", "graph", "--moe-experts", "4"],
    ["--config", "gpt2_124m", "--engine", "graph", "--wd-exclude-1d"],
    ["--config", "gpt2_124m", "--engine", "graph", "--grad-accum", "2"],
    ["--config", "gpt2_124m", "--engine", "graph", "--dropout", "0.1"],
    ["--config", "mlp_mnist", "--engine", "graph", "--label-smoothing",
     "0.1"],
    ["--config", "gpt2_124m", "--engine", "graph", "--remat"],
    ["--config", "gpt2_124m", "--engine", "graph", "--scan-layers"],
    ["--config", "mlp_mnist", "--scan-layers"],
    ["--config", "gpt2_124m", "--scan-layers", "--parallel", "pp"],
    ["--config", "mlp_mnist", "--engine", "graph", "--parallel", "dp",
     "--clip-norm", "1.0"],
    ["--config", "gpt2_124m", "--engine", "graph", "--parallel", "gspmd"],
    ["--config", "gpt2_124m", "--engine", "graph", "--parallel", "zero1"],
    ["--config", "gpt2_124m", "--engine", "graph", "--mesh", "dp=2"],
    ["--config", "gpt2_124m", "--engine", "graph", "--parallel", "dp",
     "--grad-allreduce", "int8"],
    ["--config", "gpt2_124m", "--engine", "graph", "--sp-flash", "on"],
    ["--config", "mlp_mnist", "--engine", "graph", "--parallel", "dp",
     "--mesh", "dp=2,tp=1"],
    ["--config", "mlp_mnist", "--engine", "graph", "--parallel", "dp",
     "--mesh", "dp=3", "--batch-size", "8"],
    ["--config", "resnet50_imagenet", "--model-preset", "tiny", "--engine",
     "graph", "--eval"],
]


@pytest.mark.parametrize("argv", REFUSALS, ids=lambda a: " ".join(a[1:]))
def test_refusals_have_jax_words(argv):
    with pytest.raises(SystemExit) as mine:
        train_cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        _jax_train(argv)
    assert str(mine.value) == str(theirs.value)
    assert str(mine.value) not in ("0", "2", "None")


def test_graph_engine_refuses_rejoin_and_processes():
    with pytest.raises(SystemExit, match="module-engine modes") as e:
        train_cli.main(["--config", "gpt2_124m", "--engine", "graph",
                        "--on-failure", "rejoin", "--coordinator",
                        "127.0.0.1:1", "--ckpt-dir", "/nonexistent",
                        "--device", "cpu"])
    assert "engine 'graph'" in str(e.value)
    with pytest.raises(SystemExit, match="ROADMAP A7"):
        train_cli.main(["--config", "mlp_mnist", "--engine", "graph",
                        "--parallel", "dp", "--coordinator", "127.0.0.1:1",
                        "--device", "cpu"])


@pytest.fixture(scope="module")
def inference_ckpts(tmp_path_factory):
    """GPT-2 tiny checkpoints of one step each: the graph engine's, a
    scan trunk's dense save and a scan trunk's per-shard (ZeRO-1) save."""
    root = tmp_path_factory.mktemp("inf")
    base = ["--config", "gpt2_124m", "--model-preset", "tiny",
            "--batch-size", "2", "--steps", "1"]
    out = {}
    for name, extra in (("graph", ["--engine", "graph"]),
                        ("scan", ["--scan-layers", "--parallel", "single"]),
                        ("scan_sharded", ["--scan-layers", "--parallel",
                                          "zero1", "--mesh", "dp=1"])):
        out[name] = root / name
        _port(base + extra + ["--ckpt-dir", str(out[name])])
    assert (out["scan_sharded"] / "step_00000001.sharded").is_dir()
    return out


@pytest.mark.parametrize("layout", ["graph", "scan", "scan_sharded"])
def test_inference_clis_read_graph_and_scan_checkpoints(inference_ckpts,
                                                        tmp_path, layout):
    d = str(inference_ckpts[layout])
    argv = ["--ckpt-dir", d, "--model-preset", "tiny", "--prompt-tokens",
            "5,6,7", "--max-new-tokens", "8", "--temperature", "0"]
    want = jax_generate_cli.run(jax_generate_cli.build_parser().parse_args(
        argv))
    got = generate_cli.run(generate_cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert got["tokens"] == want["tokens"]
    # serve gives generate's tokens
    args = serve_cli.build_parser().parse_args([
        "--ckpt-dir", d, "--model-preset", "tiny", "--device", "cpu",
        "--cache-dtype", "f32", "--max-len", "32", "--max-prefill-len", "8",
        "--kv-block-size", "8"])
    out = io.StringIO()
    serve_cli.run_stdio(serve_cli.build_scheduler(args), args,
                        stdin=io.StringIO(json.dumps(
                            {"id": "a", "prompt_tokens": [5, 6, 7],
                             "max_new_tokens": 8}) + "\n"), stdout=out)
    assert json.loads(out.getvalue().splitlines()[0])["tokens"] == \
        got["tokens"]
    # export equals JAX's export, bitwise
    common = ["--config", "gpt2_124m", "--ckpt-dir", d, "--model-preset",
              "tiny"]
    mine = export_cli.run(export_cli.build_parser().parse_args(
        common + ["--out", str(tmp_path / "mine"), "--device", "cpu"]))
    theirs = jax_export_cli.run(jax_export_cli.build_parser().parse_args(
        common + ["--out", str(tmp_path / "jax"), "--platform", "cpu"]))
    with np.load(mine["out"]) as a, np.load(theirs["out"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    # reshard onto a 2-shard CPU mesh equals resharding the dense restore
    # saved unrolled
    from nezha_tpu_torch.models.convert import train_state_to_jax
    from nezha_tpu_torch.parallel.mesh import make_mesh
    from nezha_tpu_torch.serve.sharded.reshard import reshard_checkpoint
    model = gpt2_for_preset("tiny", device="cpu")
    restore_variables_any(d, model)
    ref = tmp_path / "unrolled"
    ckpt.save_checkpoint(str(ref), train_state_to_jax(model), 1)
    mesh = make_mesh({"tp": 2}, device_type="cpu")
    shards, step = reshard_checkpoint(d, model, mesh)
    want, _ = reshard_checkpoint(str(ref), model, mesh)
    assert step == 1 and len(shards) == 2
    for a, b in zip(shards, want):
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name
    if layout == "scan_sharded":
        return   # JAX's reshard reads a scan trunk from the npz alone
    # JAX's reshard of the same checkpoint onto its 2-device mesh holds
    # the port's restored weights, bit for bit.
    from nezha_tpu import parallel as jparallel
    from nezha_tpu.serve.sharded.reshard import \
        reshard_checkpoint as jax_reshard
    jvars, jstep = jax_reshard(d, jmodels.GPT2(jmodels.GPT2Config(
        **TINY_GPT2_KW)), jparallel.make_mesh(
            {"tp": 2}, devices=jax.devices()[:2]))
    assert jstep == 1
    mine = train_state_to_jax(model)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jvars["params"])[0]:
        key = "variables/params/" + "/".join(str(p.key) for p in path)
        assert np.asarray(leaf).tobytes() == mine[key].tobytes(), key
