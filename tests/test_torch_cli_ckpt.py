"""The port's CLIs on the pack -> train -> resume -> generate/serve path,
on the CPU at the tiny presets, against the JAX CLIs:

- 2 + 2 resumed steps of the port's train CLI equal 4 straight steps
  bitwise (every leaf of the last checkpoint), from ``--data-dir``;
- resumed from a checkpoint the JAX train CLI wrote at step 1, the
  port's train CLI gives JAX's losses of steps 2 and 3 on the same packed
  data, for GPT-2 (a BPE corpus) and BERT (a WordPiece corpus, dynamic
  masking), within 1e-5 (``tests/test_torch_train.py``'s loss
  tolerance), and its weights within 2 lr a step (AdamW's first moves
  are ~lr sign(g));
  JAX's token loader is pinned to one worker here, as the port's is,
  since two workers' batches interleave in arrival order;
- generate and serve from a JAX-written checkpoint with ``--tokenizer``
  give JAX's greedy tokens and ``text``;
- graph-engine and scan-layer checkpoints (npz or per-shard) that hold
  only part of the model are refused with a ``KeyError`` naming the leaf
  they lack, and an ``--hf-dir`` without a saved model exits naming it.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from nezha_tpu.cli import generate as jax_generate_cli
from nezha_tpu.cli import pack_text as jax_pack_cli
from nezha_tpu.cli import train as jax_train_cli
from nezha_tpu.data import native as jax_native
from nezha_tpu.train import checkpoint as jax_ckpt
from nezha_tpu_torch.cli import generate as generate_cli
from nezha_tpu_torch.cli import serve as serve_cli
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.cli.common import (gpt2_for_preset,
                                        restore_variables_any)
from nezha_tpu_torch.train import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT_LR, BERT_LR = 6e-4, 1e-4


def _pack(d, learn):
    jax_pack_cli.run(jax_pack_cli.build_parser().parse_args([
        os.path.join(ROOT, "nezha_tpu_torch", "data"), *learn,
        "--save-tokenizer", str(d / "tok"), "--out",
        str(d / "data" / "train.tokens.u16")]))
    jax_pack_cli.run(jax_pack_cli.build_parser().parse_args([
        os.path.join(ROOT, "docs"), "--tokenizer", str(d / "tok"), "--out",
        str(d / "data" / "val.tokens.u16")]))
    return d


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's own data modules packed with a learned BPE (train) and
    the docs with the same tokenizer (val), by the JAX CLI."""
    return _pack(tmp_path_factory.mktemp("corpus"), ["--learn-bpe", "200"])


@pytest.fixture(scope="module")
def wp_corpus(tmp_path_factory):
    """The same sources with a learned WordPiece vocab ([MASK] at 4)."""
    return _pack(tmp_path_factory.mktemp("wp_corpus"),
                 ["--learn-wordpiece", "400"])


def _port_train(argv):
    return train_cli.run(train_cli.parse_args(argv))


def _gpt2_argv(data, ckpt_dir, steps, *extra):
    return ["--config", "gpt2_124m", "--model-preset", "tiny", "--device",
            "cpu", "--batch-size", "2", "--seq-len", "96", "--data-dir",
            str(data), "--ckpt-dir", str(ckpt_dir), "--steps", str(steps),
            *extra]


def test_resumed_run_equals_straight_run_bitwise(corpus, tmp_path, capsys):
    data = corpus / "data"
    _port_train(_gpt2_argv(data, tmp_path / "a", 4))
    _port_train(_gpt2_argv(data, tmp_path / "b", 2, "--ckpt-every", "1",
                           "--ckpt-keep", "1"))
    assert ckpt.checkpoint_steps(str(tmp_path / "b")) == [2]
    capsys.readouterr()
    last = _port_train(_gpt2_argv(data, tmp_path / "b", 2, "--eval",
                                  "--eval-batches", "2"))
    assert "resumed from step 2" in capsys.readouterr().err
    assert last["step"] == 4 and np.isfinite(last["eval_perplexity"])
    a = ckpt.verify_checkpoint(str(tmp_path / "a"), 4)
    b = ckpt.verify_checkpoint(str(tmp_path / "b"), 4)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


class _OneWorkerTokenLoader(jax_native.TokenLoader):
    def __init__(self, *args, **kw):
        super().__init__(*args, **{**kw, "num_workers": 1})


CONFIG_ARGV = {
    "gpt2_124m": ["--config", "gpt2_124m", "--model-preset", "tiny",
                  "--batch-size", "2", "--seq-len", "96"],
    "bert_base_zero1": ["--config", "bert_base_zero1", "--model-preset",
                        "tiny", "--batch-size", "2"],
}


def _jax_train(config, data, d):
    """The JAX train CLI, 3 steps from the packed corpus, single-device,
    a checkpoint and a metrics line each step; -> {step: loss}."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "TokenLoader", _OneWorkerTokenLoader)
    try:
        jax_train_cli.main(CONFIG_ARGV[config] + [
            "--data-dir", str(data), "--ckpt-dir", str(d / "ckpt"),
            "--ckpt-every", "1", "--steps", "3", "--log-every", "1",
            "--metrics-file", str(d / "metrics.jsonl"), "--parallel",
            "single"])
    finally:
        mp.undo()
    losses = {}
    for line in (d / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "loss" in rec:
            losses[int(rec["step"])] = float(rec["loss"])
    return losses


@pytest.fixture(scope="module")
def jax_run(corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_run")
    return d, _jax_train("gpt2_124m", corpus / "data", d)


@pytest.fixture(scope="module")
def jax_bert_run(wp_corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_bert_run")
    return d, _jax_train("bert_base_zero1", wp_corpus / "data", d)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("config", list(CONFIG_ARGV))
def test_train_cli_from_data_dir_gives_jax_losses(request, config, tmp_path,
                                                  steps, capsys):
    """From JAX's step-1 checkpoint, the port's CLI trains steps 2 (and
    3) on the batches JAX trained them on (BERT: the same dynamic masks,
    [MASK] resolved from the corpus's sidecar)."""
    gpt2 = config == "gpt2_124m"
    d, jax_losses = request.getfixturevalue("jax_run" if gpt2
                                            else "jax_bert_run")
    data = request.getfixturevalue("corpus" if gpt2 else "wp_corpus")
    mine = tmp_path / "ckpt"
    mine.mkdir()
    shutil.copy(ckpt.checkpoint_path(str(d / "ckpt"), 1), mine)
    last = _port_train(CONFIG_ARGV[config] + [
        "--device", "cpu", "--data-dir", str(data / "data"), "--ckpt-dir",
        str(mine), "--steps", str(steps)])
    err = capsys.readouterr().err
    assert "resumed from step 1" in err
    assert gpt2 or "mlm: [MASK] id 4 resolved" in err
    assert last["step"] == 1 + steps
    assert abs(last["loss"] - jax_losses[1 + steps]) <= 1e-5
    want = jax_ckpt.verify_checkpoint(str(d / "ckpt"), 1 + steps)
    got = ckpt.verify_checkpoint(str(mine), 1 + steps)
    assert got.keys() == want.keys()
    lr = GPT_LR if gpt2 else BERT_LR
    for key in want:
        if key.startswith("variables/params/"):
            assert np.abs(got[key] - want[key]).max() <= \
                2 * lr * steps, key
    assert int(got["opt_state/step"]) == 1 + steps


def _jax_generate(argv):
    return jax_generate_cli.run(jax_generate_cli.build_parser().parse_args(
        argv))


def _port_generate(argv):
    return generate_cli.run(generate_cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))


@pytest.mark.parametrize("prompt", ["def main(", "class Loader:"])
def test_generate_and_serve_from_jax_checkpoint_give_jax_tokens(
        jax_run, corpus, prompt):
    d, _ = jax_run
    argv = ["--ckpt-dir", str(d / "ckpt"), "--model-preset", "tiny",
            "--tokenizer", str(corpus / "tok"), "--prompt", prompt,
            "--max-new-tokens", "12", "--temperature", "0"]
    want = _jax_generate(argv)
    got = _port_generate(argv)
    assert got["tokens"] == want["tokens"]
    assert got["text"] == want["text"] and got["prompt_len"] == \
        want["prompt_len"]
    args = serve_cli.build_parser().parse_args([
        "--ckpt-dir", str(d / "ckpt"), "--model-preset", "tiny",
        "--tokenizer", str(corpus / "tok"), "--device", "cpu",
        "--cache-dtype", "f32", "--max-len", "64", "--max-prefill-len",
        "16", "--kv-block-size", "8"])
    out = io.StringIO()
    reqs = [{"id": "t", "prompt": prompt, "max_new_tokens": 12},
            {"id": "ids", "prompt_tokens": [5, 6, 7], "max_new_tokens": 3}]
    serve_cli.run_stdio(serve_cli.build_scheduler(args), args,
                        stdin=io.StringIO("\n".join(map(json.dumps, reqs))
                                          + "\n"),
                        stdout=out,
                        tokenizer=serve_cli.load_tokenizer_arg(args))
    res = {r["id"]: r for r in map(json.loads,
                                   out.getvalue().splitlines())}
    assert res["t"]["tokens"] == want["tokens"]
    assert res["t"]["text"] == want["text"]
    assert len(res["ids"]["tokens"]) == 3 and "text" in res["ids"]


def _fake_ckpt(d, keys):
    ckpt.save_checkpoint(str(d), {k: np.zeros(2, np.float32) for k in keys},
                         1)


@pytest.mark.parametrize("layout", ["hf", "sharded", "graph", "scan"])
def test_unported_sources_and_layouts_are_refused_typed(tmp_path, layout):
    d = tmp_path / layout
    d.mkdir()
    argv = ["--ckpt-dir", str(d), "--model-preset", "tiny",
            "--prompt-tokens", "1,2"]
    if layout == "hf":
        # --hf-dir is ported: a directory without a saved model exits,
        # naming it.
        argv[:2] = ["--hf-dir", str(d)]
        with pytest.raises(SystemExit, match=f"--hf-dir {d}"):
            _port_generate(argv)
        return
    elif layout == "sharded":
        # Per-shard saves are read, a --scan-layers trunk in one too; one
        # that holds only part of the trunk is refused, naming a leaf.
        from nezha_tpu_torch.train.sharded_checkpoint import (save_sharded,
                                                              whole)
        save_sharded(str(d), {"variables/params/h_scan/ln_1/scale": whole(
            np.zeros((4, 64), np.float32))}, 1, proc=0, world=1)
    elif layout == "graph":
        # The graph engine's layout is read params-only (JAX's
        # _is_graph_layout); an incomplete one names the leaf it lacks.
        _fake_ckpt(d, ["params/wte/embedding", "mu/wte/embedding"])
    else:
        _fake_ckpt(d, ["variables/params/h_scan/ln_1/scale"])
    # (Whole graph and scan checkpoints: tests/test_torch_graph_cli.py.)
    with pytest.raises(KeyError, match="missing leaf"):
        _port_generate(argv)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_variables_any(str(d), gpt2_for_preset("tiny", device="cpu"))


def test_train_cli_flag_checks(corpus, tmp_path):
    base = ["--config", "bert_base_zero1", "--model-preset", "tiny"]
    with pytest.raises(SystemExit):
        train_cli.parse_args(base + ["--mlm-mask-token", "4"])
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--config", "gpt2_124m",
                              "--label-smoothing", "0.1"])
    with pytest.raises(SystemExit):
        train_cli.parse_args(base + ["--ckpt-keep", "0"])
    # A byte-range check: the packed ids must fit the model's vocab.
    big = tmp_path / "big"
    big.mkdir()
    np.full(4096, 600, np.uint16).tofile(big / "train.tokens.u16")
    with pytest.raises(SystemExit, match="vocab"):
        _port_train(["--config", "gpt2_124m", "--model-preset", "tiny",
                     "--device", "cpu", "--steps", "1", "--data-dir",
                     str(big)])
    # A byte-packed corpus cannot take BERT's default [MASK] id.
    byte = tmp_path / "byte"
    byte.mkdir()
    np.arange(4096, dtype=np.uint16).__mod__(200).astype(np.uint16).tofile(
        byte / "train.tokens.u16")
    with pytest.raises(SystemExit, match="byte-packed"):
        _port_train(base + ["--device", "cpu", "--steps", "1",
                            "--data-dir", str(byte)])


def test_image_configs_from_records_and_mnist_from_idx(tmp_path, capsys):
    """The tiny ResNet from NZR1 records (--crop, label smoothing), saved
    and resumed (momentum's velocity and the BatchNorm statistics come
    back), evaluated on val.nzr; the MLP from MNIST IDX files."""
    from nezha_tpu_torch.data.native import write_image_records

    r = np.random.RandomState(0)
    data = tmp_path / "img"
    data.mkdir()
    write_image_records(str(data / "train.nzr"),
                        r.randint(0, 256, (16, 40, 40, 3), dtype=np.uint8),
                        r.randint(0, 100, 16))
    write_image_records(str(data / "val.nzr"),
                        r.randint(0, 256, (6, 40, 40, 3), dtype=np.uint8),
                        r.randint(0, 100, 6))
    argv = ["--config", "resnet50_imagenet", "--model-preset", "tiny",
            "--device", "cpu", "--batch-size", "4", "--data-dir", str(data),
            "--crop", "32", "--label-smoothing", "0.1", "--ckpt-dir",
            str(tmp_path / "c"), "--steps", "2"]
    _port_train(argv)
    capsys.readouterr()
    last = _port_train(argv + ["--eval"])
    err = capsys.readouterr().err
    assert "resumed from step 2" in err and "16 image records" in err
    assert "batch 4 -> 3" in err and last["eval_count"] == 6
    assert last["step"] == 4 and np.isfinite(last["loss"])
    flat = ckpt.verify_checkpoint(str(tmp_path / "c"), 4)
    assert any(k.startswith("opt_state/velocity/") for k in flat)
    assert any(k.startswith("variables/state/") for k in flat)
    mnist = tmp_path / "mn" / "mnist"
    mnist.mkdir(parents=True)
    for stem, n in (("train", 256), ("t10k", 64)):
        (mnist / f"{stem}-images-idx3-ubyte").write_bytes(
            bytes.fromhex("00000803") + n.to_bytes(4, "big")
            + (28).to_bytes(4, "big") * 2
            + r.randint(0, 256, n * 784, dtype=np.uint8).tobytes())
        (mnist / f"{stem}-labels-idx1-ubyte").write_bytes(
            bytes.fromhex("00000801") + n.to_bytes(4, "big")
            + r.randint(0, 10, n, dtype=np.uint8).tobytes())
    # The CLI sets NEZHA_DATA_DIR when it is unset; set it here so that
    # undo() takes it away again.
    mp = pytest.MonkeyPatch()
    mp.setenv("NEZHA_DATA_DIR", str(tmp_path / "mn"))
    try:
        last = _port_train(["--config", "mlp_mnist", "--device", "cpu",
                            "--steps", "2", "--batch-size", "32",
                            "--data-dir", str(tmp_path / "mn"), "--eval"])
    finally:
        mp.undo()
    assert "MNIST IDX files" in capsys.readouterr().err
    assert last["eval_count"] == 64


def test_inference_clis_refuse_cuda_without_a_card(corpus, jax_run):
    """Generate and serve default to the card; without one they exit
    and name --device cpu, never falling back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    d, _ = jax_run
    argv = ["--ckpt-dir", str(d / "ckpt"), "--model-preset", "tiny",
            "--tokenizer", str(corpus / "tok")]
    with pytest.raises(SystemExit, match="--device cpu"):
        generate_cli.run(generate_cli.build_parser().parse_args(
            argv + ["--prompt", "x"]))
    with pytest.raises(SystemExit, match="--device cpu"):
        serve_cli.build_scheduler(serve_cli.build_parser().parse_args(argv))
