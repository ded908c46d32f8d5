"""Hugging Face interop in the port (``models/convert.py``'s HF half,
``models/hf.py``, ``--hf-dir`` and ``cli/export.py``) on the CPU, against
``transformers`` and the JAX package on the same inputs:

- the port's logits against a random ``GPT2LMHeadModel`` and
  ``BertForMaskedLM`` (atol/rtol 2e-4, as tests/test_convert.py), and its
  greedy cached generation against HF's;
- the HF -> parameters conversion bitwise equal to ``params_from_jax`` of
  JAX's ``gpt2_params_from_hf``/``bert_params_from_hf``, and the export
  mapping bitwise equal to JAX's ``*_params_to_hf``;
- ``cli.export`` (npz and torch) from a dense and a per-shard save of the
  port's train CLI, key for key and bitwise equal to JAX's
  ``nezha_tpu.cli.export`` on the same checkpoint, and taken by HF's
  ``load_state_dict(strict=True)``;
- ``--hf-dir`` generate and serve with the tokenizer shipped in the
  directory, against JAX's generate CLI.

Every HF model is built from a config written here and seeded; nothing
is downloaded.
"""

import json
import os

import numpy as np
import pytest
import torch

# Every directory here is local; the hub is never asked.
os.environ.setdefault("HF_HUB_OFFLINE", "1")
transformers = pytest.importorskip("transformers")

from nezha_tpu_torch.cli import export as export_cli  # noqa: E402
from nezha_tpu_torch.cli import generate as generate_cli  # noqa: E402
from nezha_tpu_torch.cli import serve as serve_cli  # noqa: E402
from nezha_tpu_torch.cli import train as train_cli  # noqa: E402
from nezha_tpu_torch.models import convert, hf  # noqa: E402
from nezha_tpu_torch.models.generate import generate  # noqa: E402

GPT2_HF = dict(vocab_size=128, n_positions=64, n_embd=96, n_layer=3,
               n_head=4)
BERT_HF = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=32, hidden_act="gelu")


@pytest.fixture(scope="module")
def hf_gpt2():
    return hf.random_hf_model("gpt2", seed=0, **GPT2_HF)


@pytest.fixture(scope="module")
def hf_bert():
    return hf.random_hf_model("bert", seed=1, **BERT_HF)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_gpt2_logits_match_transformers(hf_gpt2):
    model = convert.gpt2_from_hf(hf_gpt2, device="cpu")
    tokens = np.random.RandomState(0).randint(0, 128, (2, 17))
    with torch.no_grad():
        ref = hf_gpt2(torch.tensor(tokens)).logits.numpy()
        ours = model(torch.tensor(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=2e-4)


def test_gpt2_cached_greedy_matches_transformers(hf_gpt2):
    model = convert.gpt2_from_hf(hf_gpt2, device="cpu")
    prompt = torch.tensor([[11, 29, 3, 64]])
    ref = hf_gpt2.generate(prompt, max_new_tokens=10, do_sample=False,
                           pad_token_id=0)
    with torch.no_grad():
        ours = generate(model, prompt, max_new_tokens=10, temperature=0.0,
                        cache_dtype=torch.float32)
    assert torch.equal(ours, ref)


def test_bert_logits_match_transformers(hf_bert):
    model = convert.bert_from_hf(hf_bert, device="cpu")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 96, (2, 12))
    segs = rng.randint(0, 2, (2, 12))
    pad = np.ones((2, 12), bool)
    pad[1, 9:] = False
    with torch.no_grad():
        ref = hf_bert(input_ids=torch.tensor(tokens),
                      token_type_ids=torch.tensor(segs),
                      attention_mask=torch.tensor(pad.astype(np.int64))
                      ).logits.numpy()
        model.eval()
        ours = model({"tokens": torch.tensor(tokens),
                      "segment_ids": torch.tensor(segs),
                      "padding_mask": torch.tensor(pad)}).numpy()
    # Pad positions attend otherwise in HF and are never used.
    np.testing.assert_allclose(ours[pad], ref[pad], atol=2e-4, rtol=2e-4)


def test_conversions_match_jax_bitwise(hf_gpt2, hf_bert):
    from nezha_tpu.models import convert as jax_convert

    sd = hf_gpt2.state_dict()
    mine = convert.gpt2_params_from_hf(sd, 3)
    want = convert.params_from_jax(_flatten(
        jax_convert.gpt2_params_from_hf(sd, 3)))
    assert sorted(mine) == sorted(want)
    for k in mine:
        assert torch.equal(mine[k], want[k]), k
    _assert_same(convert.gpt2_params_to_hf(mine, 3),
                 jax_convert.gpt2_params_to_hf(
                     jax_convert.gpt2_params_from_hf(sd, 3), 3))
    bsd = hf_bert.state_dict()
    mine = convert.bert_params_from_hf(bsd, 2)
    want = convert.bert_from_jax(_flatten(
        jax_convert.bert_params_from_hf(bsd, 2)))
    assert sorted(mine) == sorted(want)
    for k in mine:
        assert torch.equal(mine[k], want[k]), k
    _assert_same(convert.bert_params_to_hf(mine, 2, 64),
                 jax_convert.bert_params_to_hf(
                     jax_convert.bert_params_from_hf(bsd, 2), 2, 64))
    # The configs too.
    assert convert.gpt2_config_from_hf(hf_gpt2.config).__dict__.items() \
        >= {"vocab_size": 128, "max_positions": 64, "num_layers": 3,
            "num_heads": 4, "hidden_size": 96, "mlp_ratio": 4}.items()
    for bad in (dict(activation_function="relu"),
                dict(layer_norm_epsilon=1e-6), dict(n_inner=100)):
        cfg = transformers.GPT2Config(**{**GPT2_HF, **bad})
        with pytest.raises(ValueError) as mine_e:
            convert.gpt2_config_from_hf(cfg)
        with pytest.raises(ValueError) as jax_e:
            jax_convert.gpt2_config_from_hf(cfg)
        assert str(mine_e.value) == str(jax_e.value)


def _train(config, layout, d):
    argv = ["--config", config, "--model-preset", "tiny", "--device",
            "cpu", "--steps", "1", "--batch-size", "2", "--log-every", "0",
            "--ckpt-dir", str(d)]
    argv += (["--parallel", "single"] if layout == "dense"
             else ["--parallel", "zero1", "--mesh", "dp=1"])
    train_cli.run(train_cli.parse_args(argv))
    glob = "step_*.npz" if layout == "dense" else "step_*.sharded"
    assert [p.name for p in d.glob("step_*")] == [
        p.name for p in d.glob(glob)]


@pytest.mark.parametrize("config", ["gpt2_124m", "bert_base_zero1"])
@pytest.mark.parametrize("layout", ["dense", "sharded"])
def test_export_matches_jax_export(tmp_path, config, layout):
    from nezha_tpu.cli import export as jax_export

    ck = tmp_path / "ck"
    _train(config, layout, ck)
    for fmt in ("npz", "torch"):
        common = ["--config", config, "--ckpt-dir", str(ck),
                  "--model-preset", "tiny", "--format", fmt]
        mine = export_cli.run(export_cli.build_parser().parse_args(
            common + ["--out", str(tmp_path / f"mine_{fmt}"), "--device",
                      "cpu"]))
        theirs = jax_export.run(jax_export.build_parser().parse_args(
            common + ["--out", str(tmp_path / f"jax_{fmt}"), "--platform",
                      "cpu"]))
        assert mine["keys"] == theirs["keys"]
        if fmt == "npz":
            assert mine["out"].endswith(".npz")
            with np.load(mine["out"]) as a, np.load(theirs["out"]) as b:
                _assert_same(dict(a), dict(b))
            continue
        a, b = torch.load(mine["out"]), torch.load(theirs["out"])
        _assert_same({k: v.numpy() for k, v in a.items()},
                     {k: v.numpy() for k, v in b.items()})
        if config == "gpt2_124m":
            from nezha_tpu_torch.cli.common import TINY_GPT2_KW as kw
            target = hf.random_hf_model(
                "gpt2", vocab_size=kw["vocab_size"],
                n_positions=kw["max_positions"], n_embd=kw["hidden_size"],
                n_layer=kw["num_layers"], n_head=kw["num_heads"])
        else:
            from nezha_tpu_torch.cli.common import TINY_BERT_KW as kw
            target = hf.random_hf_model(
                "bert", vocab_size=kw["vocab_size"],
                max_position_embeddings=kw["max_positions"],
                hidden_size=kw["hidden_size"],
                num_hidden_layers=kw["num_layers"],
                num_attention_heads=kw["num_heads"],
                intermediate_size=4 * kw["hidden_size"])
        target.load_state_dict(a, strict=True)


def test_export_refuses_a_scan_trunk(tmp_path):
    """A ``--scan-layers`` trunk is read now (sliced into the unrolled
    layers; tests/test_torch_graph_cli.py exports a whole one); a
    checkpoint that holds only part of one is refused, naming the leaf it
    lacks."""
    from nezha_tpu_torch.train import checkpoint as ckpt

    ckpt.save_checkpoint(str(tmp_path), {
        "variables/params/h_scan/ln_1/scale": np.zeros((4, 64),
                                                       np.float32)}, 1)
    with pytest.raises(KeyError, match="missing leaf"):
        export_cli.main(["--config", "gpt2_124m", "--ckpt-dir",
                         str(tmp_path), "--model-preset", "tiny", "--out",
                         str(tmp_path / "x"), "--device", "cpu"])


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A saved random GPT-2 (vocab 300) with a byte-level BPE of 40
    merges beside it (vocab.json and merges.txt)."""
    from nezha_tpu_torch.data.bpe_train import learn_bpe, save_bpe_files

    d = tmp_path_factory.mktemp("hf")
    model = hf.random_hf_model("gpt2", seed=3, vocab_size=300,
                               n_positions=64, n_embd=64, n_layer=2,
                               n_head=4)
    with torch.no_grad():   # sharper logits: the greedy path depends on
        for name, p in model.named_parameters():   # attention
            if name.endswith(("c_attn.weight", "c_fc.weight")):
                p.mul_(6.0)
    model.save_pretrained(str(d))
    vocab, merges = learn_bpe(["the cat sat on the mat", "hello there",
                               "the hat and the cat"] * 5, 40)
    save_bpe_files(str(d), vocab, merges)
    return d, model


def test_hf_dir_generate_matches_jax_and_loads_the_weights(hf_dir, capsys):
    from nezha_tpu.cli import generate as jax_generate

    d, model = hf_dir
    loaded = hf.load_gpt2(str(d), device="cpu")
    want = convert.gpt2_params_from_hf(model.state_dict(), 2)
    got = loaded.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    argv = ["--hf-dir", str(d), "--prompt", "the cat", "--max-new-tokens",
            "8", "--temperature", "0"]
    mine = generate_cli.run(generate_cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    theirs = jax_generate.run(jax_generate.build_parser().parse_args(
        argv + ["--platform", "cpu"]))
    capsys.readouterr()
    assert mine["tokens"] == theirs["tokens"] and "text" in mine
    assert mine["text"] == theirs["text"]
    assert mine["prompt_len"] == theirs["prompt_len"] == len(
        generate_cli.load_tokenizer_arg(generate_cli.build_parser()
                                        .parse_args(argv)).encode(
            "the cat"))


def test_hf_dir_serve_uses_the_shipped_tokenizer(hf_dir):
    import io

    d, _ = hf_dir
    args = serve_cli.build_parser().parse_args(
        ["--hf-dir", str(d), "--device", "cpu", "--max-new-tokens", "6",
         "--cache-dtype", "f32"])
    sched = serve_cli.build_scheduler(args)
    tok = serve_cli.load_tokenizer_arg(args)
    assert tok is not None and tok.vocab_size == len(json.loads(
        (d / "vocab.json").read_text()))
    out = io.StringIO()
    serve_cli.run_stdio(sched, args, stdin=io.StringIO(
        '{"id": "a", "prompt": "the cat"}\n'), stdout=out, tokenizer=tok)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line["event"] == "done" and len(line["tokens"]) == 6
    assert line["text"] == tok.decode(line["tokens"])
