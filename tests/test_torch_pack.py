"""The port's packer and learners (``data/pack.py``, ``data/bpe_train.py``,
``cli/pack_text.py``) against the JAX package's: for the same sources the
learned tokenizer files, the packed token files and their metadata
sidecars are byte for byte JAX's ``cli.pack_text.run``'s."""

import json
import random

import numpy as np
import pytest

from nezha_tpu.cli import pack_text as jax_pack_text
from nezha_tpu.data import bpe_train as jax_bpe
from nezha_tpu.data import pack as jax_pack
from nezha_tpu_torch.cli import pack_text
from nezha_tpu_torch.data import bpe_train, pack

WORDS = ["alpha", "beta", "Gamma", "délta", "中文", "字", "x=1;", "don't",
         "it's", "(a, b)", "42", "\n", "\t", "  ", "<|endoftext|>", "ü",
         "naïve", "!!", "def", "main():", "return", "café"]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("src")
    r = random.Random(0)
    (d / "sub").mkdir()
    (d / ".git").mkdir()
    for i, name in enumerate(["a.md", "b.txt", "sub/c.py", "d.rst",
                              ".git/e.txt"]):
        (d / name).write_text(" ".join(r.choice(WORDS) for _ in range(400)),
                              encoding="utf-8")
    return d


def _args(parser_mod, argv):
    return parser_mod.build_parser().parse_args(argv)


@pytest.mark.parametrize("mode", [["--learn-bpe", "150"],
                                  ["--learn-wordpiece", "120"], []],
                         ids=["bpe", "wordpiece", "bytes"])
def test_pack_text_outputs_byte_identical_to_jax(sources, tmp_path, mode):
    outs = {}
    for name, mod in (("jax", jax_pack_text), ("port", pack_text)):
        # The same tokenizer directory for both: the sidecar records it.
        tokdir = tmp_path / "tok"
        argv = [str(sources), "--out", str(tmp_path / name /
                                          "train.tokens.u16")] + mode
        if mode:
            argv += ["--save-tokenizer", str(tokdir)]
        got = mod.run(_args(mod, argv))
        files = {p.name: p.read_bytes()
                 for p in (tmp_path / name).iterdir()}
        if mode:
            files.update({"tok/" + p.name: p.read_bytes()
                          for p in tokdir.iterdir()})
        outs[name] = (got, files)
    (jgot, jfiles), (pgot, pfiles) = outs["jax"], outs["port"]
    assert pgot["files"] == jgot["files"] == 3
    assert pgot["tokens"] == jgot["tokens"]
    assert pgot["tokenizer"] == jgot["tokenizer"]
    assert pfiles.keys() == jfiles.keys()
    for name in jfiles:
        assert pfiles[name] == jfiles[name], name
    if mode:
        meta = json.loads(pfiles["train.tokens.u16.meta.json"])
        assert meta["vocab_size"] == pgot["vocab_size"]
        assert (meta["mask_token_id"] == 4) == ("--learn-wordpiece" in mode)


def test_packing_with_a_given_tokenizer_and_tree(sources, tmp_path):
    texts = [p.read_text(encoding="utf-8")
             for p in sorted(sources.rglob("*.md"))]
    vocab, merges = jax_bpe.learn_bpe(texts, 80)
    jax_bpe.save_bpe_files(str(tmp_path / "tok"), vocab, merges)
    outs = []
    for mod in (jax_pack_text, pack_text):
        out = tmp_path / mod.__name__ / "val.tokens.u16"
        mod.run(_args(mod, [str(sources), "--tokenizer",
                            str(tmp_path / "tok"), "--out", str(out),
                            "--suffix", ".md", ".py"]))
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0
    a, b = tmp_path / "a.u16", tmp_path / "b.u16"
    assert jax_pack.pack_tree(str(sources), str(a)) == pack.pack_tree(
        str(sources), str(b))
    assert a.read_bytes() == b.read_bytes()
    assert pack.token_dtype(50257) == jax_pack.token_dtype(50257) == \
        np.uint16
    assert pack.token_dtype(70000) == jax_pack.token_dtype(70000) == \
        np.int32


@pytest.mark.parametrize("argv,match", [
    (["--learn-bpe", "5"], "--save-tokenizer"),
    (["--learn-bpe", "5", "--learn-wordpiece", "9", "--save-tokenizer",
      "t"], "ONE of"),
    (["--learn-wordpiece", "3", "--save-tokenizer", "t"], "below"),
])
def test_pack_text_refusals_match_jax(sources, tmp_path, argv, match):
    for mod in (jax_pack_text, pack_text):
        full = [str(sources), "--out", str(tmp_path / "x.tokens.u16")]
        full += [str(tmp_path / a) if a == "t" else a for a in argv]
        with pytest.raises(SystemExit, match=match):
            mod.run(_args(mod, full))


def test_learners_equal_jax_in_memory():
    r = random.Random(5)
    corpus = [" ".join(r.choice(WORDS) for _ in range(200))
              for _ in range(4)]
    assert bpe_train.learn_bpe(corpus, 120) == jax_bpe.learn_bpe(corpus, 120)
    assert bpe_train.learn_wordpiece(corpus, 150) == \
        jax_bpe.learn_wordpiece(corpus, 150)
    assert bpe_train.learn_wordpiece(corpus, 150, lowercase=False) == \
        jax_bpe.learn_wordpiece(corpus, 150, lowercase=False)
