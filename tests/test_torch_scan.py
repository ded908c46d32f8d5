"""The layer-stacked trunk (``--scan-layers``: ``nn/scan.py``, GPT-2's
``h_scan``, BERT's ``layers_scan``) on the CPU at the tiny presets:

- against the port's unrolled models on the same weights, bitwise: the
  loss and every gradient (dropout on, so the masks are the unrolled
  trunk's; with and without ``remat``), and AdamW steps through the
  ``Trainer``;
- against JAX's scan models on the same weights: the logits (1e-5
  relative, 1e-6 absolute, the train test's forward tolerance) and the
  loss's gradients (1e-5 / 1e-6);
- ``stack``/``unstack`` bitwise in both directions, against JAX's
  ``stack_layer_params``/``unstack_layer_params`` and over flat
  checkpoint keys;
- the decode path (a dense cache, one layer's slice at a time): greedy
  tokens equal to the unrolled model's, and a scan model's self-draft.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nezha_tpu.models import bert as jbert
from nezha_tpu.models import gpt2 as jgpt2
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli.common import TINY_BERT_KW, TINY_GPT2_KW
from nezha_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
from nezha_tpu_torch.models.convert import params_from_jax, params_to_jax
from nezha_tpu_torch.models.generate import generate
from nezha_tpu_torch.models.gpt2 import (GPT2, GPT2Config, lm_loss,
                                         stack_layer_params,
                                         unstack_layer_params)
from nezha_tpu_torch.nn.scan import (stack_flat_keys, stack_prefixed_params,
                                     unstack_flat_keys,
                                     unstack_prefixed_params)
from nezha_tpu_torch.train import Trainer

L = TINY_GPT2_KW["num_layers"]


def _gpt2(**kw):
    gen = torch.Generator()
    gen.manual_seed(0)
    return GPT2(GPT2Config(**TINY_GPT2_KW, **kw), generator=gen,
                device="cpu")


def _bert(**kw):
    gen = torch.Generator()
    gen.manual_seed(0)
    return Bert(BertConfig(**TINY_BERT_KW, **kw), generator=gen,
                device="cpu")


def _tokens(b=2, s=17, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, (b, s)))


def _stacked_grad(model, name, i, prefix):
    return model.get_parameter(f"{prefix}.{name}").grad[i]


def _grads_equal(scan, unrolled, trunk, stacked):
    for i, layer in enumerate(getattr(unrolled, trunk)):
        for name, p in layer.named_parameters():
            assert torch.equal(_stacked_grad(scan, name, i, stacked),
                               p.grad), (i, name)
    for name, p in unrolled.named_parameters():
        if not name.startswith(f"{trunk}."):
            assert torch.equal(scan.get_parameter(name).grad, p.grad), name


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_gpt2_scan_equals_unrolled_bitwise(dropout, remat):
    """The same draws (the scan trunk is built from the unrolled blocks,
    then stacked), the same dropout masks (one stream, layer order), the
    same loss and gradients, bit for bit."""
    u, s = (_gpt2(dropout=dropout, remat=remat, scan_layers=scan)
            for scan in (False, True))
    for i in range(L):
        for name, p in u.h[i].named_parameters():
            assert torch.equal(s.h_scan.get_parameter(name)[i], p)
    batch = {"tokens": _tokens()}
    losses = []
    for m in (u, s):
        m.train()
        m.drop.generator.manual_seed(5)
        loss = lm_loss(m(batch), batch)
        loss.backward()
        losses.append(loss)
    assert torch.equal(losses[0], losses[1])
    _grads_equal(s, u, "h", "h_scan")


def test_bert_scan_equals_unrolled_bitwise():
    from nezha_tpu.data import synthetic_mlm_batches
    b = next(synthetic_mlm_batches(2, seq_len=32, vocab_size=512,
                                   mask_token=1))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    u, s = (_bert(dropout=0.1, scan_layers=scan) for scan in (False, True))
    assert "layers_scan.qkv.w" in s.state_dict()
    losses = []
    for m in (u, s):
        m.train()
        m.drop.generator.manual_seed(3)
        loss = mlm_loss(m(batch), batch)
        loss.backward()
        losses.append(loss)
    assert torch.equal(losses[0], losses[1])
    _grads_equal(s, u, "layers", "layers_scan")


def test_scan_trains_as_unrolled_through_the_trainer():
    """Three AdamW steps through the Trainer: the same losses and the
    same weights, the stacked ones leaf for leaf."""
    def run(scan):
        m = _gpt2(scan_layers=scan)
        tr = Trainer(m, optim.adamw(1e-3, weight_decay=0.1), lm_loss,
                     log_every=0)
        batches = iter([{"tokens": _tokens(s=33, seed=k)} for k in range(3)])
        losses = [float(tr.step_fn(next(batches))["loss"])
                  for _ in range(3)]
        return m, losses

    u, lu = run(False)
    s, ls = run(True)
    assert lu == ls
    flat_u = params_to_jax(u.state_dict())
    flat_s = params_to_jax(s.state_dict())
    assert stack_flat_keys(flat_u, "h", L, "h_scan").keys() == flat_s.keys()
    for k, v in stack_flat_keys(flat_u, "h", L, "h_scan").items():
        assert np.array_equal(v, flat_s[k]), k


def _jax_nested(flat):
    out = {}
    for key, val in flat.items():
        node = out
        *heads, leaf = key.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(val)
    return out


def test_gpt2_scan_matches_jax_scan_model():
    """JAX's scan GPT-2 (its init) loaded into the port's scan model:
    JAX's logits, and the loss's gradients on the stacked leaves."""
    kw = dict(TINY_GPT2_KW, attn_impl="xla", scan_layers=True)
    jm = jgpt2.GPT2(jgpt2.GPT2Config(**kw))
    jv = jm.init(jax.random.PRNGKey(0))
    assert "h_scan" in jv["params"]
    tm = GPT2(GPT2Config(**kw), device="cpu")
    flat = params_to_jax(tm.state_dict())
    jflat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                jflat[f"{pre}{k}"] = np.asarray(v)
    walk(jv["params"])
    assert flat.keys() == jflat.keys()
    tm.load_state_dict(params_from_jax(jflat), strict=True)
    tokens = _tokens()
    jlogits, _ = jm.apply(jv, jnp.asarray(tokens.numpy(), jnp.int32))
    np.testing.assert_allclose(tm(tokens).detach().numpy(),
                               np.asarray(jlogits), rtol=1e-5, atol=1e-6)
    batch = {"tokens": _tokens(s=33, seed=2)}
    jb = {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)}
    jg = jax.grad(lambda p: jgpt2.lm_loss(
        jm.apply({"params": p, "state": {}}, jb)[0], jb))(jv["params"])
    loss = lm_loss(tm(batch), batch)
    loss.backward()
    np.testing.assert_allclose(
        tm.h_scan.attn.qkv.w.grad.numpy(),
        np.asarray(jg["h_scan"]["attn"]["qkv"]["w"]), rtol=1e-5, atol=1e-6)


def test_bert_scan_matches_jax_scan_model():
    kw = dict(TINY_BERT_KW, attn_impl="xla", scan_layers=True)
    jm = jbert.Bert(jbert.BertConfig(**kw))
    jv = jm.init(jax.random.PRNGKey(0))
    assert "layers_scan" in jv["params"]
    tm = Bert(BertConfig(**kw), device="cpu")
    jflat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                jflat[f"{pre}{k}"] = np.asarray(v)
    walk(jv["params"])
    tm.load_state_dict(params_from_jax(jflat), strict=True)
    from nezha_tpu.data import synthetic_mlm_batches
    b = next(synthetic_mlm_batches(2, seq_len=32, vocab_size=512,
                                   mask_token=1))
    jlogits, _ = jm.apply(jv, {k: jnp.asarray(v) for k, v in b.items()})
    got = tm({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)


def test_stack_and_unstack_bitwise_against_jax():
    """The unrolled tree <-> the scan tree, both directions, equal to
    JAX's converters bit for bit; over torch tensors, numpy arrays and
    flat checkpoint keys alike."""
    tm = _gpt2()
    flat = params_to_jax(tm.state_dict())
    nested = _jax_nested(flat)
    np_nested = jax.tree_util.tree_map(np.asarray, nested)
    jstacked = jgpt2.stack_layer_params(nested, L)
    stacked = stack_layer_params(np_nested, L)
    assert jax.tree_util.tree_structure(jstacked) == \
        jax.tree_util.tree_structure(stacked)
    for a, b in zip(jax.tree_util.tree_leaves(jstacked),
                    jax.tree_util.tree_leaves(stacked)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    back = unstack_layer_params(stacked, L)
    jback = jgpt2.unstack_layer_params(jstacked, L)
    for a, b, c in zip(jax.tree_util.tree_leaves(np_nested),
                       jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(jback)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes() \
            == np.asarray(c).tobytes()
    # Tensors, and the flat keys a checkpoint holds.
    tstack = stack_prefixed_params(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), np_nested), "h", L,
        "h_scan")
    assert torch.equal(tstack["h_scan"]["attn"]["qkv"]["w"],
                       torch.from_numpy(stacked["h_scan"]["attn"]["qkv"]
                                        ["w"]))
    assert unstack_prefixed_params(tstack, "h", L, "h_scan").keys() == \
        np_nested.keys()
    fk = {f"variables/params/{k}": v for k, v in flat.items()}
    sk = stack_flat_keys(fk, "h", L, "h_scan")
    assert np.array_equal(sk["variables/params/h_scan/attn/qkv/w"],
                          np.asarray(jstacked["h_scan"]["attn"]["qkv"]["w"]))
    un = unstack_flat_keys(sk, "h", L, "h_scan")
    assert un.keys() == fk.keys() and all(
        np.array_equal(un[k], fk[k]) for k in fk)
    scan = _gpt2(scan_layers=True)
    assert params_to_jax(scan.state_dict()).keys() == {
        k[len("variables/params/"):] for k in sk}


def test_scan_decode_equals_unrolled():
    """Greedy decode through a dense cache: the scan model slices its
    stack a layer at a time, the tokens the unrolled model's; a scan
    model's self-draft truncates the stack to views of its tensors."""
    from nezha_tpu_torch.serve.engine import self_draft

    u, s = (_gpt2(scan_layers=scan) for scan in (False, True))
    for m in (u, s):
        m.eval()
    prompt = _tokens(b=2, s=5)
    want = generate(u, prompt, 6, cache_dtype=torch.float32)
    got = generate(s, prompt, 6, cache_dtype=torch.float32)
    assert torch.equal(want, got)
    d = self_draft(s, 2)
    assert d.h_scan.attn.qkv.w.shape[0] == 2 == d.cfg.num_layers
    assert d.h_scan.attn.qkv.w.data_ptr() == s.h_scan.attn.qkv.w.data_ptr()
    assert s.h_scan.attn.qkv.w.shape[0] == L
    du = self_draft(u, 2)
    with torch.no_grad():
        assert torch.equal(du(prompt), d(prompt))
