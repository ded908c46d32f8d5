"""The chunked LM loss in the port (``ops/losses.py``
``chunked_lm_cross_entropy``, ``fused_loss_chunk > 0`` in GPT-2 and
BERT) against the JAX package's on the CPU:

- the loss and the gradients of ``hidden``, ``emb`` and ``bias`` against
  JAX's ``chunked_lm_cross_entropy``, with and without ``ignore_index``
  and the bias, in fp32 (rtol 1e-5; gradients within 1e-5 of each
  tensor's largest) and bf16 (the slices' logits from bf16 operands in
  fp32 on both sides: rtol 1e-4; gradients within 1e-2 of each tensor's
  largest, the bf16 casts of their backward), through the ``S <= chunk``
  dense path
  and the sliced one, and JAX's ValueError on a ragged sequence;
- ``lm_ce_from_fused`` routes ``chunk > 0`` there;
- GPT-2 and BERT train steps at ``fused_loss_chunk=128`` (S=256, two
  slices) against JAX's: the loss (rtol 1e-5), every gradient (within
  1e-4 of the tensor's largest) and the parameters after one momentum
  step (atol 1e-6); the port's chunked step equals its -1 step's loss
  within 1e-5;
- the backward recomputes the slices: no logits are saved between the
  forward and the backward (the -1 path saves the whole ``[B, S, V]``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import optim as jax_optim
from nezha_tpu.models.bert import Bert as JaxBert
from nezha_tpu.models.bert import BertConfig as JaxBertConfig
from nezha_tpu.models.bert import mlm_loss as jax_mlm_loss
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu.ops import losses as jax_losses
from nezha_tpu.train.loop import make_train_step as jax_make_train_step
from nezha_tpu_torch import optim
from nezha_tpu_torch.data import synthetic_mlm_batches
from nezha_tpu_torch.models import (Bert, BertConfig, GPT2, GPT2Config,
                                    bert_from_jax, bert_to_jax,
                                    params_from_jax)
from nezha_tpu_torch.models.bert import mlm_loss
from nezha_tpu_torch.models.convert import params_to_jax
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.ops import losses
from nezha_tpu_torch.train import make_train_step


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _inputs(s, ignore):
    rng = np.random.RandomState(s)
    hidden = rng.randn(2, s, 16).astype(np.float32)
    emb = (rng.randn(40, 16) * 0.3).astype(np.float32)
    bias = (rng.randn(40) * 0.7).astype(np.float32)
    targets = rng.randint(0, 40, (2, s)).astype(np.int32)
    if ignore:
        targets[0, : s // 2] = -100
        targets[1, -3:] = -100
    return hidden, emb, bias, targets


@pytest.mark.parametrize("s,chunk", [(32, 8), (8, 8), (6, 16)],
                         ids=["sliced", "one-slice", "dense"])
@pytest.mark.parametrize("ignore,with_bias", [(False, False), (True, True)],
                         ids=["plain", "ignore+bias"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_ce_value_and_grads_match_jax(s, chunk, ignore, with_bias,
                                              dtype):
    hidden, emb, bias, targets = _inputs(s, ignore)
    ii = -100 if ignore else None
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))

    def jloss(h, e, b):
        return jax_losses.chunked_lm_cross_entropy(
            h.astype(jdt), e, jnp.asarray(targets), chunk=chunk,
            ignore_index=ii, bias=b if with_bias else None)

    want, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(hidden), jnp.asarray(emb), jnp.asarray(bias))
    th, te, tb = (torch.from_numpy(x).requires_grad_()
                  for x in (hidden, emb, bias))
    got = losses.chunked_lm_cross_entropy(
        th.to(tdt), te, torch.from_numpy(targets), chunk=chunk,
        ignore_index=ii, bias=tb if with_bias else None)
    got.backward()
    rtol = 1e-5 if dtype == "f32" else 1e-4
    np.testing.assert_allclose(got.item(), float(want), rtol=rtol)
    for name, t, g in zip(("hidden", "emb", "bias"), (th, te, tb), jgrads):
        g = np.asarray(g, np.float32)
        if not with_bias and name == "bias":
            assert t.grad is None
            continue
        tol = (1e-5 if dtype == "f32" else 1e-2) * float(np.abs(g).max())
        np.testing.assert_allclose(t.grad.float().numpy(), g, rtol=0,
                                   atol=tol + 1e-12, err_msg=name)
    fused = losses.lm_ce_from_fused(
        {"hidden": th.to(tdt), "wte": te, "chunk": chunk,
         **({"bias": tb} if with_bias else {})},
        torch.from_numpy(targets), ignore_index=ii)
    assert fused.item() == got.item()


def test_ragged_sequence_is_jaxs_value_error():
    hidden, emb, _, targets = _inputs(30, False)
    with pytest.raises(ValueError) as want:
        jax_losses.chunked_lm_cross_entropy(
            jnp.asarray(hidden), jnp.asarray(emb), jnp.asarray(targets),
            chunk=8)
    with pytest.raises(ValueError) as got:
        losses.chunked_lm_cross_entropy(
            torch.from_numpy(hidden), torch.from_numpy(emb),
            torch.from_numpy(targets), chunk=8)
    assert str(got.value) == str(want.value)


def test_backward_holds_no_logits():
    """The tensors saved between the forward and the backward are the
    slices' inputs: no logits, neither ``[B, S, V]`` nor a slice's ``[B,
    chunk, V]`` (the backward recomputes them); the dense -1 path saves
    the whole ``[B, S, V]``."""
    hidden, emb, _, targets = _inputs(64, False)
    th = torch.from_numpy(hidden).requires_grad_()

    def saved(fn):
        shapes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
            loss = fn()
        loss.backward()
        return shapes

    args = (th, torch.from_numpy(emb), torch.from_numpy(targets))
    shapes = saved(lambda: losses.chunked_lm_cross_entropy(*args, chunk=8))
    assert shapes and not any(s[-1:] == (40,) and len(s) == 3
                              for s in shapes)
    assert (2, 64, 40) in saved(
        lambda: losses.lm_cross_entropy_from_hidden(*args))


# --------------------------------------------------- the train steps
GPT2_KW = dict(vocab_size=128, max_positions=256, num_layers=2,
               num_heads=2, hidden_size=32)
BERT_KW = dict(vocab_size=128, max_positions=256, num_layers=2,
               num_heads=2, hidden_size=32)


def _check_step(jm, jv, jloss_fn, tm, loss_fn, batch, jbatch, to_jax):
    def jloss(p):
        out, _ = jm.apply({"params": p, "state": jv["state"]}, jbatch,
                          training=True)
        return jloss_fn(out, jbatch)

    jl, jg = jax.value_and_grad(jloss)(jv["params"])
    jopt = jax_optim.momentum(0.1, 0.9)
    jstep = jax_make_train_step(jm, jopt, jloss_fn, donate=False)
    jstate, _ = jstep({"variables": jv, "opt_state": jopt.init(jv["params"]),
                       "rng": jax.random.PRNGKey(1)}, jbatch)
    step = make_train_step(tm, optim.momentum(0.1, 0.9), loss_fn)
    loss, grads = step.loss_and_grads(batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = _flatten(jg)
    for path, g in to_jax(grads).items():
        scale = float(np.abs(want[path]).max())
        np.testing.assert_allclose(g, want[path], rtol=0,
                                   atol=1e-6 + 1e-4 * scale, err_msg=path)
    step.apply_gradients(grads)
    want = _flatten(jstate["variables"]["params"])
    for path, p in to_jax(step.params).items():
        np.testing.assert_allclose(p, want[path], rtol=0, atol=1e-6,
                                   err_msg=path)
    return loss.item()


def test_gpt2_step_at_chunk_128_matches_jax():
    jm = JaxGPT2(JaxGPT2Config(**GPT2_KW, fused_loss_chunk=128))
    jv = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(0).randint(0, 128, (2, 257)).astype(
        np.int32)
    losses_ = []
    for chunk in (128, -1):
        tm = GPT2(GPT2Config(**GPT2_KW, fused_loss_chunk=chunk),
                  device="cpu")
        tm.load_state_dict(params_from_jax(_flatten(jv["params"])),
                           strict=True)
        batch = {"tokens": torch.from_numpy(tokens)}
        if chunk == 128:
            losses_.append(_check_step(
                jm, jv, jax_lm_loss, tm, lm_loss, batch,
                {"tokens": jnp.asarray(tokens)},
                lambda d: params_to_jax({k: v.detach() for k, v in
                                         d.items()})))
        else:
            losses_.append(make_train_step(tm, optim.sgd(0.1), lm_loss)
                           .loss_and_grads(batch)[0].item())
    np.testing.assert_allclose(losses_[0], losses_[1], rtol=1e-5)


def test_bert_step_at_chunk_128_matches_jax():
    jm = JaxBert(JaxBertConfig(**BERT_KW, fused_loss_chunk=128))
    jv = jm.init(jax.random.PRNGKey(0))
    params = _flatten(jv["params"])
    params["mlm_bias"] = (np.random.RandomState(5).randn(128) * 0.5
                          ).astype(np.float32)
    from test_torch_parallel import _unflatten
    jv = {"params": _unflatten(params), "state": jv["state"]}
    batch = dict(next(synthetic_mlm_batches(2, seq_len=256, vocab_size=128,
                                            mask_token=1, seed=3)))
    tm = Bert(BertConfig(**BERT_KW, fused_loss_chunk=128), device="cpu")
    tm.load_state_dict(bert_from_jax(params), strict=True)
    _check_step(jm, jv, jax_mlm_loss, tm, mlm_loss, batch,
                {k: jnp.asarray(v) for k, v in batch.items()},
                lambda d: bert_to_jax({k: v.detach() for k, v in
                                       d.items()}))
