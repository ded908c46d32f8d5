"""BERT in the port against the JAX package on the CPU: the tiny preset
in f32 with JAX's weights carried across by ``bert_from_jax`` (the MLM
bias and the segment ids made random, so both reach the loss), through
flash attention (the port's plain versions, JAX's Pallas kernels in
interpret mode) and composed attention, with a padding mask, with
right-padded ``kv_lengths`` (a zero-length row among them), the fused
MLM head, and ``ln_impl`` "xla" and "pallas"; the fused head's
``ignore_index`` and bias, ``synthetic_mlm_batches``,
``make_attention_mask``, the eval statistics, the converters and the
refused knobs.

Tolerances (those of ``tests/test_torch_train.py``, for the same
reasons: the same f32 formulas summed in other orders):

- logits within 1e-4 (f32 values of order 1 after two layers and the
  tied decoder, as the GPT-2 forward test holds them);
- the MLM loss within 1e-5;
- every gradient element within 1e-6 + 1e-4 of its tensor's largest
  magnitude;
- parameters after one AdamW step within 2 * lr, and within 1e-3 * lr
  where JAX's gradient exceeds 100 * eps (the first update is about
  ``lr * sign(g)``, which a last-bit difference flips where |g| is near
  eps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import optim as jax_optim
from nezha_tpu.cli.train import TINY_BERT_KW as JAX_TINY_BERT_KW
from nezha_tpu.data.synthetic import \
    synthetic_mlm_batches as jax_synthetic_mlm_batches
from nezha_tpu.models.bert import Bert as JaxBert
from nezha_tpu.models.bert import BertConfig as JaxBertConfig
from nezha_tpu.models.bert import bert_base as jax_bert_base
from nezha_tpu.models.bert import mlm_loss as jax_mlm_loss
from nezha_tpu.ops import losses as jax_losses
from nezha_tpu.ops.attention import \
    make_attention_mask as jax_make_attention_mask
from nezha_tpu.train import eval as jax_eval
from nezha_tpu.train.loop import make_train_step as jax_make_train_step
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli.common import TINY_BERT_KW
from nezha_tpu_torch.data import synthetic_mlm_batches
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import (Bert, BertConfig, bert_base,
                                    bert_from_jax, bert_to_jax, mlm_loss)
from nezha_tpu_torch.ops import losses
from nezha_tpu_torch.ops.attention import make_attention_mask
from nezha_tpu_torch.train import (lm_token_stats, make_train_step,
                                   mlm_token_stats)

LR = 1e-4
B, S = 3, 32
LENGTHS = [S, 17, 0]


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val, dtype=np.float32)
    return out


def _unflatten(flat):
    out = {}
    for path, val in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return out


def _batch(extra: str) -> dict:
    """The first tiny-preset MLM batch, random segment ids, and for
    ``extra`` a padding mask or right-padding lengths with the labels
    past each row's end set to -100."""
    batch = dict(next(synthetic_mlm_batches(B, seq_len=S, vocab_size=512,
                                            mask_token=1, seed=3)))
    rng = np.random.RandomState(4)
    batch["segment_ids"] = rng.randint(0, 2, (B, S)).astype(np.int32)
    if extra == "none":
        return batch
    ends = [S, 20, 5] if extra == "padding_mask" else LENGTHS
    real = np.arange(S)[None, :] < np.asarray(ends)[:, None]
    batch["labels"] = np.where(real, batch["labels"], -100).astype(np.int32)
    if extra == "padding_mask":
        batch["padding_mask"] = real
    else:
        batch["kv_lengths"] = np.asarray(ends, np.int32)
    return batch


# name: (model overrides, batch extra); "padding_mask" takes "auto",
# which both sides resolve to composed attention under a mask.
CASES = {"flash": (dict(attn_impl="flash"), "none"),
         "flash-fused-head": (dict(attn_impl="flash", fused_loss_chunk=-1),
                              "none"),
         "xla": (dict(attn_impl="xla"), "none"),
         "padding_mask": (dict(attn_impl="auto"), "padding_mask"),
         "kv_lengths-flash": (dict(attn_impl="flash"), "kv_lengths"),
         "kv_lengths-xla": (dict(attn_impl="xla"), "kv_lengths"),
         "ln-pallas": (dict(attn_impl="flash", ln_impl="pallas"), "none")}


@pytest.fixture(scope="module", params=list(CASES))
def bert_pair(request):
    """JAX's logits, loss, gradients and parameters after one AdamW
    step, and the port's, from the same weights and batch."""
    overrides, extra = CASES[request.param]
    kw = dict(JAX_TINY_BERT_KW, **overrides)
    batch = _batch(extra)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEZHA_LN_INTERPRET", "1")   # JAX's LN kernel on the CPU
        jm = JaxBert(JaxBertConfig(**kw))
        jv = jm.init(jax.random.PRNGKey(0))
        params = _flatten(jv["params"])
        params["mlm_bias"] = (np.random.RandomState(5).randn(512) * 0.5
                              ).astype(np.float32)
        jparams = _unflatten(params)
        jvars = {"params": jparams, "state": jv["state"]}

        def jloss(p):
            out, _ = jm.apply({"params": p, "state": jv["state"]}, jbatch,
                              training=True, rng=jax.random.PRNGKey(1))
            return jax_mlm_loss(out, jbatch)

        jl, jg = jax.value_and_grad(jloss)(jparams)
        jlogits, _ = jm.apply(jvars, jbatch, training=False)
        jopt = jax_optim.adamw(LR, weight_decay=0.01)
        jstep = jax_make_train_step(jm, jopt, jax_mlm_loss, donate=False)
        jstate, _ = jstep({"variables": jvars,
                           "opt_state": jopt.init(jparams),
                           "rng": jax.random.PRNGKey(1)}, jbatch)

    tm = Bert(BertConfig(**kw), device="cpu")
    tm.load_state_dict(bert_from_jax(params), strict=True)
    step = make_train_step(tm, optim.adamw(LR, weight_decay=0.01), mlm_loss)
    loss, grads = step.loss_and_grads(batch)
    tm.eval()
    with torch.no_grad():
        logits = tm({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    step(batch)
    return {"jax_loss": float(jl), "jax_grads": _flatten(jg),
            "jax_logits": np.asarray(jlogits),
            "jax_params": _flatten(jstate["variables"]["params"]),
            "loss": loss.item(), "grads": bert_to_jax(grads),
            "logits": logits.numpy(), "params": bert_to_jax(step.params)}


def test_logits_match_jax(bert_pair):
    np.testing.assert_allclose(bert_pair["logits"], bert_pair["jax_logits"],
                               rtol=0, atol=1e-4)


def test_mlm_loss_matches_jax(bert_pair):
    assert abs(bert_pair["loss"] - bert_pair["jax_loss"]) <= 1e-5


def test_every_gradient_matches_jax(bert_pair):
    want = bert_pair["jax_grads"]
    assert set(bert_pair["grads"]) == set(want)
    for path, g in bert_pair["grads"].items():
        scale = float(np.abs(want[path]).max())
        np.testing.assert_allclose(g, want[path], rtol=0,
                                   atol=1e-6 + 1e-4 * scale, err_msg=path)


def test_params_after_one_adamw_step_match_jax(bert_pair):
    want = bert_pair["jax_params"]
    n_clear = n_all = 0
    for path, p in bert_pair["params"].items():
        diff = np.abs(p - want[path])
        assert diff.max() <= 2 * LR, path
        clear = np.abs(bert_pair["jax_grads"][path]) > 100 * 1e-8
        assert diff[clear].max(initial=0.0) <= 1e-3 * LR, path
        n_clear += int(clear.sum())
        n_all += clear.size
    assert n_clear > 0.5 * n_all


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_head_ignore_index_and_bias_match_jax(dtype):
    """``lm_cross_entropy_from_hidden`` with ``ignore_index`` and a bias,
    and ``lm_ce_from_fused`` carrying both, against JAX's. In bf16 the
    bias is added to the bf16 logits on both sides before the fp32
    logsumexp, so only the fp32 reduction order differs: 1e-5 relative
    (adding it after the upcast moves the bf16 loss by ~1e-3)."""
    rng = np.random.RandomState(6)
    hidden = rng.randn(2, 9, 16).astype(np.float32)
    emb = (rng.randn(40, 16) * 0.3).astype(np.float32)
    bias = (rng.randn(40) * 0.7).astype(np.float32)
    targets = rng.randint(0, 40, (2, 9)).astype(np.int32)
    targets[0, :4] = -100
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_losses.lm_cross_entropy_from_hidden(
        jnp.asarray(hidden, jdt), jnp.asarray(emb), jnp.asarray(targets),
        ignore_index=-100, bias=jnp.asarray(bias))
    th = torch.from_numpy(hidden).to(tdt)
    got = losses.lm_cross_entropy_from_hidden(
        th, torch.from_numpy(emb), torch.from_numpy(targets),
        ignore_index=-100, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    fused = losses.lm_ce_from_fused(
        {"hidden": th, "wte": torch.from_numpy(emb),
         "bias": torch.from_numpy(bias), "chunk": -1},
        torch.from_numpy(targets), ignore_index=-100)
    assert fused.item() == got.item()
    every = torch.full((2, 9), -100)
    assert losses.lm_cross_entropy_from_hidden(
        th, torch.from_numpy(emb), every, ignore_index=-100).item() == 0.0


@pytest.mark.parametrize("kw", [dict(seed=0),
                                dict(seed=1, mask_token=1, vocab_size=512),
                                dict(seed=7, mask_rate=0.5, seq_len=40)])
def test_synthetic_mlm_batches_bitwise_jax(kw):
    kw = dict(dict(seq_len=24), **kw)
    ours = synthetic_mlm_batches(3, **kw)
    theirs = jax_synthetic_mlm_batches(3, **kw)
    for _ in range(6):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys() == {"tokens", "labels", "segment_ids"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_make_attention_mask_matches_jax():
    pm = np.random.RandomState(2).rand(3, 7) < 0.6
    want = np.asarray(jax_make_attention_mask(jnp.asarray(pm)))
    got = make_attention_mask(torch.from_numpy(pm))
    assert got.dtype == torch.float32 and got.shape == (3, 1, 1, 7)
    np.testing.assert_array_equal(got.numpy(), want)


def _stat_inputs():
    rng = np.random.RandomState(8)
    hidden = rng.randn(2, 6, 16).astype(np.float32)
    emb = (rng.randn(30, 16) * 0.3).astype(np.float32)
    bias = (rng.randn(30) * 0.5).astype(np.float32)
    tokens = rng.randint(0, 30, (2, 7)).astype(np.int32)
    labels = np.where(rng.rand(2, 6) < 0.4, tokens[:, :6], -100).astype(
        np.int32)
    return hidden, emb, bias, tokens, labels


@pytest.mark.parametrize("form", ["dense", "fused"])
def test_token_stats_match_jax(form):
    """``lm_token_stats`` (next-token targets of ``tokens``) and
    ``mlm_token_stats`` (labels not -100), on dense logits and on the
    fused-head dict: the NLL sums within 1e-5 relative, the counts
    exact."""
    hidden, emb, bias, tokens, labels = _stat_inputs()
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    for jfn, tfn, with_bias in ((jax_eval.lm_token_stats, lm_token_stats,
                                 False),
                                (jax_eval.mlm_token_stats, mlm_token_stats,
                                 True)):
        b = bias if with_bias else np.zeros_like(bias)
        if form == "dense":
            logits = hidden @ emb.T + b
            want = jfn(jnp.asarray(logits), jb)
            got = tfn(torch.from_numpy(logits), tb)
        else:
            jout = {"hidden": jnp.asarray(hidden), "wte": jnp.asarray(emb),
                    "chunk": -1}
            tout = {"hidden": torch.from_numpy(hidden),
                    "wte": torch.from_numpy(emb), "chunk": -1}
            if with_bias:
                jout["bias"] = jnp.asarray(b)
                tout["bias"] = torch.from_numpy(b)
            want, got = jfn(jout, jb), tfn(tout, tb)
        assert int(got["count"]) == int(want["count"])
        np.testing.assert_allclose(float(got["nll_sum"]),
                                   float(want["nll_sum"]), rtol=1e-5)


def test_convert_round_trip_and_names():
    jv = JaxBert(JaxBertConfig(**JAX_TINY_BERT_KW)).init(
        jax.random.PRNGKey(2))
    params = _flatten(jv["params"])
    tm = Bert(BertConfig(**TINY_BERT_KW), device="cpu")
    tm.load_state_dict(bert_from_jax(params), strict=True)
    back = bert_to_jax(tm.state_dict())
    assert back.keys() == params.keys()
    for path, arr in params.items():
        np.testing.assert_array_equal(back[path], arr)
    assert tm.state_dict()["layers.1.qkv.w"].shape == (64, 192)


def test_bert_base_structure_matches_jax():
    """BERT-base's parameter names and shapes against ``jax.eval_shape``
    of JAX's init (no JAX compute), and its 109.51 M parameters."""
    shapes = jax.eval_shape(jax_bert_base().init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _flat_shapes(shapes["params"])}
    tm = bert_base(device="cpu")
    got = {k: tuple(v.shape) for k, v in bert_to_jax(
        tm.state_dict()).items()}
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == 109_514_298
    assert tm.tok_emb.embedding.dtype == torch.float32   # fp32 masters
    assert tm.policy.compute_dtype == torch.bfloat16


def _flat_shapes(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_shapes(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


@pytest.mark.parametrize("knob", [{"scan_layers": True},
                                  {"attn_impl": "flash_shmap"},
                                  {"fused_loss_chunk": 1},
                                  {"fused_loss_chunk": 128}])
def test_unported_knobs_raise(knob):
    """The knobs still refused; ``flash_shmap`` is ported and builds, and
    raises JAX's ValueError outside a tensor-parallel scope
    (``tests/test_torch_gspmd.py`` runs it inside one); ``fused_loss_chunk``
    1 and 128 are ported: they build and train, the MLM loss of the
    chunked slices equal to the -1 path's (tests/test_torch_chunked_loss.py
    holds them to JAX's); ``scan_layers`` is ported: it builds, and its
    MLM loss equals the unrolled encoder's bitwise
    (tests/test_torch_scan.py holds it to JAX's)."""
    if knob.get("scan_layers"):
        batch = {k: torch.from_numpy(v) for k, v in _batch("none").items()}
        got = [mlm_loss(Bert(BertConfig(**TINY_BERT_KW, **kw),
                             device="cpu")(batch), batch)
               for kw in (knob, {})]
        assert torch.equal(got[0], got[1])
        return
    if "fused_loss_chunk" in knob:
        batch = {k: torch.from_numpy(v) for k, v in _batch("none").items()}
        got = []
        for chunk in (knob["fused_loss_chunk"], -1):
            model = Bert(BertConfig(**TINY_BERT_KW, fused_loss_chunk=chunk),
                         device="cpu")
            loss = mlm_loss(model(batch), batch)
            loss.backward()
            got.append(loss.item())
        np.testing.assert_allclose(got[0], got[1], rtol=1e-5)
        return
    if knob.get("attn_impl") == "flash_shmap":
        model = Bert(BertConfig(**TINY_BERT_KW, **knob), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch("none").items()}
        with pytest.raises(ValueError, match="auto_partitioner_scope") as e:
            model(batch)
        assert not isinstance(e.value, NotPortedError)
        return
    with pytest.raises(NotPortedError):
        Bert(BertConfig(**TINY_BERT_KW, **knob), device="cpu")


def test_bad_batches_raise():
    batch = {k: torch.from_numpy(v) for k, v in _batch("none").items()}
    pm = torch.ones(B, S, dtype=torch.bool)
    lens = torch.tensor(LENGTHS)
    for kw, extra in ((dict(attn_impl="flash"), {"padding_mask": pm}),
                      (dict(), {"padding_mask": pm, "kv_lengths": lens})):
        with pytest.raises(ValueError):
            Bert(BertConfig(**TINY_BERT_KW, **kw), device="cpu")(
                {**batch, **extra})
    long = torch.zeros(1, 97, dtype=torch.long)
    with pytest.raises(ValueError, match="max_positions"):
        Bert(BertConfig(**TINY_BERT_KW), device="cpu")({"tokens": long})


def test_fused_head_only_in_training():
    tm = Bert(BertConfig(**TINY_BERT_KW, fused_loss_chunk=-1), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch("none").items()}
    out = tm(batch)
    assert set(out) == {"hidden", "wte", "bias", "chunk"}
    assert out["bias"] is tm.mlm_bias
    tm.eval()
    logits = tm(batch)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, 512)
    eval_loss = mlm_loss(logits, batch).item()
    tm.train()
    assert abs(mlm_loss(tm(batch), batch).item() - eval_loss) <= 1e-5


def test_builds_on_the_card_unless_asked():
    """Without a device or generator the model builds on the card
    (resolved, not built, where there is none)."""
    assert Bert(BertConfig(**TINY_BERT_KW), generator=torch.Generator()
                ).tok_emb.embedding.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Bert(BertConfig(**TINY_BERT_KW))
