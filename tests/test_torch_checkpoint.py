"""Checkpoint interop with the JAX package (``nezha_tpu_torch/train/
checkpoint.py`` and the train-state mapping of ``models/convert.py``).

(a) A JAX ``Trainer`` writes tiny GPT-2, BERT and ResNet checkpoints; the
port restores every leaf bitwise, trains two more steps on the same
batches and matches JAX's own continuation: losses within 1e-5 (GPT-2,
BERT; the tolerance of ``tests/test_torch_train.py``) or F32_STEP_RTOL
relative (ResNet, ``tests/test_torch_resnet.py``'s), and weights within
2 lr a step (AdamW's first moves are ~lr sign(g), which a rounding can
flip where |g| is near eps; momentum moves lr v).
(b) The port writes, and JAX's ``verify_checkpoint`` passes and its
``restore_checkpoint`` reads every leaf back equal through JAX's own
template.
(c) A flipped byte raises ``CheckpointCorrupt``, a truncated head falls
back one step, a stray ``.tmp`` is ignored, ``keep_last`` prunes.
(d) A ResNet's momentum ``velocity`` goes through HWIO as its weights do.
Everything here runs fp32 with dropout 0.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from nezha_tpu import ops as jax_ops
from nezha_tpu import optim as jax_optim
from nezha_tpu.cli.train import TINY_BERT_KW, TINY_GPT2_KW
from nezha_tpu.models import resnet as jax_resnet
from nezha_tpu.models.bert import Bert as JaxBert
from nezha_tpu.models.bert import BertConfig as JaxBertConfig
from nezha_tpu.models.bert import mlm_loss as jax_mlm_loss
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu.train import checkpoint as jax_ckpt
from nezha_tpu.train.loop import Trainer as JaxTrainer
from nezha_tpu.train.loop import init_train_state
from nezha_tpu_torch import optim
from nezha_tpu_torch.models import GPT2, GPT2Config, ResNet, lm_loss
from nezha_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
from nezha_tpu_torch.models.convert import (jax_leaf_names,
                                            load_train_state,
                                            train_state_template,
                                            train_state_to_jax)
from nezha_tpu_torch.ops.losses import \
    softmax_cross_entropy_with_integer_labels
from nezha_tpu_torch.train import checkpoint as ckpt
from nezha_tpu_torch.train.loop import Trainer, dropout_seed, prng_key

GPT_LR, BERT_LR, RN_LR = 6e-4, 1e-4, 0.1
F32_STEP_RTOL = 1e-4
SAVED, MORE = 2, 2


def _gpt2_batches(n):
    r = np.random.RandomState(3)
    return [{"tokens": r.randint(0, 512, (2, 33)).astype(np.int32)}
            for _ in range(n)]


def _bert_batches(n):
    r = np.random.RandomState(4)
    out = []
    for _ in range(n):
        tokens = r.randint(2, 512, (2, 32)).astype(np.int32)
        labels = np.where(r.rand(2, 32) < 0.3, tokens, -100).astype(np.int32)
        masked = np.where(labels >= 0, 1, tokens).astype(np.int32)
        out.append({"tokens": masked, "labels": labels,
                    "segment_ids": np.zeros_like(tokens)})
    return out


def _image_batches(n):
    r = np.random.RandomState(5)
    return [{"image": r.rand(4, 32, 32, 3).astype(np.float32),
             "label": r.randint(0, 10, 4).astype(np.int32)}
            for _ in range(n)]


def _jax_image_ce(logits, b):
    return jax_ops.softmax_cross_entropy_with_integer_labels(logits,
                                                             b["label"])


def _image_ce(logits, b):
    return softmax_cross_entropy_with_integer_labels(logits, b["label"])


CASES = {
    "gpt2": dict(
        jax_model=lambda: JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW)),
        jax_opt=lambda: jax_optim.adamw(GPT_LR, weight_decay=0.1),
        jax_loss=jax_lm_loss,
        model=lambda: GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu"),
        opt=lambda: optim.adamw(GPT_LR, weight_decay=0.1), loss=lm_loss,
        batches=_gpt2_batches, lr=GPT_LR, loss_rtol=0, loss_atol=1e-5),
    "bert": dict(
        jax_model=lambda: JaxBert(JaxBertConfig(**TINY_BERT_KW)),
        jax_opt=lambda: jax_optim.adamw(BERT_LR, weight_decay=0.01),
        jax_loss=jax_mlm_loss,
        model=lambda: Bert(BertConfig(**TINY_BERT_KW), device="cpu"),
        opt=lambda: optim.adamw(BERT_LR, weight_decay=0.01), loss=mlm_loss,
        batches=_bert_batches, lr=BERT_LR, loss_rtol=0, loss_atol=1e-5),
    "resnet": dict(
        jax_model=lambda: jax_resnet.ResNet((1, 1), num_classes=10),
        jax_opt=lambda: jax_optim.momentum(RN_LR, beta=0.9,
                                           weight_decay=1e-4),
        jax_loss=_jax_image_ce,
        model=lambda: ResNet((1, 1), num_classes=10, device="cpu"),
        opt=lambda: optim.momentum(RN_LR, beta=0.9, weight_decay=1e-4),
        loss=_image_ce, batches=_image_batches, lr=RN_LR,
        loss_rtol=F32_STEP_RTOL, loss_atol=0),
}


def _jax_run(case, d):
    """JAX trains SAVED steps (checkpointing at SAVED), then MORE."""
    c = CASES[case]
    batches = c["batches"](SAVED + MORE)
    tr = JaxTrainer(c["jax_model"](), c["jax_opt"](), c["jax_loss"],
                    rng=jax.random.PRNGKey(7), checkpoint_dir=str(d),
                    checkpoint_every=SAVED, log_every=1)
    losses = []
    tr.metric_logger = lambda step, m: losses.append(m["loss"])
    tr.fit(iter(batches), SAVED + MORE)
    # Keep the checkpoint at SAVED only: the port resumes from there.
    for step in jax_ckpt.checkpoint_steps(str(d)):
        if step != SAVED:
            os.unlink(ckpt.checkpoint_path(str(d), step))
    params = {k: np.asarray(v) for k, v in jax_ckpt._flatten(
        jax.device_get(tr.state["variables"]["params"])).items()}
    return batches, losses[SAVED:], params


@pytest.fixture(scope="module", params=list(CASES))
def jax_written(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"jax_{request.param}")
    batches, losses, params = _jax_run(request.param, d)
    return request.param, d, batches, losses, params


def test_jax_checkpoint_restores_bitwise_and_continues(jax_written):
    case, d, batches, jax_losses, jax_params = jax_written
    c = CASES[case]
    saved = jax_ckpt.verify_checkpoint(str(d), SAVED)
    trainer = Trainer(c["model"](), c["opt"](), c["loss"],
                      checkpoint_dir=str(d), log_every=1)
    assert trainer.initialize() == SAVED
    mine = trainer.state_dict()
    assert set(mine) == set(saved)
    for key, want in saved.items():
        assert mine[key].dtype == want.dtype, key
        np.testing.assert_array_equal(mine[key], want, err_msg=key)
    losses = []
    trainer.metric_logger = lambda step, m: losses.append(m["loss"])
    trainer.fit(iter(batches[SAVED:]), MORE)
    np.testing.assert_allclose(losses, jax_losses, rtol=c["loss_rtol"],
                               atol=c["loss_atol"])
    got = {k[len("variables/params/"):]: v
           for k, v in trainer.state_dict().items()
           if k.startswith("variables/params/")}
    assert set(got) == set(jax_params)
    for path, want in jax_params.items():
        assert np.abs(got[path] - want).max() <= 2 * c["lr"] * MORE, path


@pytest.mark.parametrize("case", list(CASES))
def test_port_checkpoint_verifies_and_restores_in_jax(case, tmp_path):
    c = CASES[case]
    trainer = Trainer(c["model"](), c["opt"](), c["loss"],
                      rng=prng_key(5), checkpoint_dir=str(tmp_path),
                      checkpoint_every=SAVED)
    trainer.fit(iter(c["batches"](SAVED)), SAVED)
    flat = jax_ckpt.verify_checkpoint(str(tmp_path), SAVED)
    mine = trainer.state_dict()
    jm, jopt = c["jax_model"](), c["jax_opt"]()
    template = init_train_state(jm, jopt, jax.random.PRNGKey(0))
    restored, step = jax_ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == SAVED
    back = jax_ckpt._flatten(jax.device_get(restored))
    assert set(back) == set(flat) == set(mine)
    for key, want in mine.items():
        assert back[key].dtype == want.dtype, key
        np.testing.assert_array_equal(back[key], want, err_msg=key)
    assert int(back["opt_state/step"]) == SAVED
    np.testing.assert_array_equal(back["rng"],
                                  np.asarray(jax.random.PRNGKey(5)))


def _tiny_trainer(d, **kw):
    return Trainer(GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu"),
                   optim.adamw(GPT_LR), lm_loss, checkpoint_dir=str(d), **kw)


def test_corrupt_truncated_stray_tmp_and_pruning(tmp_path, capsys):
    tr = _tiny_trainer(tmp_path, checkpoint_every=1)
    tr.fit(iter(_gpt2_batches(3)), 3)
    assert ckpt.checkpoint_steps(str(tmp_path)) == [1, 2, 3]
    (tmp_path / "junk123.tmp").write_bytes(b"half a save")
    # A flipped byte inside a leaf: CRC32 (or the zip's own check) fails.
    p2 = ckpt.checkpoint_path(str(tmp_path), 2)
    raw = bytearray(p2.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p2.write_bytes(bytes(raw))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.verify_checkpoint(str(tmp_path), 2)
    # A truncated head: try_restore falls back past it, noting each.
    p3 = ckpt.checkpoint_path(str(tmp_path), 3)
    p3.write_bytes(p3.read_bytes()[:1000])
    template = train_state_template(tr.model, tr.step_fn.opt_state)
    flat, step = ckpt.try_restore(str(tmp_path), template)
    assert step == 1 and flat is not None
    err = capsys.readouterr().err
    assert "step 3" in err and "step 2" in err
    assert jax_ckpt.latest_step(str(tmp_path)) == 3   # JAX sees the same
    fresh = _tiny_trainer(tmp_path)
    assert fresh.initialize() == 1
    # keep_last prunes to the newest N once the new save is in place.
    fresh.checkpoint_keep = 2
    fresh.save(4)
    assert ckpt.checkpoint_steps(str(tmp_path)) == [3, 4]
    assert (tmp_path / "junk123.tmp").exists()


def test_manifest_and_key_order_match_jax(tmp_path):
    tr = _tiny_trainer(tmp_path / "port")
    tr.save(1)
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW))
    jopt = jax_optim.adamw(GPT_LR)
    state = init_train_state(jm, jopt, jax.random.PRNGKey(0))
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), state, 1)
    keys = ckpt.checkpoint_keys(str(tmp_path / "port"), 1)
    assert keys == ckpt.checkpoint_keys(str(tmp_path / "jax"), 1)
    assert keys[-1] == ckpt.MANIFEST_KEY
    assert "opt_state/step" in keys and "rng" in keys
    assert not any(k.startswith("variables/state/") for k in keys)


def test_resnet_velocity_goes_through_hwio(tmp_path):
    model = ResNet((1, 1), num_classes=10, device="cpu")
    opt = optim.momentum(RN_LR)
    state = opt.init(dict(model.named_parameters()))
    g = torch.Generator().manual_seed(0)
    for name in state["velocity"]:
        state["velocity"][name] = torch.randn(
            state["velocity"][name].shape, generator=g)
    flat = train_state_to_jax(model, state, prng_key(0))
    names = jax_leaf_names(model)
    conv = [n for n, (_, is_conv) in names.items() if is_conv]
    assert conv and all(model.state_dict()[n].dim() == 4 for n in conv)
    for n in conv:
        key = names[n][0][len("params/"):]
        w, v = flat["variables/params/" + key], flat[
            "opt_state/velocity/" + key]
        assert w.shape == v.shape == tuple(
            model.state_dict()[n].permute(2, 3, 1, 0).shape)
        np.testing.assert_array_equal(
            v, state["velocity"][n].permute(2, 3, 1, 0).numpy())
    bn = [k for k in flat if k.startswith("variables/state/")]
    assert bn and all(k.endswith(("/mean", "/var")) for k in bn)
    assert not any("/mean" in k or "/var" in k for k in flat
                   if k.startswith(("variables/params/", "opt_state/")))
    other = ResNet((1, 1), num_classes=10, device="cpu",
                   generator=torch.Generator().manual_seed(9))
    back = load_train_state(flat, other, opt.init(
        dict(other.named_parameters())))
    for n, v in state["velocity"].items():
        assert torch.equal(back["velocity"][n], v), n
    for n, t in model.state_dict().items():
        assert torch.equal(other.state_dict()[n], t), n


def test_shape_mismatch_and_missing_leaf_are_refused(tmp_path):
    tr = _tiny_trainer(tmp_path)
    tr.save(1)
    other = GPT2(GPT2Config(**{**TINY_GPT2_KW, "max_positions": 64}),
                 device="cpu")
    flat, _ = ckpt.restore_checkpoint(str(tmp_path),
                                      train_state_template(other))
    with pytest.raises(ValueError, match="wpe"):
        load_train_state(flat, other)
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(str(tmp_path), {"variables/params/nope":
                                                np.float32})


def test_dropout_masks_follow_key_and_step():
    assert dropout_seed(prng_key(0), 3) == dropout_seed(prng_key(0), 3)
    assert dropout_seed(prng_key(0), 3) != dropout_seed(prng_key(0), 4)
    assert dropout_seed(prng_key(0), 3) != dropout_seed(prng_key(1), 3)
    np.testing.assert_array_equal(prng_key(7),
                                  np.asarray(jax.random.PRNGKey(7)))


def test_resume_with_dropout_equals_unbroken_run(tmp_path):
    """2 + 2 resumed steps equal 4 straight ones bitwise, dropout on."""
    kw = dict(TINY_GPT2_KW, dropout=0.1)
    batches = _gpt2_batches(4)

    def trainer(d):
        return Trainer(GPT2(GPT2Config(**kw), device="cpu"),
                       optim.adamw(GPT_LR), lm_loss, rng=prng_key(3),
                       checkpoint_dir=str(d), checkpoint_every=2)

    straight = trainer(tmp_path / "a")
    straight.fit(iter(batches), 4)
    first = trainer(tmp_path / "b")
    first.fit(iter(batches[:2]), 2)
    shutil.rmtree(tmp_path / "a")
    second = trainer(tmp_path / "b")
    assert second.initialize() == 2
    second.fit(iter(batches[2:]), 2)
    for n, t in straight.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[n], t), n
    assert os.path.exists(ckpt.checkpoint_path(str(tmp_path / "b"), 4))
