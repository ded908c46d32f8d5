"""Rematerialization in the port (``nn/remat.py``: GPT-2's
``remat=True``, ResNet's, the train CLI's ``--remat``) against the JAX
package's ``jax.checkpoint`` on the CPU, fp32:

- GPT-2 with remat, dense and MoE, against JAX's remat model: loss rtol
  1e-5, every gradient within 1e-4 of the tensor's largest (the MoE's aux
  flows through the recompute);
- the port's remat against its own plain step with dropout 0.1: loss,
  gradients and the dropout generator's state after the backward
  bitwise (the recompute replays the forward's masks);
- a tiny ResNet with remat against JAX's remat model in training: loss,
  every gradient and the new running statistics within 1e-4 in relative
  L2 norm (test_torch_resnet.py's F32_STEP_RTOL); against the port's
  plain step, gradients and running statistics bitwise (updated once);
- the CLI: ``--remat`` trains GPT-2 and the image configs to the plain
  run's loss, bitwise, and is refused elsewhere in JAX's words."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import ops as jax_ops
from nezha_tpu.cli import train as jax_train_cli
from nezha_tpu.models import resnet as jax_resnet
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.models import GPT2, GPT2Config, ResNet, params_from_jax
from nezha_tpu_torch.models.convert import resnet_from_jax, resnet_to_jax
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.ops.losses import \
    softmax_cross_entropy_with_integer_labels as ce
from nezha_tpu_torch.train import make_train_step

KW = dict(vocab_size=128, max_positions=32, num_layers=2, num_heads=2,
          hidden_size=32)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _tokens():
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, (2, 17)).astype(np.int32)).long()


# -------------------------------------------------------------- GPT-2
@pytest.mark.parametrize("moe", [0, 4])
def test_gpt2_remat_matches_jax_remat(moe):
    jm = JaxGPT2(JaxGPT2Config(**KW, moe_experts=moe, remat=True))
    jv = jm.init(jax.random.PRNGKey(0))
    toks = _tokens().numpy().astype(np.int32)

    def jloss(p):
        out, _ = jm.apply({"params": p, "state": jv["state"]},
                          {"tokens": jnp.asarray(toks)}, training=True)
        return jax_lm_loss(out, {"tokens": jnp.asarray(toks)})

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jv["params"])
    tm = GPT2(GPT2Config(**KW, moe_experts=moe, remat=True), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    tm.train()
    batch = {"tokens": _tokens()}
    loss = lm_loss(tm(batch), batch)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    wg = params_from_jax(_flatten(jgrads))
    for name, p in tm.named_parameters():
        g, w = p.grad.numpy(), wg[name].numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-12, name


@pytest.mark.parametrize("moe", [0, 4])
def test_port_remat_bitwise_with_dropout(moe):
    """Dropout 0.1: the recompute draws the forward's masks again, so the
    loss and every gradient equal the plain model's bitwise; the
    generator ends where the plain run leaves it."""
    runs = []
    for remat in (False, True):
        tm = GPT2(GPT2Config(**KW, dropout=0.1, moe_experts=moe,
                             remat=remat), device="cpu")
        tm.train()
        tm.drop.generator.manual_seed(11)
        batch = {"tokens": _tokens()}
        loss = lm_loss(tm(batch), batch)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     tm.named_parameters()},
                     tm.drop.generator.get_state()))
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name
    assert torch.equal(runs[0][2], runs[1][2])


# ------------------------------------------------------------- ResNet
def _resnet_weights():
    jm = jax_resnet.ResNet((1, 1), num_classes=10, stem="s2d", remat=True)
    jv = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = _flatten(jv["params"])
    for path in params:
        if path.endswith("bn3/scale") or path == "head/w":
            params[path] = (rng.randn(*params[path].shape) * 0.3).astype(
                np.float32)
    return jm, params, _flatten(jv["state"])


def _unflatten(flat):
    out = {}
    for path, val in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return out


def _image_batch():
    rng = np.random.RandomState(3)
    return {"image": rng.rand(4, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, 4).astype(np.int32)}


def _port_step(params, state, remat):
    tm = ResNet((1, 1), num_classes=10, stem="s2d", remat=remat,
                device="cpu")
    tm.load_state_dict(resnet_from_jax(params, state), strict=True)
    step = make_train_step(tm, optim.momentum(0.01, beta=0.9),
                           lambda o, b: ce(o, b["label"]))
    loss, grads = step.loss_and_grads(_image_batch())
    return tm, loss, grads


def test_resnet_remat_matches_jax_and_updates_stats_once():
    jm, params, state = _resnet_weights()
    batch = {k: jnp.asarray(v) for k, v in _image_batch().items()}
    jvars = {"params": _unflatten(params), "state": _unflatten(state)}
    jce = lambda out, b: jax_ops.softmax_cross_entropy_with_integer_labels(
        out, b["label"])

    def jloss(p):
        out, new_state = jm.apply({"params": p, "state": jvars["state"]},
                                  batch, training=True)
        return jce(out, batch), new_state

    (want, jnew), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jvars["params"])
    tm, loss, grads = _port_step(params, state, remat=True)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = resnet_to_jax(grads)[0]
    for path, g in _flatten(jgrads).items():
        assert _rel(got[path], g) <= 1e-4, path
    stats = resnet_to_jax(tm.state_dict())[1]
    for path, s in _flatten(jnew).items():
        assert _rel(stats[path], s) <= 1e-4, path
    # Against the port's plain step: gradients and statistics bitwise.
    plain, ploss, pgrads = _port_step(params, state, remat=False)
    assert torch.equal(loss, ploss)
    for name, g in grads.items():
        assert torch.equal(g, pgrads[name]), name
    for (name, b), (_, pb) in zip(tm.named_buffers(), plain.named_buffers()):
        assert torch.equal(b, pb), name


# ---------------------------------------------------------------- CLI
def _final(argv):
    return train_cli.run(train_cli.parse_args(
        argv + ["--device", "cpu", "--log-every", "0"]))["loss"]


@pytest.mark.parametrize("argv", [
    ["--config", "gpt2_124m", "--seq-len", "32", "--dropout", "0.1"],
    ["--config", "resnet50_imagenet"],
    ["--config", "gpt2_124m", "--seq-len", "32", "--parallel", "gspmd",
     "--mesh", "dp=1,tp=2"]])
def test_cli_remat_trains_to_the_plain_loss(argv):
    base = argv + ["--model-preset", "tiny", "--batch-size", "4",
                   "--steps", "2"]
    assert _final(base + ["--remat"]) == _final(base)


@pytest.mark.parametrize("config", ["mlp_mnist", "bert_base_zero1"])
def test_cli_remat_refusal_is_jax_words(config, capsys):
    argv = ["--config", config, "--remat", "--steps", "1"]
    with pytest.raises(SystemExit) as e:
        jax_train_cli.main(argv)
    want = str(e.value.code)
    assert want and not want.isdigit()
    with pytest.raises(SystemExit) as e:
        train_cli.run(train_cli.parse_args(argv + ["--device", "cpu"]))
    assert want in str(e.value.code) + capsys.readouterr().err
