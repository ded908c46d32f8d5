"""The port's image training path against the JAX package on the CPU:
``Conv2d``, ``BatchNorm``, the pools, the s2d stem, a tiny ResNet's
forward and its momentum train step, the CE options, the synthetic image
batches, the ResNet structure at full depth and the CLI's image configs.
Weights carry across with ``models.convert.resnet_from_jax``.

Tolerances (f32 aims at 1e-5):

- layers in f32: both sides run the same products and sums in other
  orders (XLA's conv against oneDNN's), 1e-5 absolute on outputs of
  order 1;
- BatchNorm in bf16: the output is rounded to bf16 once on one side and
  twice (multiply, then add) at most on the other, so two bf16 ulps of
  the output's scale, 2^-7 relative; statistics are fp32 of the same
  bf16 input, 1e-5;
- the train step in f32: loss within 1e-5; each gradient, each weight's
  change over the steps and each running statistic within 1e-4 of its
  tensor's norm (a gradient is a sum over the batch of products whose
  order differs, so its error scales with its norm);
- the train step under the bf16 policy: every activation is rounded to
  bf16 on both sides at other points (XLA may keep an elementwise chain
  in fp32), so the train check's 3% for the loss and each running
  statistic (relative to its norm). The gradients cannot be held to 3%
  of each other: BatchNorm's backward subtracts the parts of the
  incoming gradient that its batch mean and variance explain, and what
  is left is small against bf16's rounding of it, so JAX's own bf16
  gradients of this net lie 10-30% of their norm from its f32 ones
  (measured on this net before this tolerance was set), and two bf16
  runs that round at other points differ by as much. Each bf16
  gradient (and weight change) of the port is held instead to lie as
  close to the exact gradient — JAX's f32 — as JAX's own bf16 one
  does: within twice JAX's distance, or 3% where that is less.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import nn as jnn
from nezha_tpu import ops as jax_ops
from nezha_tpu import optim as jax_optim
from nezha_tpu.data.synthetic import \
    synthetic_image_batches as jax_synthetic_image_batches
from nezha_tpu.models import resnet as jax_resnet
from nezha_tpu.tensor import bf16_policy as jax_bf16_policy
from nezha_tpu.train.eval import evaluate as jax_evaluate
from nezha_tpu.train.loop import make_train_step as jax_make_train_step
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli.common import TINY_BERT_KW
from nezha_tpu_torch.data import synthetic_image_batches
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import (Bert, BertConfig, ResNet, resnet50,
                                    resnet_from_jax, resnet_to_jax,
                                    wide_resnet101)
from nezha_tpu_torch.models.resnet import _space_to_depth_stem
from nezha_tpu_torch.nn import (BatchNorm, Conv2d, avg_pool,
                                global_avg_pool, max_pool)
from nezha_tpu_torch.nn.layers import same_pads
from nezha_tpu_torch.ops.losses import \
    softmax_cross_entropy_with_integer_labels
from nezha_tpu_torch.tensor.policy import bf16_policy
from nezha_tpu_torch.train import Trainer, evaluate, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-5
F32_STEP_RTOL = 1e-4
BF16_RTOL = 0.03
LR = 0.1


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val, dtype=np.float32)
    return out


def _flat_paths(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_paths(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW channels_last tensor."""
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("size", [32, 33], ids=["even", "odd"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [1, 3, 7])
def test_conv2d_same_matches_jax(kernel, stride, size):
    """SAME padding as XLA splits it: at stride 2 on even sizes the sides
    differ (k=3: (0, 1); k=7: (2, 3)), which symmetric padding gets
    wrong with the right output shape."""
    rng = np.random.RandomState(kernel * 10 + stride)
    jc = jnn.Conv2d(5, 6, kernel, stride=stride, use_bias=False)
    jv = jc.init(jax.random.PRNGKey(0))
    x = rng.randn(2, size, size, 5).astype(np.float32)
    want, _ = jc.apply(jv, jnp.asarray(x))
    tc = Conv2d(5, 6, kernel, stride=stride, use_bias=False, device="cpu")
    tc.load_state_dict({"weight": resnet_from_jax(
        {"c/w": np.asarray(jv["params"]["w"])})["c.weight"]})
    got = tc(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=F32_ATOL)


def test_same_pads_split_as_xla():
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(32, 7, 2) == (2, 3)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(15, 3, 2) == (1, 1)
    assert same_pads(8, 1, 2) == (0, 0)


@pytest.mark.parametrize("padding", ["SAME", "VALID", 1, ((0, 2), (1, 0))])
def test_conv2d_groups_bias_and_padding_forms_match_jax(padding):
    rng = np.random.RandomState(3)
    jc = jnn.Conv2d(4, 6, 3, stride=2, padding=padding, groups=2)
    jv = jc.init(jax.random.PRNGKey(1))
    jv["params"]["b"] = jnp.asarray(rng.randn(6).astype(np.float32))
    x = rng.randn(2, 11, 10, 4).astype(np.float32)
    want, _ = jc.apply(jv, jnp.asarray(x))
    tc = Conv2d(4, 6, 3, stride=2, padding=padding, groups=2, device="cpu")
    sd = resnet_from_jax(_flatten({"c": jv["params"]}))
    tc.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    np.testing.assert_allclose(_nhwc(tc(_nchw(x))), np.asarray(want),
                               rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("size", [16, 15], ids=["even", "odd"])
def test_pools_match_jax(size):
    """Max pool 3/2 SAME pads with -inf (negative inputs show a 0 pad);
    avg pool SAME divides by the count inside the input."""
    rng = np.random.RandomState(size)
    x = (rng.randn(2, size, size, 3) - 2.0).astype(np.float32)
    xt = _nchw(x)
    np.testing.assert_array_equal(
        _nhwc(max_pool(xt, 3, 2, "SAME")),
        np.asarray(jnn.max_pool(jnp.asarray(x), 3, 2, "SAME")))
    for pad in ("SAME", "VALID"):
        np.testing.assert_allclose(
            _nhwc(avg_pool(xt, 3, 2, pad)),
            np.asarray(jnn.avg_pool(jnp.asarray(x), 3, 2, pad)),
            rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(
        global_avg_pool(xt).numpy(),
        np.asarray(jnn.global_avg_pool(jnp.asarray(x))), rtol=0,
        atol=F32_ATOL)


def test_max_pool_gradient_matches_jax():
    """Ties (a ReLU's zeros) send the gradient to the first maximum in
    both packages; the -inf pad takes none."""
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(1, 8, 8, 2), 0).astype(np.float32)
    w = rng.randn(1, 4, 4, 2).astype(np.float32)
    want = jax.grad(lambda a: (jnn.max_pool(a, 3, 2, "SAME") * w).sum())(
        jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    (max_pool(xt, 3, 2, "SAME") * _nchw(w)).sum().backward()
    np.testing.assert_array_equal(_nhwc(xt.grad), np.asarray(want))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batchnorm_matches_jax(training, dtype):
    """Output and new running mean and var, from non-trivial running
    statistics so momentum's direction shows; the var biased."""
    rng = np.random.RandomState(7)
    x = (rng.randn(4, 5, 6, 3) * 2 + 1).astype(np.float32)
    scale, bias = rng.randn(3).astype(np.float32), rng.randn(3).astype(
        np.float32)
    mean, var = rng.randn(3).astype(np.float32), rng.rand(3).astype(
        np.float32) + 0.5
    bf16 = dtype == "bf16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jbn = jnn.BatchNorm(3, policy=jax_bf16_policy()) if bf16 else \
        jnn.BatchNorm(3)
    jv = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
          "state": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    jx = jnp.asarray(x).astype(jdt)
    want, new = jbn.apply(jv, jx, training=training)
    bn = BatchNorm(3, device="cpu", **({"policy": bf16_policy()} if bf16
                                       else {}))
    bn.load_state_dict({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "mean": torch.from_numpy(mean),
                        "var": torch.from_numpy(var)})
    bn.train(training)
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = bn(_nchw(x).to(tdt))
    assert got.dtype == tdt and bn.mean.dtype == torch.float32
    assert want.dtype == jdt
    want = np.asarray(want.astype(jnp.float32))
    atol = F32_ATOL if dtype == "f32" else \
        2 * 2.0 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=atol)
    if not training:
        assert new == {}
        np.testing.assert_array_equal(bn.mean.numpy(), mean)
        return
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(new["mean"]),
                               rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(new["var"]),
                               rtol=0, atol=F32_ATOL)
    xf = np.asarray(jx.astype(jnp.float32), np.float64)
    biased = xf.reshape(-1, 3).var(axis=0)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 * var + 0.1 * biased,
                               rtol=1e-6, atol=0)


def test_batchnorm_buffers_stay_fp32_under_bf16():
    bn = BatchNorm(4, policy=bf16_policy(), device="cpu")
    y = bn(torch.randn(2, 4, 3, 3).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert bn.mean.dtype == bn.var.dtype == torch.float32
    assert dict(bn.named_buffers()).keys() == {"mean", "var"}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_s2d_stem_matches_jax_and_conv7(dtype):
    rng = np.random.RandomState(0)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    w = (rng.randn(7, 7, 3, 8) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = jax_resnet._space_to_depth_stem(jnp.asarray(x).astype(jdt),
                                           jnp.asarray(w).astype(jdt))
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    got = _space_to_depth_stem(_nchw(x).to(tdt), wt.to(tdt))
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(want.astype(jnp.float32))
    # bf16: both round the same fp32-accumulated dots to bf16 once.
    atol = F32_ATOL if dtype == "f32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=atol)
    if dtype == "f32":
        conv7 = Conv2d(3, 8, 7, stride=2, use_bias=False, device="cpu")
        conv7.load_state_dict({"weight": wt})
        np.testing.assert_allclose(_nhwc(got), _nhwc(conv7(_nchw(x))),
                                   rtol=0, atol=F32_ATOL)


def _jax_tiny(stem="conv7", policy=None, num_classes=10, seed=0,
              identity_blocks=False, width_factor=1):
    """A tiny JAX ResNet with every weight random: the zero-initialized
    head and last BN scales would leave the trunk without gradient.
    ``identity_blocks`` keeps the last BN scales at the config's zero,
    two blocks in one stage: the second's output is then ``max(x, 0)`` of
    the first's ReLU output, whose zeros tie, so JAX's half gradient at a
    tie reaches the trunk."""
    kw = {"policy": policy} if policy is not None else {}
    jm = jax_resnet.ResNet(_stages(identity_blocks), num_classes=num_classes,
                           stem=stem, width_factor=width_factor, **kw)
    jv = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    params = _flatten(jv["params"])
    for path in params:
        if path.endswith("bn3/scale") and not identity_blocks:
            params[path] = (rng.randn(*params[path].shape) * 0.5).astype(
                np.float32)
        if path == "head/w":   # LeCun scale: logits of order 1
            fan_in = params[path].shape[0]
            params[path] = (rng.randn(*params[path].shape)
                            / np.sqrt(fan_in)).astype(np.float32)
    state = {p: (rng.rand(*a.shape).astype(np.float32) + 0.5
                 if p.endswith("var") else
                 rng.randn(*a.shape).astype(np.float32) * 0.1)
             for p, a in _flatten(jv["state"]).items()}
    return jm, params, state


def _unflatten(flat):
    out = {}
    for path, val in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return out


def _stages(identity_blocks: bool):
    return (2,) if identity_blocks else (1, 1)


def _port_tiny(params, state, stem="conv7", policy=None, num_classes=10,
               identity_blocks=False, width_factor=1):
    kw = {"policy": policy} if policy is not None else {}
    tm = ResNet(_stages(identity_blocks), num_classes=num_classes, stem=stem,
                width_factor=width_factor, device="cpu", **kw)
    tm.load_state_dict(resnet_from_jax(params, state), strict=True)
    return tm


def test_resnet_convert_round_trip():
    _, params, state = _jax_tiny()
    tm = _port_tiny(params, state)
    back_p, back_s = resnet_to_jax(tm.state_dict())
    assert back_p.keys() == params.keys() and back_s.keys() == state.keys()
    for path, arr in {**params, **state}.items():
        np.testing.assert_array_equal({**back_p, **back_s}[path], arr)
    assert tm.state_dict()["blocks.1.conv2.weight"].shape == (128, 128, 3, 3)


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_tiny_resnet_forward_matches_jax(stem, training):
    jm, params, state = _jax_tiny(stem)
    x = np.random.RandomState(5).rand(3, 32, 32, 3).astype(np.float32)
    want, new = jm.apply({"params": _unflatten(params),
                          "state": _unflatten(state)}, jnp.asarray(x),
                         training=training)
    tm = _port_tiny(params, state, stem)
    tm.train(training)
    got = tm({"image": torch.from_numpy(x)})
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=F32_ATOL)
    _, got_state = resnet_to_jax(tm.state_dict())
    want_state = _flatten(new) if training else state
    for path, arr in want_state.items():
        np.testing.assert_allclose(got_state[path], arr, rtol=0,
                                   atol=F32_ATOL, err_msg=path)


def test_odd_input_falls_back_to_conv7():
    jm, params, state = _jax_tiny("s2d")
    x = np.random.RandomState(2).rand(2, 31, 31, 3).astype(np.float32)
    want, _ = jm.apply({"params": _unflatten(params),
                        "state": _unflatten(state)}, jnp.asarray(x))
    tm = _port_tiny(params, state, "s2d").eval()
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=0, atol=F32_ATOL)


# name: (policy, nesterov, weight decay, identity blocks, width factor,
# steps). The width-2 cases are wrn101_large_batch's tiny preset (bf16
# in the config) and its f32 twin, held over one step: at this net's
# second step (lr 0.1) the gradient is ill-conditioned — JAX's own f32
# gradients move 3.4% of their norm when its weights after the first
# step are perturbed by 3e-5 relative, and the port's gradient at JAX's
# very weights lies 3.0e-3 from JAX's (blocks0/bn2/bias; every other
# tensor closer), the two sides' f32 rounding amplified. The velocity's
# second step is held by the width-1 cases.
STEP_CASES = {"f32-wd": ("f32", False, 1e-4, False, 1, 2),
              "f32-nesterov": ("f32", True, 0.0, False, 1, 2),
              "f32-identity-blocks": ("f32", False, 1e-4, True, 1, 2),
              "bf16-wd": ("bf16", False, 1e-4, False, 1, 2),
              "bf16-nesterov": ("bf16", True, 0.0, False, 1, 2),
              "f32-wide": ("f32", False, 1e-4, False, 2, 1),
              "bf16-wide": ("bf16", False, 1e-4, False, 2, 1)}


@pytest.fixture(scope="module", params=list(STEP_CASES))
def resnet_steps(request):
    """Two momentum steps (the velocity at work in the second; one for
    the wide cases) of JAX's ``make_train_step`` and of the port's
    ``TrainStep``, from the same weights, state and batches (s2d stem,
    32 px), plus the first step's loss and gradients of each."""
    dtype, nesterov, wd, identity, width, steps = STEP_CASES[request.param]
    jpol = jax_bf16_policy() if dtype == "bf16" else None
    tpol = bf16_policy() if dtype == "bf16" else None
    jm, params, state = _jax_tiny("s2d", jpol, identity_blocks=identity,
                                  width_factor=width)
    rng = np.random.RandomState(11)
    batches = [{"image": rng.rand(4, 32, 32, 3).astype(np.float32),
                "label": rng.randint(0, 10, 4).astype(np.int32)}
               for _ in range(steps)]
    ce = lambda logits, b: jax_ops.softmax_cross_entropy_with_integer_labels(
        logits, b["label"])
    want = _jax_step(jm, params, state, batches, nesterov, wd, ce)

    exact = {}
    if dtype == "bf16":   # JAX's f32 step from the same weights: exact
        exact = _jax_step(jax_resnet.ResNet((1, 1), num_classes=10,
                                            stem="s2d", width_factor=width),
                          params, state, batches, nesterov, wd, ce)
    tm = _port_tiny(params, state, "s2d", tpol, identity_blocks=identity,
                    width_factor=width)
    step = make_train_step(
        tm, optim.momentum(LR, beta=0.9, nesterov=nesterov, weight_decay=wd),
        lambda logits, b: softmax_cross_entropy_with_integer_labels(
            logits, b["label"]))
    loss, grads = step.loss_and_grads(batches[0])
    step.apply_gradients(grads)
    for batch in batches[1:]:
        step(batch)
    got_p, got_s = resnet_to_jax(tm.state_dict())
    return {"dtype": dtype, "identity": identity, "params0": params,
            "jax": want,
            "exact": exact, "loss": loss.item(),
            "grads": resnet_to_jax(grads)[0], "params": got_p,
            "state": got_s}


def _jax_step(jm, params, state, batches, nesterov, wd, ce):
    """JAX's first-step loss and gradients, and its weights and state
    after every batch's momentum step."""
    jv = {"params": _unflatten(params), "state": _unflatten(state)}
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def jloss(p):
        out, _ = jm.apply({"params": p, "state": jv["state"]}, first,
                          training=True)
        return ce(out, first)

    jl, jg = jax.value_and_grad(jloss)(jv["params"])
    jopt = jax_optim.momentum(LR, beta=0.9, nesterov=nesterov,
                              weight_decay=wd)
    jstep = jax_make_train_step(jm, jopt, ce, donate=False)
    jstate = {"variables": jv, "opt_state": jopt.init(jv["params"]),
              "rng": jax.random.PRNGKey(0)}
    for b in batches:
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    return {"loss": float(jl), "grads": _flatten(jg),
            "params": _flatten(jstate["variables"]["params"]),
            "state": _flatten(jstate["variables"]["state"])}


def _assert_close(case, key, path, got, base=0.0):
    """``got - base`` against JAX's: in f32 within F32_STEP_RTOL of its
    norm; under bf16 as close to JAX's f32 as JAX's own bf16 (see the
    module docstring)."""
    want = case["jax"][key][path] - base
    if case["dtype"] == "f32":
        assert _rel(got - base, want) <= F32_STEP_RTOL, path
        return
    exact = case["exact"][key][path] - base
    bound = max(BF16_RTOL, 2 * _rel(want, exact))
    assert _rel(got - base, exact) <= bound, path


def test_resnet_step_loss_matches_jax(resnet_steps):
    c = resnet_steps
    tol = F32_ATOL if c["dtype"] == "f32" else BF16_RTOL * c["jax"]["loss"]
    assert abs(c["loss"] - c["jax"]["loss"]) <= tol


def test_resnet_step_every_gradient_matches_jax(resnet_steps):
    c = resnet_steps
    assert c["grads"].keys() == c["jax"]["grads"].keys()
    zero = 0
    for path, g in c["grads"].items():
        zero += not np.any(c["jax"]["grads"][path])
        _assert_close(c, "grads", path, g)
    # Identity blocks: bn3's zero scale stops the gradient of the seven
    # tensors before it (conv1-3, bn1, bn2) in each of the two blocks.
    assert zero == (14 if c["identity"] else 0)


def test_resnet_step_weights_and_running_stats_match_jax(resnet_steps):
    """Each weight's change over two momentum steps, and the running
    statistics after them."""
    c = resnet_steps
    for path, p in c["params"].items():
        _assert_close(c, "params", path, p, base=c["params0"][path])
    assert c["state"].keys() == c["jax"]["state"].keys()
    tol = F32_STEP_RTOL if c["dtype"] == "f32" else BF16_RTOL
    for path, s in c["state"].items():
        assert _rel(s, c["jax"]["state"][path]) <= tol, path


def _whole_rel_and_worst_cos(got: dict, want: dict):
    diff = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    norm = sum(float((want[k] ** 2).sum()) for k in want)
    cos = min(float((got[k] * want[k]).sum() / np.sqrt(
        (got[k] ** 2).sum() * (want[k] ** 2).sum())) for k in want)
    return np.sqrt(diff / norm), cos


def test_resnet50_full_depth_gradients_match_jax():
    """ResNet-50 (s2d stem) at full depth, batch 4 at 64 px, the config's
    weights with a LeCun-scaled head and last BatchNorm scales of std
    0.05 (``chip_smoke.py``'s bf16 check's recipe): the first step's
    loss and gradients against JAX's.

    - f32: the loss within 1e-5; 50 layers of BatchNorm amplify the two
      sides' rounding differences (the whole gradient read 3.1e-4 of its
      norm apart when this test was written), so the whole gradient
      within 1e-3 of its norm and each tensor's cosine at least 0.9999;
    - bf16: JAX's own bf16 gradient lies 13.5% of its norm from its f32
      one (worst tensor cosine 0.934); the port's, measured against that
      same f32 gradient, within twice JAX's distance, each tensor's
      cosine at least ``1 - 2 (1 - JAX's worst)``, the loss within 1%."""
    rng = np.random.RandomState(0)
    batch = {"image": rng.rand(4, 64, 64, 3).astype(np.float32),
             "label": rng.randint(0, 1000, 4).astype(np.int32)}
    tm = resnet50(stem="s2d", device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith("bn3.scale"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            elif name == "head.w":
                p.copy_(torch.randn(p.shape, generator=g)
                        / np.sqrt(p.shape[0]))
    params, state = resnet_to_jax(tm.state_dict())
    ce = lambda logits, b: softmax_cross_entropy_with_integer_labels(
        logits, b["label"])
    jce = lambda logits, b: jax_ops.softmax_cross_entropy_with_integer_labels(
        logits, b["label"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    res = {}
    for tag, jpol, tpol in (("f32", None, None),
                            ("bf16", jax_bf16_policy(), bf16_policy())):
        jm = jax_resnet.resnet50(stem="s2d",
                                 **({"policy": jpol} if jpol else {}))

        def jloss(p, jm=jm):
            out, _ = jm.apply({"params": p, "state": _unflatten(state)},
                              jbatch, training=True)
            return jce(out, jbatch)

        jl, jg = jax.jit(jax.value_and_grad(jloss))(_unflatten(params))
        model = resnet50(stem="s2d", device="cpu",
                         **({"policy": tpol} if tpol else {}))
        model.load_state_dict(tm.state_dict())
        loss, grads = make_train_step(model, optim.sgd(0.0),
                                      ce).loss_and_grads(batch)
        res[tag] = (float(jl), _flatten(jg), loss.item(),
                    resnet_to_jax(grads)[0])
    jl, exact, loss, grads = res["f32"]
    assert abs(loss - jl) <= F32_ATOL
    whole, cos = _whole_rel_and_worst_cos(grads, exact)
    assert whole <= 1e-3 and cos >= 0.9999, (whole, cos)
    jl16, jg16, loss16, grads16 = res["bf16"]
    assert abs(loss16 - jl) <= 0.01 * jl
    jax_whole, jax_cos = _whole_rel_and_worst_cos(jg16, exact)
    whole, cos = _whole_rel_and_worst_cos(grads16, exact)
    assert whole <= 2 * jax_whole, (whole, jax_whole)
    assert cos >= 1 - 2 * (1 - jax_cos), (cos, jax_cos)


def test_resnet_evaluate_matches_jax():
    """Eval mode reads the running statistics: the same predictions, so
    the same accuracy, and the buffers untouched."""
    jm, params, state = _jax_tiny("s2d", num_classes=5)
    rng = np.random.RandomState(4)
    batches = [{"image": rng.rand(6, 32, 32, 3).astype(np.float32),
                "label": rng.randint(0, 5, 6).astype(np.int32)}
               for _ in range(3)]
    want = jax_evaluate(jm, {"params": _unflatten(params),
                             "state": _unflatten(state)}, iter(batches))
    tm = _port_tiny(params, state, "s2d", num_classes=5)
    got = evaluate(tm, iter(batches))
    assert got == want
    assert tm.training
    np.testing.assert_array_equal(tm.stem_bn.mean.numpy(),
                                  state["stem_bn/mean"])


@pytest.mark.parametrize("ignore_index", [None, -100])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_options_match_jax(ignore_index, label_smoothing):
    rng = np.random.RandomState(1)
    logits = (rng.randn(3, 5, 7) * 3).astype(np.float32)
    labels = rng.randint(0, 7, (3, 5)).astype(np.int32)
    labels[0, :2] = -100
    if ignore_index is None:
        labels[labels < 0] = 3
    want = jax_ops.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels), ignore_index=ignore_index,
        label_smoothing=label_smoothing)
    got = softmax_cross_entropy_with_integer_labels(
        torch.from_numpy(logits), torch.from_numpy(labels),
        ignore_index=ignore_index, label_smoothing=label_smoothing)
    assert abs(got.item() - float(want)) <= F32_ATOL
    every = torch.full((2, 7), -100)
    assert softmax_cross_entropy_with_integer_labels(
        torch.zeros(2, 7, 7), every, ignore_index=-100).item() == 0.0


@pytest.mark.parametrize("image_size,num_classes", [(8, 17), (33, 1000)])
def test_synthetic_image_batches_bitwise_jax(image_size, num_classes):
    want = jax_synthetic_image_batches(3, image_size=image_size,
                                       num_classes=num_classes, seed=5)
    got = synthetic_image_batches(3, image_size=image_size,
                                  num_classes=num_classes, seed=5)
    for _ in range(6):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("build", ["resnet50", "wide_resnet101"])
def test_full_depth_structure_matches_jax(build):
    """Parameter and state names and shapes of the full-depth models
    against ``jax.eval_shape`` of JAX's init (no JAX compute)."""
    jm = getattr(jax_resnet, build)(stem="s2d")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm = {"resnet50": resnet50, "wide_resnet101": wide_resnet101}[build](
        stem="s2d", device="cpu")
    got = resnet_to_jax(tm.state_dict())
    for part, flat in zip(("params", "state"), got):
        want = {path: tuple(leaf.shape) for path, leaf in
                _flat_paths(shapes[part])}
        assert {k: a.shape for k, a in flat.items()} == want, part


def test_remat_is_refused():
    """ResNet's remat is ported (tests/test_torch_remat.py holds it to
    JAX's); the train CLI refuses ``--remat`` where JAX's does, in its
    words."""
    assert ResNet((1, 1), remat=True, device="cpu").remat
    from nezha_tpu_torch.cli.train import parse_args
    for config in ("mlp_mnist", "bert_base_zero1"):
        with pytest.raises(SystemExit, match="--remat applies to gpt2_124m "
                                             "and the image configs"):
            parse_args(["--config", config, "--remat"])


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "nezha_tpu_torch.cli.train", *argv],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)


@pytest.mark.parametrize("config", ["resnet50_imagenet", "mlp_mnist",
                                    "bert_base_zero1",
                                    "wrn101_large_batch"])
def test_cli_trains_image_configs_tiny_on_cpu(config):
    proc = _cli("--config", config, "--model-preset", "tiny", "--device",
                "cpu", "--steps", "3", "--batch-size", "4")
    assert proc.returncode == 0, proc.stderr
    final = json.loads(proc.stdout.strip().splitlines()[-1])["final"]
    assert final["step"] == 3
    assert np.isfinite(final["loss"]) and 0 < final["loss"] < 10


# Per config, a flag that the port's train CLI still refuses, and a
# trainer option that the port still refuses typed.
STILL_REFUSED = {
    "bert_base_zero1": (
        ["--mlm-mask-token", "103"],
        lambda: Trainer(Bert(BertConfig(**TINY_BERT_KW), device="cpu"),
                        optim.sgd(0.1), lambda out, b: out.sum(),
                        save_fn=lambda *a: None)),
    "wrn101_large_batch": (
        ["--platform", "cpu"],
        lambda: Trainer(ResNet((1, 1), width_factor=2, device="cpu"),
                        optim.momentum(0.1), lambda out, b: out.sum(),
                        shard_fn=lambda b: b))}


@pytest.mark.parametrize("config", ["bert_base_zero1", "wrn101_large_batch"])
def test_cli_refuses_unported_configs_typed(config):
    """Both configs train now, dp and ZeRO-1 included (BERT also
    tensor-parallel); what each still lacks is refused: pipeline
    parallelism (``--parallel pp``: no pipeline spec, JAX's message),
    tensor parallelism for WRN (no rule table, JAX's message), the
    ``--platform`` flag, the MLM mask-token flag without ``--data-dir``,
    and the trainer's custom save and sharding functions
    (``NotPortedError``). The graph engine and BERT's scanned trunk are
    ported (tests/test_torch_graph_cli.py, tests/test_torch_scan.py)."""
    from nezha_tpu_torch.cli.train import main, parse_args

    flag, knob = STILL_REFUSED[config]
    with pytest.raises(SystemExit, match="has no pipeline spec"):
        main(["--config", config, "--device", "cpu", "--parallel", "pp"])
    if config == "wrn101_large_batch":
        with pytest.raises(SystemExit, match="no tensor-parallel rule"):
            main(["--config", config, "--device", "cpu", "--parallel",
                  "gspmd"])
    with pytest.raises(SystemExit):
        parse_args(["--config", config, *flag])
    with pytest.raises(NotPortedError):
        knob()


def test_cli_image_flags():
    from nezha_tpu_torch.cli.train import parse_args

    args = parse_args(["--config", "resnet50_imagenet"])
    assert args.device == "cuda" and args.batch_size is None
    for argv in (["--seq-len", "64"], ["--dropout", "0.1"],
                 ["--wd-exclude-1d"], ["--label-smoothing", "1.5"],
                 ["--mlm-mask-token", "103"], ["--moe-experts", "4"]):
        with pytest.raises(SystemExit):
            parse_args(["--config", "resnet50_imagenet", *argv])
    # Label smoothing in (0, 1) and reading from disk are taken.
    args = parse_args(["--config", "resnet50_imagenet", "--label-smoothing",
                       "0.1", "--data-dir", "/x", "--crop", "32"])
    assert (args.label_smoothing, args.data_dir, args.crop) == (0.1, "/x",
                                                                32)


def _eval_points(stderr: str):
    """(steps of the periodic eval lines, the final eval) of a run."""
    periodic, final = [], None
    for line in stderr.splitlines():
        if not line.startswith("{"):
            continue
        rec = json.loads(line)
        if "eval" in rec:
            final = rec["eval"]
        elif any(k.startswith("eval_") for k in rec):
            periodic.append(rec["step"])
    return periodic, final


# config: (extra flags, the eval metric the config's stat gives)
EVAL_CASES = {"gpt2_124m": (["--seq-len", "32", "--model-preset", "tiny"],
                            "perplexity"),
              "bert_base_zero1": (["--model-preset", "tiny"], "perplexity"),
              "mlp_mnist": ([], "accuracy")}


@pytest.mark.parametrize("config", list(EVAL_CASES))
def test_cli_eval_every_and_final_eval(config):
    """``--eval-every 2`` over 5 steps: eval lines at steps 2 and 4 (the
    chunks end on multiples of 2; none at the last step, which the final
    pass covers), then the final ``{"eval": ...}`` line, its numbers
    under ``eval_*`` in the final line; ``--eval-batches`` caps each
    pass."""
    flags, metric = EVAL_CASES[config]
    proc = _cli("--config", config, "--device", "cpu", "--steps", "5",
                "--batch-size", "4", "--eval-every", "2", "--eval-batches",
                "2", *flags)
    assert proc.returncode == 0, proc.stderr
    periodic, final = _eval_points(proc.stderr)
    assert periodic == [2, 4]
    assert final["batches"] == 2 and np.isfinite(final[metric])
    last = json.loads(proc.stdout.strip().splitlines()[-1])["final"]
    assert last["step"] == 5 and last[f"eval_{metric}"] == final[metric]


def test_cli_eval_flags_checked_and_image_configs_have_no_split():
    from nezha_tpu_torch.cli.train import parse_args

    for argv in (["--eval-every", "0"], ["--eval-batches", "0"]):
        with pytest.raises(SystemExit):
            parse_args(["--config", "gpt2_124m", *argv])
    proc = _cli("--config", "wrn101_large_batch", "--model-preset", "tiny",
                "--device", "cpu", "--steps", "2", "--batch-size", "2",
                "--eval")
    assert proc.returncode == 0, proc.stderr
    assert _eval_points(proc.stderr) == ([], None)
    assert "single-device" in proc.stderr
    final = json.loads(proc.stdout.strip().splitlines()[-1])["final"]
    assert not any(k.startswith("eval_") for k in final)
