"""The port's ``mlp_mnist`` path against the JAX package on the CPU: the
MNIST loader (synthetic fallback and IDX files) bitwise, the MLP's
forward and momentum steps, ``evaluate``'s accuracy, and ``sgd``.
Weights carry across with ``models.convert.params_from_jax``.

Tolerances: f32 on both sides, the same products summed in other
orders: logits and loss within 1e-5; each gradient and each weight's
change over the steps within 1e-5 of its tensor's norm; accuracy and
its counts exactly (a prediction flips only if two logits lie within
1e-5, which these random weights do not give).
"""

import gzip
import itertools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import ops as jax_ops
from nezha_tpu import optim as jax_optim
from nezha_tpu.data import mnist as jax_mnist
from nezha_tpu.models.mlp import MLP as JaxMLP
from nezha_tpu.train.eval import evaluate as jax_evaluate
from nezha_tpu.train.loop import make_train_step as jax_make_train_step
from nezha_tpu_torch import optim
from nezha_tpu_torch.data import load_mnist, mnist_batches
from nezha_tpu_torch.models import MLP, params_from_jax, params_to_jax
from nezha_tpu_torch.ops.losses import \
    softmax_cross_entropy_with_integer_labels
from nezha_tpu_torch.train import evaluate, make_train_step

TOL = 1e-5


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


@pytest.fixture
def no_mnist_files(monkeypatch, tmp_path):
    monkeypatch.setenv("NEZHA_DATA_DIR", str(tmp_path / "none"))


@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_batches_bitwise_jax(no_mnist_files, split):
    """The synthetic fallback: every batch equal to JAX's, across an
    epoch boundary of the train split's reshuffle."""
    want = jax_mnist.mnist_batches(1000, split=split, seed=3)
    got = mnist_batches(1000, split=split, seed=3)
    for _ in range(10):
        a, b = next(got), next(want)
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert len(list(mnist_batches(512, split="test", epochs=1))) == 2
    with pytest.raises(ValueError):
        next(mnist_batches(5000, split="test"))


def _write_idx(path, arr, gz):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gzip"])
def test_load_mnist_reads_idx_files_as_jax(monkeypatch, tmp_path, gz):
    d = tmp_path / "mnist"
    d.mkdir()
    rng = np.random.RandomState(0)
    suffix = ".gz" if gz else ""
    for stem, shape in (("train-images-idx3-ubyte", (20, 28, 28)),
                        ("train-labels-idx1-ubyte", (20,)),
                        ("t10k-images-idx3-ubyte", (7, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (7,))):
        _write_idx(d / (stem + suffix), rng.randint(0, 256, shape), gz)
    monkeypatch.setenv("NEZHA_DATA_DIR", str(tmp_path))
    got, want = load_mnist(), jax_mnist.load_mnist()
    assert got[0][0].shape == (20, 28, 28) and got[1][1].shape == (7,)
    for g_split, w_split in zip(got, want):
        for g, w in zip(g_split, w_split):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _jax_mlp(seed=0):
    jm = JaxMLP()
    return jm, jm.init(jax.random.PRNGKey(seed))


def _port_mlp(jv):
    tm = MLP(device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return tm


def test_mlp_names_and_forward_match_jax(no_mnist_files):
    jm, jv = _jax_mlp()
    tm = _port_mlp(jv)
    assert set(params_to_jax(tm.state_dict())) == set(_flatten(jv["params"]))
    x = next(mnist_batches(16))["image"]
    want, _ = jm.apply(jv, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("opt", ["momentum", "sgd", "momentum-nesterov-wd"])
def test_mlp_steps_match_jax(no_mnist_files, opt):
    """Three steps of the config's optimizer (and of sgd, and of momentum
    with Nesterov and coupled weight decay): the first step's loss and
    gradients, every weight's change after the three."""
    make = {"momentum": lambda o: o.momentum(0.1),
            "sgd": lambda o: o.sgd(0.1),
            "momentum-nesterov-wd": lambda o: o.momentum(
                0.1, beta=0.9, nesterov=True, weight_decay=1e-2)}[opt]
    jm, jv = _jax_mlp(1)
    batches = list(itertools.islice(mnist_batches(32), 3))
    ce = lambda logits, b: jax_ops.softmax_cross_entropy_with_integer_labels(
        logits, b["label"])
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jl, jg = jax.value_and_grad(
        lambda p: ce(jm.apply({"params": p, "state": {}}, first)[0], first))(
        jv["params"])
    jopt = make(jax_optim)
    jstep = jax_make_train_step(jm, jopt, ce, donate=False)
    js = {"variables": jv, "opt_state": jopt.init(jv["params"]),
          "rng": jax.random.PRNGKey(0)}
    for b in batches:
        js, _ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})

    tm = _port_mlp(jv)
    p0 = params_to_jax(tm.state_dict())
    step = make_train_step(tm, make(optim), lambda logits, b: (
        softmax_cross_entropy_with_integer_labels(logits, b["label"])))
    loss, grads = step.loss_and_grads(batches[0])
    assert abs(loss.item() - float(jl)) <= TOL
    want_g = _flatten(jg)
    for path, g in params_to_jax(grads).items():
        assert _rel(g, want_g[path]) <= TOL, path
    step.apply_gradients(grads)
    for b in batches[1:]:
        step(b)
    want_p = _flatten(js["variables"]["params"])
    for path, p in params_to_jax(tm.state_dict()).items():
        assert _rel(p - p0[path], want_p[path] - p0[path]) <= TOL, path


def test_mlp_evaluate_accuracy_matches_jax(no_mnist_files):
    """After a few steps (so predictions are not uniform), top-1
    accuracy on the synthetic test split equals JAX's."""
    jm, jv = _jax_mlp(2)
    tm = _port_mlp(jv)
    step = make_train_step(tm, optim.momentum(0.1), lambda logits, b: (
        softmax_cross_entropy_with_integer_labels(logits, b["label"])))
    for _, b in zip(range(5), mnist_batches(64)):
        step(b)
    params = {}
    for path, arr in params_to_jax(tm.state_dict()).items():
        layer, leaf = path.split("/")
        params.setdefault(layer, {})[leaf] = jnp.asarray(arr)
    jv = {"params": params, "state": {}}
    want = jax_evaluate(jm, jv, jax_mnist.mnist_batches(
        256, split="test", epochs=1))
    got = evaluate(tm, mnist_batches(256, split="test", epochs=1))
    assert got == want
    assert got["count"] == 1024 and got["batches"] == 4
    assert 0.2 < got["accuracy"] <= 1.0
    limited = evaluate(tm, mnist_batches(256, split="test"), max_batches=2)
    assert limited["count"] == 512
    with pytest.raises(ValueError):
        evaluate(tm, iter([]))
