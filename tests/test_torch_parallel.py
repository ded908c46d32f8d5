"""The port's data parallelism and ZeRO-1 against the JAX package's on the
CPU: JAX's ``make_dp_train_step`` / ``make_zero1_train_step`` over a dp
mesh of its 8 host devices, the port's ``DPTrainStep`` /
``Zero1TrainStep`` in 2 (once 4) gloo processes (tests/torch_dist_worker.py),
from the same weights and global batches, fp32.

Tolerances: the two packages sum the same f32 formulas in other orders
(test_torch_train.py). The loss is held to rtol 1e-5. Each weight's and
BatchNorm buffer's change over the two steps is held, in relative L2
norm, to 1e-4 of JAX's change (test_torch_resnet.py's F32_STEP_RTOL;
ResNet at 4 rows a rank, since BatchNorm over 2 rows amplifies rounding
5x), and to 2e-4 under AdamW, which divides by ``sqrt(v) + eps`` and so
magnifies rounding where a gradient is near zero (the query-key bias,
zero in exact arithmetic). The ranks' weights are bitwise equal. The
port is also held to itself: GPT-2 at world 2 and 4 to one process over
the concatenated batch (every row has the same token count, so the mean
of the rank losses is the batch's), at the same tolerance; ZeRO-1 to dp
at the same world, bitwise without a clip (a reduce-scatter of two
addends is the all-reduce's sum; the optimizer is elementwise) and
within rtol 1e-6 with one (the clip's norm sums chunks, then ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import optim as jax_optim
from nezha_tpu import parallel as jax_parallel
from nezha_tpu.cli.train import TINY_BERT_KW, TINY_GPT2_KW
from nezha_tpu.models import resnet as jax_resnet
from nezha_tpu.models.bert import Bert as JaxBert
from nezha_tpu.models.bert import BertConfig as JaxBertConfig
from nezha_tpu.models.bert import mlm_loss as jax_mlm_loss
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu.ops import softmax_cross_entropy_with_integer_labels as jce
from nezha_tpu_torch.models.convert import (bert_from_jax, params_from_jax,
                                            resnet_from_jax)
from nezha_tpu_torch.train.loop import TrainStep
from torch_dist_worker import (build_model, build_optimizer, loss_of,
                               run_world)

RTOL = 1e-5
UPDATE_RTOL = {"momentum": 1e-4, "adamw": 2e-4}


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
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


def _jax_model(spec):
    """JAX's model of a spec, its flat params and state (ResNet's last BN
    scales and head drawn at random so the trunk gets gradient), and the
    port's state_dict of the same weights."""
    if spec == "gpt2":
        jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW))
    elif spec == "bert":
        jm = JaxBert(JaxBertConfig(**TINY_BERT_KW))
    else:
        jm = jax_resnet.ResNet((1, 1), num_classes=10, stem="s2d")
    jv = jm.init(jax.random.PRNGKey(0))
    params, state = _flatten(jv["params"]), _flatten(jv.get("state", {}))
    rng = np.random.RandomState(1)
    for path in params:
        if path.endswith("bn3/scale") or path == "head/w":
            params[path] = (rng.randn(*params[path].shape) * 0.3).astype(
                np.float32)
    if spec == "bert":
        params["mlm_bias"] = (rng.randn(512) * 0.5).astype(np.float32)
    if spec == "resnet":
        sd = resnet_from_jax(params, state)
    else:
        sd = (bert_from_jax if spec == "bert" else params_from_jax)(params)
    return jm, params, state, {k: v.numpy() for k, v in sd.items()}


def _batches(spec, n, rows):
    r = np.random.RandomState(7)
    out = []
    for _ in range(n):
        if spec == "gpt2":
            out.append({"tokens": r.randint(0, 512, (rows, 33)).astype(
                np.int32)})
        elif spec == "bert":
            ids = r.randint(5, 512, (rows, 32)).astype(np.int32)
            labels = np.where(r.rand(rows, 32) < 0.3, ids, -100).astype(
                np.int32)
            out.append({"tokens": np.where(labels >= 0, 1, ids).astype(
                np.int32), "labels": labels,
                "segment_ids": np.zeros_like(ids)})
        else:
            out.append({"image": r.rand(rows, 32, 32, 3).astype(np.float32),
                        "label": r.randint(0, 10, rows).astype(np.int32)})
    return out


def _jax_opt(spec):
    kind, *args = spec["opt"]
    opt = {"sgd": jax_optim.sgd, "momentum": jax_optim.momentum,
           "adamw": jax_optim.adamw}[kind](*args)
    if spec.get("clip"):
        opt = jax_optim.with_grad_clipping(
            opt, spec["clip"],
            axis_name="dp" if spec["mode"] == "zero1" else None)
    return opt


_JAX_LOSS = {"gpt2": jax_lm_loss, "bert": jax_mlm_loss,
             "resnet": lambda logits, b: jce(logits, b["label"])}


def _jax_run(spec, world, jm, params, state, batches):
    """JAX's dp or zero1 steps on a dp=``world`` mesh: the losses, the
    final flat variables and (zero1) the flat optimizer state."""
    mesh = jax_parallel.make_mesh({"dp": world},
                                  devices=jax.devices()[:world])
    opt = _jax_opt(spec)
    variables = {"params": _unflatten(params), "state": _unflatten(state)}
    rng = jax_parallel.replicate(mesh, jax.random.PRNGKey(3))
    if spec["mode"] == "zero1":
        jstate = {"variables": jax_parallel.replicate(mesh, variables),
                  "opt_state": jax_parallel.zero1_init_opt_state(
                      opt, variables["params"], mesh), "rng": rng}
        step = jax_parallel.make_zero1_train_step(
            jm, opt, _JAX_LOSS[spec["model"]], mesh, donate=False)
    else:
        jstate = jax_parallel.replicate(mesh, {
            "variables": variables, "opt_state": opt.init(
                variables["params"]), "rng": jax.random.PRNGKey(3)})
        step = jax_parallel.make_dp_train_step(
            jm, opt, _JAX_LOSS[spec["model"]], mesh, donate=False)
    losses = []
    for b in batches:
        jstate, m = step(jstate, jax_parallel.shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        losses.append(float(m["loss"]))
    flat = {f"variables/{k}": v
            for k, v in _flatten(jstate["variables"]).items()}
    return losses, flat, _flatten(jstate["opt_state"])


# name: (model, optimizer, mode, clip, world)
CASES = {
    "gpt2-dp2": ("gpt2", ("momentum", 0.1, 0.9), "dp", None, 2),
    "gpt2-dp4": ("gpt2", ("momentum", 0.1, 0.9), "dp", None, 4),
    "resnet-dp2": ("resnet", ("momentum", 0.01, 0.9, False, 1e-4), "dp",
                   None, 2),
    "bert-zero1-clip": ("bert", ("momentum", 0.1, 0.9), "zero1", 0.05, 2),
    "bert-zero1-adamw": ("bert", ("adamw", 1e-3), "zero1", None, 2),
}


_RUNS = {}


def _case(name, tmp_path_factory):
    """JAX's run and the port's world of processes for case ``name``,
    once a module."""
    if name not in _RUNS:
        model, opt, mode, clip, world = CASES[name]
        spec = {"model": model, "opt": opt, "mode": mode, "clip": clip}
        jm, params, state, sd = _jax_model(model)
        batches = _batches(model, 2, 8 if model == "resnet" else 4)
        jax_out = _jax_run(spec, world, jm, params, state, batches)
        ranks = run_world("train", world, dict(spec, state_dict=sd,
                                               batches=batches),
                          tmp_path_factory.mktemp(name))
        w0 = {f"variables/params/{k}": v for k, v in params.items()}
        w0.update({f"variables/state/{k}": v for k, v in state.items()})
        _RUNS[name] = {"spec": spec, "world": world, "sd": sd,
                       "batches": batches, "jax": jax_out, "ranks": ranks,
                       "w0": w0}
    return _RUNS[name]


@pytest.fixture(scope="module", params=list(CASES))
def parallel_case(request, tmp_path_factory):
    return _case(request.param, tmp_path_factory)


def test_losses_match_jax(parallel_case):
    want = parallel_case["jax"][0]
    for r in parallel_case["ranks"]:
        np.testing.assert_allclose(r["losses"], want, rtol=RTOL)


def test_weights_and_buffers_match_jax(parallel_case):
    """Every weight's and BatchNorm buffer's change after two steps, on
    every rank; the ranks hold bitwise the same weights."""
    want, w0 = parallel_case["jax"][1], parallel_case["w0"]
    tol = UPDATE_RTOL[parallel_case["spec"]["opt"][0]]
    first = parallel_case["ranks"][0]["state"]
    for r in parallel_case["ranks"]:
        assert r["state"].keys() == want.keys()
        for k, w in want.items():
            got, ref = r["state"][k] - w0[k], w - w0[k]
            rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref),
                                                   1e-30)
            assert rel <= tol, (k, rel)
            np.testing.assert_array_equal(r["state"][k], first[k],
                                          err_msg=k)


def _port_run(spec, sd, batches, world=1):
    """The port on one process (world 1: a plain TrainStep over the
    whole batches) -> (losses, flat variables)."""
    from nezha_tpu_torch.models.convert import train_state_to_jax

    model = build_model(spec["model"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    step = TrainStep(model, build_optimizer(spec), loss_of(spec["model"]))
    losses = [float(step(b)["loss"]) for b in batches]
    return losses, train_state_to_jax(model)


@pytest.mark.parametrize("name", ["gpt2-dp2", "gpt2-dp4",
                                  "bert-zero1-adamw", "bert-zero1-clip"])
def test_matches_port_reference(name, tmp_path_factory):
    c = _case(name, tmp_path_factory)
    got_losses, got = c["ranks"][0]["losses"], c["ranks"][0]["state"]
    if c["spec"]["mode"] == "dp":
        losses, want = _port_run(c["spec"], c["sd"], c["batches"])
        np.testing.assert_allclose(got_losses, losses, rtol=RTOL)
        for k, w in want.items():
            ref = w - c["w0"][k]
            rel = np.linalg.norm(got[k] - w) / max(np.linalg.norm(ref),
                                                   1e-30)
            assert rel <= UPDATE_RTOL["momentum"], (k, rel)
        return
    dp = run_world("train", c["world"], dict(
        c["spec"], mode="dp", state_dict=c["sd"], batches=c["batches"]),
        tmp_path_factory.mktemp(name + "-dp"))
    assert dp[0]["losses"] == got_losses
    for k, w in dp[0]["state"].items():
        if c["spec"]["clip"]:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-9,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_opt_state_matches_jax(parallel_case):
    """dp: the whole optimizer state on every rank. ZeRO-1: each rank
    holds 1/world of the flat state, the elements JAX's dp shard holds,
    and together the ranks hold exactly one copy."""
    world = parallel_case["world"]
    jopt = parallel_case["jax"][2]
    dense = sum(v.size * 4 for v in jopt.values() if v.ndim)
    if parallel_case["spec"]["mode"] != "zero1":
        for r in parallel_case["ranks"]:
            assert r["opt_state_bytes"] == dense
        return
    total = 0
    for rank, r in enumerate(parallel_case["ranks"]):
        for key, chunk in r["chunks"].items():
            full = jopt[key[len("opt_state/"):]]
            c = full.size // world
            want = full[rank * c:(rank + 1) * c]
            rel = np.linalg.norm(chunk - want) / max(np.linalg.norm(full),
                                                     1e-30)
            assert rel <= UPDATE_RTOL["adamw"], (key, rank, rel)
        total += r["opt_state_bytes"]
    assert total == dense


def test_sync_batch_stats_matches_jax():
    """The mean over the replica axis of stacked BatchNorm statistics,
    fp32 whatever the input dtype, as JAX's ``sync_batch_stats``."""
    from nezha_tpu_torch.parallel.data_parallel import sync_batch_stats

    r = np.random.RandomState(3)
    stacked = {"mean": r.randn(4, 6).astype(np.float32),
               "var": r.rand(4, 2, 3).astype(np.float16)}
    got = sync_batch_stats({k: torch.from_numpy(v)
                            for k, v in stacked.items()})
    want = jax_parallel.sync_batch_stats(
        {k: jnp.asarray(v) for k, v in stacked.items()})
    for k in stacked:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    assert sync_batch_stats(None) == {}


@pytest.mark.parametrize("payload,seconds,world", [
    (1 << 30, 0.5, 1), (1 << 30, 0.5, 2), (498_000_000, 0.012, 4),
    (1000, 0.0, 8)])
def test_allreduce_bus_bandwidth_matches_jax(payload, seconds, world):
    from nezha_tpu.parallel.collectives import \
        allreduce_bus_bandwidth as jax_bus_bw
    from nezha_tpu_torch.parallel.collectives import allreduce_bus_bandwidth

    assert allreduce_bus_bandwidth(payload, seconds, world) == \
        jax_bus_bw(payload, seconds, world)
