"""The port's LARS, LAMB, Adafactor and gradient accumulation against the
JAX package's on the CPU, their nested states through both packages'
checkpoints, and ``--grad-accum`` under dp and ZeRO-1 at world 2.

Tolerances:

- an optimizer's update and state, step by step on the same gradients:
  each tensor within UPDATE_RTOL (1e-5) of its norm. The formulas are
  JAX's in fp32; what differs is the order of the norms' and means'
  sums (LARS, LAMB, Adafactor) over a few hundred elements;
- Adafactor on a tiny ResNet's parameters (conv kernels factored as
  HWIO), fed JAX's gradients: UPDATE_RTOL as above; the train step's
  first loss within 1e-5 relative. Not the weights after several steps:
  ``g / sqrt(v)`` divides each element by its own recent magnitude, so
  the gradients' 1e-5 (sums in another order) grows to 1e-3 where an
  element is small, as AdamW's does (test_torch_parallel.py);
- dp and ZeRO-1 at world 2: test_torch_parallel.py's tolerances (the
  loss 1e-5 relative, each weight's change 1e-4 for momentum and 2e-4
  for AdamW of its norm), the ranks bitwise equal;
- a checkpoint round trip, a resumed run and an accumulation of one
  micro-step: bitwise; the counters exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from nezha_tpu import optim as jax_optim
from nezha_tpu import parallel as jax_parallel
from nezha_tpu.train import checkpoint as jax_ckpt
from nezha_tpu.train import sharded_checkpoint as jsc
from nezha_tpu.train.loop import make_train_step as jax_make_train_step
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.models import ResNet, resnet_from_jax
from nezha_tpu_torch.models.convert import train_state_to_jax
from nezha_tpu_torch.ops.losses import \
    softmax_cross_entropy_with_integer_labels as tce
from nezha_tpu_torch.parallel.zero1 import Zero1TrainStep
from nezha_tpu_torch.train import Trainer, make_train_step
from nezha_tpu_torch.train import checkpoint as ckpt
from nezha_tpu_torch.train import sharded_checkpoint as tsc
from nezha_tpu_torch.train.loop import prng_key
from test_torch_parallel import (_JAX_LOSS, _batches, _flatten, _jax_model,
                                 _unflatten)
from torch_dist_worker import run_world

UPDATE_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARALLEL_RTOL = {"momentum": 1e-4, "adamw": 2e-4}


def _rel(got, want):
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(
        np.linalg.norm(want), 1e-30)


# ------------------------------------------------- the optimizers alone
class Toy(torch.nn.Module):
    """One leaf of each kind: a conv kernel (OIHW here, HWIO in JAX), a
    matrix, a 3-D table, a bias and a scale."""

    def __init__(self, p):
        super().__init__()
        for mod, leaf, arr in (("conv", "weight",
                                p["conv"]["w"].transpose(3, 2, 0, 1)),
                               ("lin", "w", p["lin"]["w"]),
                               ("lin", "b", p["lin"]["b"]),
                               ("emb", "table", p["emb"]["table"]),
                               ("ln", "scale", p["ln"]["scale"])):
            if not hasattr(self, mod):
                setattr(self, mod, torch.nn.Module())
            getattr(self, mod).register_parameter(leaf, torch.nn.Parameter(
                torch.from_numpy(np.ascontiguousarray(arr))))


def _toy_tree(r):
    return {"conv": {"w": r.randn(3, 3, 4, 6).astype(np.float32)},
            "lin": {"w": r.randn(6, 5).astype(np.float32),
                    "b": r.randn(5).astype(np.float32)},
            "emb": {"table": r.randn(2, 3, 4).astype(np.float32)},
            "ln": {"scale": (1 + 0.1 * r.randn(5)).astype(np.float32)}}


_PORT_NAMES = {"conv.weight": "conv/w", "lin.w": "lin/w", "lin.b": "lin/b",
               "emb.table": "emb/table", "ln.scale": "ln/scale"}


def _to_port(flat_jax):
    """A flat JAX tree (``conv/w`` HWIO, ...) -> the port's names and
    layouts."""
    out = {}
    for name, path in _PORT_NAMES.items():
        a = flat_jax[path]
        out[name] = torch.from_numpy(np.ascontiguousarray(
            a.transpose(3, 2, 0, 1) if a.ndim == 4 else a))
    return out


def _port_flat(t_updates):
    out = {}
    for name, path in _PORT_NAMES.items():
        a = t_updates[name].detach().numpy()
        out[path] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return out


def _sched(pkg):
    return pkg.warmup_cosine_schedule(0.05, 2, 10)


OPTIMIZERS = {
    "lars": lambda pkg: pkg.lars(_sched(pkg), weight_decay=1e-4,
                                 skip_fn=lambda p: {
                                     k: ("scale" in k or k.endswith("b"))
                                     for k in (p if isinstance(p, dict)
                                               else {})}),
    "lamb": lambda pkg: pkg.lamb(_sched(pkg), weight_decay=0.01),
    "adafactor": lambda pkg: pkg.adafactor(_sched(pkg), weight_decay=1e-3),
    "adafactor-plain": lambda pkg: pkg.adafactor(0.01),
    "accum1-adamw": lambda pkg: pkg.accumulate_gradients(
        pkg.adamw(_sched(pkg), weight_decay=0.1), 1),
    "accum2-momentum": lambda pkg: pkg.accumulate_gradients(
        pkg.momentum(_sched(pkg), beta=0.9, weight_decay=1e-4), 2),
    "accum4-adamw": lambda pkg: pkg.accumulate_gradients(
        pkg.adamw(_sched(pkg), weight_decay=0.1), 4),
    "accum2-adafactor": lambda pkg: pkg.accumulate_gradients(
        pkg.adafactor(_sched(pkg)), 2),
    "accum2-lamb-clip": lambda pkg: pkg.accumulate_gradients(
        pkg.with_grad_clipping(pkg.lamb(_sched(pkg)), 0.5), 2),
}


def _jax_skip(params):
    """JAX's skip tree for the LARS case: the bias and the scale."""
    return {"conv": {"w": False}, "lin": {"w": False, "b": True},
            "emb": {"table": False}, "ln": {"scale": True}}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_update_and_state_match_jax_over_steps(name):
    """Seven steps from the same parameters on the same gradients: every
    update, the parameters and, through the checkpoint mapping, every
    state leaf match JAX's."""
    r = np.random.RandomState(0)
    tree = _toy_tree(r)
    jopt = OPTIMIZERS[name](jax_optim)
    if name == "lars":
        jopt = jax_optim.lars(_sched(jax_optim), weight_decay=1e-4,
                              skip_fn=_jax_skip)
    topt = OPTIMIZERS[name](optim)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    toy = Toy(tree)
    tparams = dict(toy.named_parameters())
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(7):
        g = _toy_tree(r)
        jup, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, jparams)
        tup, tstate = topt.update(_to_port(_flatten(g)), tstate, tparams)
        want = _flatten(jup)
        for path, got in _port_flat(tup).items():
            assert _rel(got, want[path]) <= UPDATE_RTOL, (path, _rel(
                got, want[path]))
        jparams = jax_optim.apply_updates(jparams, jup)
        optim.apply_updates_(tparams, tup)
    got = train_state_to_jax(toy, tstate)
    want = {f"opt_state/{k}": v for k, v in _flatten(jstate).items()}
    want.update({f"variables/params/{k}": v
                 for k, v in _flatten(jparams).items()})
    assert set(got) == set(want)
    for k, w in want.items():
        if w.ndim == 0:
            assert got[k].dtype == np.int32 and int(got[k]) == int(w), k
        else:
            assert got[k].shape == w.shape, k
            assert _rel(got[k], w) <= UPDATE_RTOL, (k, _rel(got[k], w))


def test_accumulate_one_is_the_inner_optimizer():
    adamw = optim.adamw(0.01)
    assert optim.accumulate_gradients(adamw, 1) is adamw
    with pytest.raises(ValueError):
        optim.accumulate_gradients(adamw, 0)


def test_accumulate_holds_then_flushes_the_mean():
    """The hold steps' updates are exact zeros and the flush sees the
    mean: bitwise the inner optimizer on ``sum / every``."""
    p = {"w": torch.randn(4, 3)}
    gs = [torch.randn(4, 3) for _ in range(3)]
    acc = optim.accumulate_gradients(optim.sgd(0.5), 3)
    state = acc.init(p)
    for g in gs[:2]:
        up, state = acc.update({"w": g}, state, p)
        assert torch.equal(up["w"], torch.zeros(4, 3))
    up, state = acc.update({"w": gs[2]}, state, p)
    want, _ = optim.sgd(0.5).update(
        {"w": (gs[0] + gs[1] + gs[2]) / 3}, {"step": 0}, p)
    assert torch.equal(up["w"], want["w"])
    assert state["count"] == 0 and state["inner"]["step"] == 1
    assert torch.equal(state["acc"]["w"], torch.zeros(4, 3))


# ---------------------------------- Adafactor on a tiny ResNet's convs
def _resnet_pair():
    jm, params, state, sd = _jax_model("resnet")
    model = ResNet((1, 1), num_classes=10, stem="s2d", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jm, params, state, model


def _jax_resnet_run(jm, params, state, opt, batches):
    jstep = jax_make_train_step(jm, opt, _JAX_LOSS["resnet"], donate=False)
    variables = {"params": _unflatten(params), "state": _unflatten(state)}
    jstate = {"variables": variables, "opt_state": opt.init(
        variables["params"]), "rng": jax.random.PRNGKey(0)}
    losses = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, jstate


def _image_loss(logits, batch):
    return tce(logits, batch["label"])


def test_adafactor_on_a_tiny_resnet_matches_jax():
    """JAX's gradients of three batches at the tiny ResNet's weights (the
    s2d stem, 1x1 and 3x3 convs), fed to both packages' Adafactor: every
    update and state leaf within UPDATE_RTOL, the conv kernels' second
    moments factored as JAX's HWIO (vr over H, W and I, vc over H, W and
    O). Then the port's train step with it: its first loss is JAX's."""
    jm, params, state, model = _resnet_pair()
    jv = {"params": _unflatten(params), "state": _unflatten(state)}
    jopt, topt = jax_optim.adafactor(1e-3), optim.adafactor(1e-3)
    tparams = {k: p.detach().clone() for k, p in model.named_parameters()}
    jstate, tstate = jopt.init(jv["params"]), topt.init(tparams)
    batches = _batches("resnet", 3, 8)

    @jax.jit
    def jgrad(p, b):
        def jloss(p):
            out, _ = jm.apply({"params": p, "state": jv["state"]}, b,
                              training=True)
            return _JAX_LOSS["resnet"](out, b)
        return jax.grad(jloss)(p)

    for b in batches:
        jg = jgrad(jv["params"], {k: jnp.asarray(v) for k, v in b.items()})
        grads = {k: v for k, v in resnet_from_jax(_flatten(jg)).items()
                 if k in tparams}
        jup, jstate = jopt.update(jg, jstate, jv["params"])
        tup, tstate = topt.update(grads, tstate, tparams)
        want = resnet_from_jax(_flatten(jup))
        for k, t in tup.items():
            assert _rel(t.numpy(), want[k].numpy()) <= UPDATE_RTOL, k
    flat = train_state_to_jax(model, tstate)
    jslots = _flatten(jstate)
    for k, w in jslots.items():
        got = flat[f"opt_state/{k}"]
        assert got.shape == w.shape, k
        if w.ndim:
            assert _rel(got, w) <= UPDATE_RTOL, k
    assert any(k.endswith("/vr") and jslots[k].ndim == 3 for k in jslots)
    losses, _ = _jax_resnet_run(jm, params, state, jopt, batches[:1])
    step = make_train_step(model, topt, _image_loss)
    np.testing.assert_allclose(float(step(batches[0])["loss"]), losses[0],
                               rtol=LOSS_RTOL)


# -------------------------------------- nested states through checkpoints
def _nested_opt(pkg):
    return pkg.accumulate_gradients(pkg.adafactor(0.01), 2)


def test_nested_state_round_trips_npz_both_ways(tmp_path):
    """accumulate(adafactor) cut mid-window (count 1): the port's npz
    restores in JAX and JAX's in the port, every leaf bitwise."""
    jm, params, state, model = _resnet_pair()
    batches = _batches("resnet", 3, 8)
    trainer = Trainer(model, _nested_opt(optim), _image_loss,
                      checkpoint_dir=str(tmp_path / "port"), log_every=0)
    trainer.fit(iter(batches), 3)
    trainer.save()
    saved = trainer.state_dict()
    assert int(saved["opt_state/count"]) == 1
    jopt = _nested_opt(jax_optim)
    variables = {"params": _unflatten(params), "state": _unflatten(state)}
    template = {"variables": variables,
                "opt_state": jopt.init(variables["params"]),
                "rng": jax.random.PRNGKey(0)}
    restored, at = jax_ckpt.try_restore(str(tmp_path / "port"), template)
    assert at == 3
    jflat = jax_ckpt._flatten(restored)
    assert set(jflat) == set(saved)
    for k, v in saved.items():
        assert jflat[k].dtype == v.dtype, k
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)
    # JAX steps on from it, saves, and the port restores that bitwise.
    jstep = jax_make_train_step(jm, jopt, _JAX_LOSS["resnet"], donate=False)
    restored, _ = jstep(restored, {k: jnp.asarray(v) for k, v in
                                   _batches("resnet", 1, 8)[0].items()})
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), restored, 4)
    fresh = Trainer(_resnet_pair()[3], _nested_opt(optim), _image_loss,
                    checkpoint_dir=str(tmp_path / "jax"), log_every=0)
    assert fresh.initialize() == 4
    mine, theirs = fresh.state_dict(), jax_ckpt._flatten(restored)
    assert int(mine["opt_state/count"]) == 0
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


@pytest.fixture
def world1():
    """A gloo process group of one in this process."""
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _jax_zero1_state(jm, params, state, opt, dp):
    mesh = jax_parallel.make_mesh({"dp": dp}, devices=jax.devices()[:dp])
    variables = {"params": _unflatten(params), "state": _unflatten(state)}
    return mesh, {"variables": jax_parallel.replicate(mesh, variables),
                  "opt_state": jax_parallel.zero1_init_opt_state(
                      opt, variables["params"], mesh),
                  "rng": jax_parallel.replicate(mesh,
                                                jax.random.PRNGKey(0))}


def test_nested_state_round_trips_sharded_both_ways(world1, tmp_path):
    """ZeRO-1's accumulate(adafactor) chunks and counter: the port's
    per-shard save (world 1, mid-window) restores in JAX's dp=1 layout
    bitwise, and JAX's dp=2 save restores in the port at world 1, the
    chunks joined, bitwise."""
    jm, params, state, model = _resnet_pair()
    step = Zero1TrainStep(model, _nested_opt(optim), _image_loss)
    for b in _batches("resnet", 3, 8):
        step(b)
    leaves = step.shard_leaves(prng_key(0))
    tsc.save_sharded(str(tmp_path / "port"), leaves, 3, proc=0, world=1)
    jopt = _nested_opt(jax_optim)
    _, template = _jax_zero1_state(jm, params, state, jopt, 1)
    restored, at = jsc.restore_sharded(str(tmp_path / "port"), template)
    assert at == 3
    jflat = _flatten(restored)
    assert set(jflat) == set(leaves)
    for k, leaf in leaves.items():
        (_, arr), = leaf.shards
        np.testing.assert_array_equal(jflat[k], arr, err_msg=k)
    assert int(jflat["opt_state/count"]) == 1
    # JAX's dp=2 save, two steps on from the restored weights.
    mesh, jstate = _jax_zero1_state(jm, params, state, jopt, 2)
    jstep = jax_parallel.make_zero1_train_step(
        jm, jopt, _JAX_LOSS["resnet"], mesh, donate=False)
    for b in _batches("resnet", 3, 8):
        jstate, _ = jstep(jstate, jax_parallel.shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in b.items()}))
    jsc.save_sharded(str(tmp_path / "jax"), jstate, step=3)
    got, at = tsc.restore_sharded(str(tmp_path / "jax"),
                                  step.restore_request())
    step.load_chunks({k: a for k, (a, _) in got.items()
                      if k.startswith("opt_state/")})
    want = _flatten(jstate)
    assert step.opt_state["count"] == int(want["opt_state/count"]) == 1
    chunks = step.state_chunks()
    assert chunks
    for k, t in chunks.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


# ------------------------------------------- the CLI's --grad-accum
CLI = ["--config", "gpt2_124m", "--model-preset", "tiny", "--device", "cpu",
       "--batch-size", "2", "--seq-len", "32", "--log-every", "0",
       "--grad-accum", "2"]


def _final(d):
    return ckpt.verify_checkpoint(str(d), ckpt.latest_step(str(d)))


def _sharded_final(d):
    step = tsc.latest_step(str(d))
    store = tsc._ShardStore(tsc.step_dir(str(d), step))
    try:
        return {k: store.read(k, [(0, n) for n in v["shape"]])
                for k, v in store.leaves.items()}
    finally:
        store.close()


@pytest.mark.parametrize("mode", ["single", "zero1"])
def test_cli_run_cut_mid_window_resumes_equal(mode, tmp_path):
    """3 steps (the second window half full) then 3 resumed: the state
    of 6 unbroken steps, bitwise, ``acc`` and ``count`` included."""
    extra = ["--parallel", mode] + (["--mesh", "dp=1"]
                                    if mode == "zero1" else [])
    read = _sharded_final if mode == "zero1" else _final
    train_cli.run(train_cli.parse_args(CLI + extra + [
        "--steps", "6", "--ckpt-dir", str(tmp_path / "a")]))
    for _ in range(2):
        train_cli.run(train_cli.parse_args(CLI + extra + [
            "--steps", "3", "--ckpt-dir", str(tmp_path / "b")]))
    a, b = read(tmp_path / "a"), read(tmp_path / "b")
    assert set(a) == set(b) and "opt_state/count" in a
    assert "opt_state/inner/mu/wte/embedding" in a
    for k, v in a.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)


def test_cli_grad_accum_sizes_the_inner_schedule(tmp_path):
    """``--grad-accum N`` steps the inner schedule once a flush, sized to
    ``max(1, steps // N)`` updates; ``--optimizer`` factories take JAX's
    warmup+cosine over that count."""
    args = train_cli.parse_args(CLI[:-2] + ["--steps", "8", "--grad-accum",
                                            "4", "--optimizer", "sgd",
                                            "--lr", "0.1"])
    cfg = train_cli.build_config("gpt2_124m", "tiny", steps=8, device="cpu",
                                 seq_len=32)
    opt = train_cli.build_optimizer(args, cfg, "single")
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    ups = []
    for _ in range(8):
        up, state = opt.update({"w": torch.ones(3)}, state, params)
        ups.append(float(up["w"][0]))
    sched = optim.warmup_cosine_schedule(0.1, min(100, max(1, 2 // 10)),
                                         max(2, 200))
    assert ups == [0.0, 0.0, 0.0, -sched(0), 0.0, 0.0, 0.0, -sched(1)]


# ------------------------------- --grad-accum under dp and ZeRO-1, world 2
ACCUM_CASES = {"gpt2-dp2-accum": ("gpt2", ("momentum", 0.1, 0.9), "dp"),
               "bert-zero1-accum": ("bert", ("adamw", 1e-3), "zero1")}


def _jax_accum_run(spec, jm, params, state, batches):
    mesh = jax_parallel.make_mesh({"dp": 2}, devices=jax.devices()[:2])
    kind, *args = spec["opt"]
    opt = jax_optim.accumulate_gradients(
        {"momentum": jax_optim.momentum, "adamw": jax_optim.adamw}[kind](
            *args), spec["accum"])
    variables = {"params": _unflatten(params), "state": _unflatten(state)}
    rng = jax.random.PRNGKey(3)
    if spec["mode"] == "zero1":
        jstate = {"variables": jax_parallel.replicate(mesh, variables),
                  "opt_state": jax_parallel.zero1_init_opt_state(
                      opt, variables["params"], mesh),
                  "rng": jax_parallel.replicate(mesh, rng)}
        step = jax_parallel.make_zero1_train_step(
            jm, opt, _JAX_LOSS[spec["model"]], mesh, donate=False)
    else:
        jstate = jax_parallel.replicate(mesh, {
            "variables": variables, "opt_state": opt.init(
                variables["params"]), "rng": rng})
        step = jax_parallel.make_dp_train_step(
            jm, opt, _JAX_LOSS[spec["model"]], mesh, donate=False)
    losses = []
    for b in batches:
        jstate, m = step(jstate, jax_parallel.shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        losses.append(float(m["loss"]))
    return losses, jstate


@pytest.mark.parametrize("name", list(ACCUM_CASES))
def test_grad_accum_at_world2_matches_jax(name, tmp_path):
    """Four micro-steps (two flushes) at world 2 over gloo: the losses,
    every weight's change and, under ZeRO-1, each rank's chunk of the
    accumulator and moments match JAX's; the ranks agree bitwise."""
    model, opt, mode = ACCUM_CASES[name]
    spec = {"model": model, "opt": opt, "mode": mode, "clip": None,
            "accum": 2}
    jm, params, state, sd = _jax_model(model)
    batches = _batches(model, 3, 4)   # a flush, then a half window
    losses, jstate = _jax_accum_run(spec, jm, params, state, batches)
    ranks = run_world("train", 2, dict(spec, state_dict=sd,
                                       batches=batches), tmp_path)
    tol = PARALLEL_RTOL[opt[0]]
    want = {f"variables/{k}": v for k, v in
            _flatten(jstate["variables"]).items()}
    w0 = {f"variables/params/{k}": v for k, v in params.items()}
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        for k, w in want.items():
            if k in w0:
                assert _rel(r["state"][k] - w0[k], w - w0[k]) <= tol, k
            np.testing.assert_array_equal(r["state"][k],
                                          ranks[0]["state"][k], err_msg=k)
    if mode != "zero1":
        return
    jopt = _flatten(jstate["opt_state"])
    assert int(jopt["count"]) == 1
    for rank, r in enumerate(ranks):
        assert "opt_state/acc/mlm_bias" in r["chunks"]
        for key, chunk in r["chunks"].items():
            full = jopt[key[len("opt_state/"):]]
            c = full.size // 2
            assert _rel(chunk, full[rank * c:(rank + 1) * c]) <= tol, key
