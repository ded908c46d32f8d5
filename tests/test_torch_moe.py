"""The port's mixture-of-experts (``parallel/expert.py``, the MoE GPT-2,
``--moe-experts``) against the JAX package on the CPU, after
``tests/test_moe.py``, fp32:

- ``_top_k_gating``: the dispatch mask (routing, capacity places and
  drops) bitwise, a tie included; combine and aux to the softmax's last
  ulp (rtol 1e-6: torch's ``exp`` and XLA's differ in the last bit of
  about one element in ten), combine's support bitwise;
- the layer's output with ample capacity and with drops (rtol 1e-5), and
  the per-token reference loop of JAX's test;
- the MoE GPT-2's loss (rtol 1e-5) and every gradient (max error 1e-4 of
  the tensor's largest), dense and fused head; the aux in the loss;
- expert parallelism under gspmd at dp=2,ep=2 and dp=2,tp=2,ep=2 against
  JAX's gspmd step (global routing): loss rtol 1e-5, parameters after two
  AdamW steps rtol 5e-4, atol 1e-4 (AdamW divides by ``sqrt(v) + eps``:
  rounding on a near-zero gradient moves an update by up to lr);
- dp and ZeRO-1 over gloo at world 2 against JAX's dp and ZeRO-1 steps
  (each shard routes its own rows), two momentum steps: loss rtol 1e-5,
  each weight's change within 1e-4 of JAX's in relative L2 norm
  (test_torch_parallel.py's);
- the eval NLL without aux, the train-state keys of the expert leaves
  both ways, and the CLI's losses from JAX's checkpoint and its
  refusals in JAX's words."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import optim as jax_optim
from nezha_tpu import parallel as jax_parallel
from nezha_tpu.cli import train as jax_train_cli
from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu.parallel import expert as jax_expert
from nezha_tpu.parallel.gspmd import shard_batch_gspmd as jax_shard_batch
from nezha_tpu.train.eval import lm_token_stats as jax_token_stats
from nezha_tpu.train.loop import init_train_state
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.models.convert import (load_train_state,
                                            train_state_to_jax)
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.parallel.expert import (MoE, MoEConfig, ShardedMoE,
                                             _top_k_gating, dryrun_moe_step,
                                             gpt2_moe_gspmd_rules,
                                             shard_moe_params)
from nezha_tpu_torch.parallel.gspmd import (GPT2_TP_RULES, make_gspmd_mesh,
                                            make_gspmd_train_step,
                                            param_specs_from_rules)
from nezha_tpu_torch.parallel.mesh import make_mesh
from nezha_tpu_torch.train import checkpoint as ckpt
from nezha_tpu_torch.train.eval import lm_token_stats
from torch_dist_worker import run_world

KW = dict(vocab_size=128, max_positions=32, num_layers=2, num_heads=4,
          hidden_size=32, moe_experts=4)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _gpt2(**kw):
    jm = JaxGPT2(JaxGPT2Config(**{**KW, **kw}))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**{**KW, **kw}), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


def _tokens(seed=0, rows=8, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (rows, 17)) \
        .astype(np.int32)


def _within(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max() + 1e-12


# ------------------------------------------------------------ gating
def test_gating_dispatch_bitwise_with_a_tie_and_drops():
    """Rows 0-2 tie (first maximum wins in both packages); capacity 5 for
    24 tokens x top-2 over 4 experts drops tokens."""
    logits = np.random.RandomState(2).randn(24, 4).astype(np.float32)
    logits[0] = [1.0, 1.0, 0.0, 0.0]
    logits[1] = [0.5, 0.5, 0.5, 0.5]
    logits[2] = [0.0, 2.0, 2.0, -1.0]
    for cap in (5, 48):
        want = [np.asarray(a) for a in jax_expert._top_k_gating(
            jnp.asarray(logits), 2, 4, cap)]
        got = [t.numpy() for t in _top_k_gating(torch.from_numpy(logits), 2,
                                                4, cap)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1] != 0, want[1] != 0)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
        assert got[0].sum(0).max() <= 1.0
        if cap == 5:
            assert got[0].sum() < 24 * 2        # dropped over capacity
    # The tie rows: experts (0, 1), (0, 1) and (1, 2), at the first max.
    assert [list(np.nonzero(got[0][t].sum(-1))[0]) for t in range(3)] == \
        [[0, 1], [0, 1], [1, 2]]


@pytest.mark.parametrize("factor", [8.0, 0.25])
def test_layer_output_and_capacity_drops(factor):
    """The layer against JAX's, ample capacity (no drop) and capacity
    1 (drops); with ample capacity also against the per-token loop of
    JAX's test."""
    from test_moe import _ref_moe
    jcfg = jax_expert.MoEConfig(d_model=8, d_ff=16, num_experts=4, top_k=2,
                                capacity_factor=factor)
    jl = jax_expert.MoE(jcfg)
    jv = jl.init(jax.random.PRNGKey(0))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 6, 8)))
    jy, jst = jax.jit(jl.apply)(jv, jnp.asarray(x))
    layer = MoE(MoEConfig(d_model=8, d_ff=16, num_experts=4, top_k=2,
                          capacity_factor=factor), device="cpu")
    layer.load_state_dict(params_from_jax(_flatten(jv["params"])),
                          strict=True)
    assert layer.capacity(12) == jl.capacity(12)
    y, aux = layer(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jst["aux_loss"]),
                               rtol=1e-6)
    if factor > 1:
        np.testing.assert_allclose(
            y.detach().numpy(), _ref_moe(jv["params"], x, jcfg, 12),
            rtol=1e-4, atol=1e-4)


def test_ep_shards_match_one_device_and_dryrun():
    """The layer's experts split over an ep=2 mesh give the one-device
    output; the tiny dry-run step trains."""
    layer = MoE(MoEConfig(d_model=8, d_ff=16, num_experts=4,
                          capacity_factor=4.0), device="cpu")
    x = torch.randn((4, 8, 8), generator=torch.Generator().manual_seed(1))
    mesh = make_mesh({"ep": 2}, device_type="cpu")
    placed = shard_moe_params(dict(layer.named_parameters()), mesh)
    assert [tuple(t.shape) for t in placed["w_in"]] == [(2, 8, 16)] * 2
    y, aux = ShardedMoE(layer, placed["w_in"], placed["w_out"], mesh)(x)
    y1, aux1 = layer(x)
    torch.testing.assert_close(y, y1, rtol=1e-5, atol=1e-6)
    assert torch.equal(aux, aux1)
    assert np.isfinite(dryrun_moe_step(mesh, n_experts=4))


def test_routing_tape_replays_choices():
    """A tape recorded on one router replays its choices on another: the
    dispatch masks then equal the recording's, the gates are the
    replaying router's own."""
    from nezha_tpu_torch.parallel.expert import routing_tape
    x = torch.randn((2, 6, 8), generator=torch.Generator().manual_seed(3))
    a, b = (MoE(MoEConfig(d_model=8, d_ff=16, num_experts=4,
                          capacity_factor=0.5),
                generator=torch.Generator().manual_seed(s))
            for s in (0, 1))
    with routing_tape() as tape:
        _, da, _, _ = a.route(x)
    with routing_tape(tape.choices) as again:
        _, db, cb, _ = b.route(x)
    assert torch.equal(da, db) and len(again.choices) == 1
    assert torch.equal(again.choices[0][0], tape.choices[0][0])
    _, free, _, _ = b.route(x)
    assert not torch.equal(free, da)
    assert torch.equal(cb != 0, db != 0)


# ------------------------------------------------------- the MoE GPT-2
@pytest.mark.parametrize("fused", [0, -1])
def test_gpt2_moe_loss_and_grads_match_jax(fused):
    jm, jv, tm = _gpt2(fused_loss_chunk=fused)
    assert isinstance(tm.h[1].mlp, MoE) and not isinstance(tm.h[0].mlp, MoE)
    toks = _tokens(0, rows=2)

    def jloss(p):
        out, _ = jm.apply({"params": p, "state": jv["state"]},
                          {"tokens": jnp.asarray(toks)}, training=True)
        return jax_lm_loss(out, {"tokens": jnp.asarray(toks)})

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(jv["params"])
    tm.train()
    batch = {"tokens": torch.from_numpy(toks).long()}
    out = tm(batch)
    assert "aux_loss" in out and float(out["aux_loss"]) > 0
    loss = lm_loss(out, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = params_from_jax(_flatten(jgrads))
    for name, p in tm.named_parameters():
        _within(p.grad.numpy(), want[name].numpy(), 1e-4)
    # The aux is in the objective: a zero weight lowers the loss.
    zero = GPT2(GPT2Config(**KW, fused_loss_chunk=fused,
                           moe_aux_weight=0.0), device="cpu")
    zero.load_state_dict(tm.state_dict())
    zero.train()
    assert float(lm_loss(zero(batch), batch)) < float(loss)


def test_eval_nll_without_aux_and_cached_forward():
    """``lm_token_stats`` of the MoE logits dict is the NLL alone (JAX's
    eval); a forward with a cache returns plain logits."""
    jm, jv, tm = _gpt2()
    toks = _tokens(1, rows=4)
    jout, _ = jax.jit(jm.apply)(jv, {"tokens": jnp.asarray(toks)})
    want = jax_token_stats(jout, {"tokens": jnp.asarray(toks)})
    tm.eval()
    with torch.no_grad():
        out = tm({"tokens": torch.from_numpy(toks).long()})
        got = lm_token_stats(out, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(got["nll_sum"]), float(want["nll_sum"]),
                               rtol=1e-5)
    assert int(got["count"]) == int(want["count"])
    from nezha_tpu_torch.models.generate import init_cache
    with torch.no_grad():
        cache = init_cache(tm, 1, 16)
        logits = tm(torch.from_numpy(toks[:1, :4]).long(), cache=cache,
                    pos=0)
    assert torch.is_tensor(logits) and logits.shape == (1, 4, 128)


def test_train_state_keys_of_the_experts_both_ways():
    """The expert leaves keep JAX's train-state keys (variables and the
    AdamW moments) and load back bitwise."""
    jm, jv, tm = _gpt2()
    jstate = init_train_state(jm, jax_optim.adamw(1e-3),
                              jax.random.PRNGKey(0))
    opt_state = optim.adamw(1e-3).init(dict(tm.named_parameters()))
    flat = train_state_to_jax(tm, opt_state, np.asarray([0, 0], np.uint32))
    want = _flatten(jax.device_get(jstate))
    assert set(flat) == set(want)
    for key in ("variables/params/h1/mlp/router/w",
                "variables/params/h1/mlp/w_in",
                "opt_state/mu/h1/mlp/w_out"):
        assert flat[key].shape == want[key].shape
    np.testing.assert_array_equal(flat["variables/params/h1/mlp/w_in"],
                                  want["variables/params/h1/mlp/w_in"])
    _, _, back = _gpt2()
    with torch.no_grad():
        for p in back.parameters():
            p.zero_()
    load_train_state(flat, back)
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n


# ------------------------------------------------ expert parallelism
def test_moe_rules_strict_and_on_jaxs_axes():
    _, jv, tm = _gpt2()
    rules = gpt2_moe_gspmd_rules(GPT2_TP_RULES)
    specs = param_specs_from_rules(dict(tm.named_parameters()), rules,
                                   strict=True)
    jspecs = _flatten(jax_parallel.param_specs_from_rules(
        jv["params"], jax_expert.gpt2_moe_gspmd_rules(
            jax_parallel.GPT2_TP_RULES), strict=True))
    assert specs["h.1.mlp.w_in"].mesh_axis == "ep"
    assert tuple(jspecs["h1/mlp/w_in"]) == ("ep", None, None)
    assert specs["h.1.mlp.router.w"].axis is None
    assert specs["h.0.mlp.fc.w"].axis == 1


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 1, "ep": 2},
                                  {"dp": 2, "tp": 2, "ep": 2}])
def test_ep_step_matches_jax_gspmd(devices8, axes):
    """Two AdamW steps under gspmd with the experts over ep; the gating
    sees the whole batch (JAX's global routing: one capacity from all 128
    tokens)."""
    jm, jv, tm = _gpt2()
    jopt = jax_optim.adamw(1e-3, weight_decay=0.0)
    state0 = init_train_state(jm, jopt, jax.random.PRNGKey(0))
    n = axes["dp"] * axes["tp"] * axes["ep"]
    jmesh = jax_parallel.make_mesh(axes, devices=jax.devices()[:n])
    jspecs = jax_parallel.param_specs_from_rules(
        state0["variables"]["params"],
        jax_expert.gpt2_moe_gspmd_rules(jax_parallel.GPT2_TP_RULES),
        strict=True)
    jstep = jax_parallel.make_gspmd_train_step(jm, jopt, jax_lm_loss, jmesh,
                                               jspecs, donate=False)
    jstate = jax_parallel.shard_train_state(state0, jmesh, jspecs)
    step = make_gspmd_train_step(tm, optim.adamw(1e-3, weight_decay=0.0),
                                 lm_loss, make_gspmd_mesh(
                                     axes, device_type="cpu"))
    assert isinstance(step.tp_model.h[1].mlp, ShardedMoE)
    assert step.params["h.1.mlp.w_in@1"].shape == (2, 32, 128)
    for i in range(2):
        b = {"tokens": _tokens(i)}
        jstate, jm_ = jstep(jstate, jax_shard_batch(
            jmesh, {k: jnp.asarray(v) for k, v in b.items()}))
        m = step({k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    want = params_from_jax(_flatten(jax.device_get(
        jstate["variables"]["params"])))
    for name, t in step.gathered_variables().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=1e-4, err_msg=name)
    leaves = step.shard_leaves(np.asarray([0, 1], np.uint32))
    assert [idx[0] for idx, _ in
            leaves["variables/params/h1/mlp/w_in"].shards] == [(0, 2),
                                                               (2, 4)]


def _jax_world(mode, params, batches, world=2):
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW, moe_experts=4))
    mesh = jax_parallel.make_mesh({"dp": world},
                                  devices=jax.devices()[:world])
    opt = jax_optim.momentum(0.1, 0.9)
    from test_torch_parallel import _unflatten
    variables = {"params": _unflatten(params), "state": {}}
    rng = jax.random.PRNGKey(3)
    if mode == "zero1":
        jstate = {"variables": jax_parallel.replicate(mesh, variables),
                  "opt_state": jax_parallel.zero1_init_opt_state(
                      opt, variables["params"], mesh),
                  "rng": jax_parallel.replicate(mesh, rng)}
        step = jax_parallel.make_zero1_train_step(jm, opt, jax_lm_loss, mesh,
                                                  donate=False)
    else:
        jstate = jax_parallel.replicate(mesh, {
            "variables": variables, "opt_state": opt.init(
                variables["params"]), "rng": rng})
        step = jax_parallel.make_dp_train_step(jm, opt, jax_lm_loss, mesh,
                                               donate=False)
    losses = []
    for b in batches:
        jstate, m = step(jstate, jax_parallel.shard_batch(
            mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        losses.append(float(m["loss"]))
    return losses, _flatten(jax.device_get(jstate["variables"]["params"]))


@pytest.mark.parametrize("mode", ["dp", "zero1"])
def test_dp_and_zero1_world2_route_locally_as_jax(devices8, mode,
                                                  tmp_path):
    """Each rank routes its own rows, with a capacity from its local
    tokens, as JAX's dp and ZeRO-1 steps do inside shard_map."""
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW, moe_experts=4))
    params = _flatten(jm.init(jax.random.PRNGKey(0))["params"])
    sd = {k: v.numpy() for k, v in params_from_jax(params).items()}
    rs = np.random.RandomState(7)
    batches = [{"tokens": rs.randint(0, 512, (4, 33)).astype(np.int32)}
               for _ in range(2)]
    want_losses, want = _jax_world(mode, params, batches)
    ranks = run_world("train", 2, {"model": "gpt2_moe", "mode": mode,
                                   "opt": ("momentum", 0.1, 0.9),
                                   "clip": None,
                                   "state_dict": sd, "batches": batches},
                      tmp_path)
    np.testing.assert_allclose(ranks[0]["losses"], want_losses, rtol=1e-5)
    got = ranks[0]["state"]
    for path, w in want.items():
        w0, g = params[path], got[f"variables/params/{path}"]
        dw = np.linalg.norm(w - w0)
        assert np.linalg.norm((g - w0) - (w - w0)) <= 1e-4 * dw + 1e-9, path
    for key, a in ranks[1]["state"].items():
        np.testing.assert_array_equal(a, got[key])


# --------------------------------------------------------------- CLI
BASE = ["--config", "gpt2_124m", "--model-preset", "tiny", "--batch-size",
        "4", "--seq-len", "32", "--moe-experts", "4"]


def test_cli_moe_from_jax_checkpoint_gives_jax_loss(devices8, tmp_path,
                                                    capsys):
    """JAX's CLI trains two steps, saving each; from its step-1
    checkpoint the port's CLI trains step 2 on the same batch (rtol
    1e-5), single-device and under gspmd at dp=2,tp=1,ep=2."""
    jd = tmp_path / "jax"
    jax_train_cli.main(BASE + ["--parallel", "single", "--steps", "2",
                               "--ckpt-dir", str(jd), "--ckpt-every", "1",
                               "--log-every", "1", "--metrics-file",
                               str(tmp_path / "m.jsonl")])
    want = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    want = {r["step"]: r["loss"] for r in want if "loss" in r}
    mine = tmp_path / "port"
    mine.mkdir()
    shutil.copy(ckpt.checkpoint_path(str(jd), 1), mine)
    last = train_cli.run(train_cli.parse_args(
        BASE + ["--device", "cpu", "--parallel", "single", "--steps", "1",
                "--ckpt-dir", str(mine), "--log-every", "0"]))
    assert "resumed from step 1" in capsys.readouterr().err
    assert last["step"] == 2
    np.testing.assert_allclose(last["loss"], want[2], rtol=1e-5)
    got = ckpt.verify_checkpoint(str(mine), 2)
    assert "variables/params/h3/mlp/w_in" in got
    last = train_cli.run(train_cli.parse_args(
        BASE + ["--device", "cpu", "--parallel", "gspmd", "--mesh",
                "dp=2,tp=1,ep=2", "--steps", "2", "--log-every", "0"]))
    assert np.isfinite(last["loss"])


@pytest.mark.parametrize("argv", [
    ["--config", "resnet50_imagenet", "--moe-experts", "4"],
    BASE + ["--parallel", "pp"],
    BASE + ["--parallel", "gspmd", "--mesh", "dp=1,tp=1,ep=3"],
    BASE + ["--parallel", "gspmd", "--mesh", "dp=1,tp=2"],
])
def test_cli_moe_refusals_are_jax_words(devices8, argv, capsys):
    with pytest.raises(SystemExit) as e:
        jax_train_cli.main(argv + ["--steps", "1"])
    want = str(e.value.code)
    assert want and not want.isdigit()
    with pytest.raises(SystemExit) as e:
        train_cli.run(train_cli.parse_args(argv + ["--steps", "1",
                                                   "--device", "cpu"]))
    assert want in str(e.value.code) + capsys.readouterr().err
