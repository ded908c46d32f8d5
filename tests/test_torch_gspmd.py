"""Tensor-parallel training in the port (``parallel/gspmd.py``, the train
CLI's ``--parallel gspmd``) against the JAX package, after
``tests/test_gspmd.py``, on its tiny GPT-2 (vocab 128, 2 layers, 4 heads,
hidden 32) and tiny BERT in fp32; the port's mesh is the CPU repeated,
JAX's the suite's forced host devices:

- the rule tables: each leaf split on JAX's axis, strict coverage of
  GPT-2 and BERT, loud failure, the optimizer state following its
  parameter's split;
- one step against JAX's ``make_gspmd_train_step`` at ``dp=2,tp=4`` and
  ``dp=1,tp=2`` on JAX's weights: loss ``rtol=1e-4``, updated parameters
  ``rtol=5e-4, atol=5e-5`` (JAX's own tolerances);
- ``attn_impl="flash_shmap"`` for GPT-2 and for BERT with right-padded
  rows (``kv_lengths``): three steps against JAX's single-device
  composed step (``rtol=1e-3``); BERT's padding-mask rules; the
  LayerNorm kernels' plain versions under gspmd; the scope's per-head-
  group flash for a plain model;
- a tensor-parallel save read by JAX's ``restore_sharded`` into its gspmd
  layout, JAX's gspmd save restored by the port, and a save restored
  onto one device (the generate CLI's loader) equal to the gathered
  state bitwise;
- the CLI on ``--device cpu`` (GPT-2 with a save and a resume, BERT at
  ``dp=2,tp=2`` with its eval) and the refusals that remain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import optim as jax_optim
from nezha_tpu import parallel as jax_parallel
from nezha_tpu.models.bert import Bert as JaxBert
from nezha_tpu.models.bert import BertConfig as JaxBertConfig
from nezha_tpu.models.bert import mlm_loss as jax_mlm_loss
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu.parallel.gspmd import shard_batch_gspmd as jax_shard_batch
from nezha_tpu.train import sharded_checkpoint as jax_sck
from nezha_tpu.train.loop import init_train_state
from nezha_tpu.train.loop import make_train_step as jax_make_train_step
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli.common import restore_variables_any
from nezha_tpu_torch.cli.train import main as train_main
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import (GPT2, GPT2Config, bert_from_jax,
                                    params_from_jax)
from nezha_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
from nezha_tpu_torch.models.convert import _to_jax_path
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.parallel import make_mesh
from nezha_tpu_torch.parallel.gspmd import (BERT_TP_RULES, GPT2_TP_RULES,
                                            auto_partitioner_scope,
                                            make_gspmd_mesh,
                                            make_gspmd_train_step,
                                            opt_state_specs,
                                            param_specs_from_rules)
from nezha_tpu_torch.train import sharded_checkpoint as sck

KW = dict(vocab_size=128, max_positions=32, num_layers=2, num_heads=4,
          hidden_size=32)
LR = 1e-3


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _gpt2(**kw):
    jm = JaxGPT2(JaxGPT2Config(**KW, **kw))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**KW, **kw), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, tm


def _bert(**kw):
    jm = JaxBert(JaxBertConfig(**KW, **kw))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = Bert(BertConfig(**KW, **kw), device="cpu")
    tm.load_state_dict(bert_from_jax(_flatten(jv["params"])), strict=True)
    return jm, tm


def _lm_batch():
    return {"tokens": np.random.RandomState(0).randint(
        0, 128, (8, 17)).astype(np.int32)}


def _mlm_batch():
    rs = np.random.RandomState(0)
    return {"tokens": rs.randint(0, 128, (8, 16)).astype(np.int32),
            "labels": np.where(rs.rand(8, 16) < 0.3,
                               rs.randint(0, 128, (8, 16)),
                               -100).astype(np.int32),
            "kv_lengths": np.asarray([16, 12, 16, 9, 16, 16, 5, 16],
                                     np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _mesh(dp, tp):
    return make_gspmd_mesh({"dp": dp, "tp": tp}, device_type="cpu")


def _jax_tp_axis(spec):
    return next((i for i, a in enumerate(spec) if a == "tp"), None)


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("model", ["gpt2", "bert"])
def test_rules_split_every_leaf_on_jaxs_axis(model):
    """Strict coverage of both tables; each port leaf splits on the axis
    JAX's spec puts ``tp`` on (qkv by whole heads, its fused groups), the
    embedding by vocabulary."""
    jm, tm = (_gpt2 if model == "gpt2" else _bert)()
    jrules = (jax_parallel.GPT2_TP_RULES if model == "gpt2"
              else jax_parallel.BERT_TP_RULES)
    rules = GPT2_TP_RULES if model == "gpt2" else BERT_TP_RULES
    specs = param_specs_from_rules(dict(tm.named_parameters()), rules,
                                   strict=True)
    jspecs = _flatten_specs(jax_parallel.param_specs_from_rules(
        jm.init(jax.random.PRNGKey(0))["params"], jrules, strict=True))
    assert len(specs) == len(jspecs)
    for name, split in specs.items():
        assert split.axis == _jax_tp_axis(jspecs[_to_jax_path(name)]), name
        assert split.groups == (3 if ".qkv." in name else 1)


def _flatten_specs(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten_specs(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = val
    return out


def test_strict_rules_fail_loudly_and_opt_state_follows():
    _, tm = _gpt2()
    params = dict(tm.named_parameters())
    params["h.0.attn.qkv_renamed.w"] = params.pop("h.0.attn.qkv.w")
    with pytest.raises(ValueError, match="qkv_renamed"):
        param_specs_from_rules(params, GPT2_TP_RULES, strict=True)
    with pytest.raises(ValueError, match="matching no parameter"):
        param_specs_from_rules({"w": torch.zeros(2, 2)},
                               [(r"^w$", GPT2_TP_RULES[0][1]),
                                (r"^gone$", GPT2_TP_RULES[1][1])],
                               strict=True)
    specs = {"w": GPT2_TP_RULES[0][1], "b": GPT2_TP_RULES[7][1]}
    state = optim.accumulate_gradients(optim.adamw(LR), 4).init(
        {"w": torch.zeros(4, 6), "b": torch.zeros(6)})
    got = opt_state_specs(state, specs)
    assert got["acc"] == specs and got["inner"]["mu"] == specs
    assert got["inner"]["nu"] == specs and got["count"].axis is None
    assert got["inner"]["step"].axis is None


# ------------------------------------------------------- step vs JAX
@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 2)])
def test_gspmd_step_matches_jax(devices8, dp, tp):
    jm, tm = _gpt2()
    jopt = jax_optim.adamw(LR, weight_decay=0.0)
    state0 = init_train_state(jm, jopt, jax.random.PRNGKey(0))
    jmesh = jax_parallel.make_mesh({"dp": dp, "tp": tp},
                                   devices=jax.devices()[:dp * tp])
    jspecs = jax_parallel.param_specs_from_rules(
        state0["variables"]["params"], jax_parallel.GPT2_TP_RULES)
    jstep = jax_parallel.make_gspmd_train_step(
        jm, jopt, jax_lm_loss, jmesh, jspecs, donate=False)
    batch = _lm_batch()
    jstate, jmet = jstep(jax_parallel.shard_train_state(state0, jmesh,
                                                        jspecs),
                         jax_shard_batch(jmesh, {k: jnp.asarray(v) for k, v
                                                 in batch.items()}))
    step = make_gspmd_train_step(tm, optim.adamw(LR, weight_decay=0.0),
                                 lm_loss, _mesh(dp, tp))
    met = step(_torch_batch(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    want = params_from_jax(_flatten(jax.device_get(
        jstate["variables"]["params"])))
    got = step.gathered_variables()
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)
    # The split leaves hold one tp-th each; the model's whole tensors
    # were released.
    qkv = [p for k, p in step.params.items()
           if k.startswith("h.0.attn.qkv.w@")]
    assert len(qkv) == tp and qkv[0].shape == (32, 96 // tp)
    assert tm.h[0].attn.qkv.w.numel() == 0


def _three_losses(step, batch):
    return [float(step(batch)["loss"]) for _ in range(3)]


def test_flash_shmap_gpt2_and_varlen_bert_match_jax_single(devices8):
    """``flash_shmap`` under gspmd (dp=2, tp=4): three AdamW steps of
    GPT-2 and of BERT with right-padded rows equal JAX's single-device
    composed steps (rtol 1e-3, JAX's test's)."""
    for build, loss, jloss, batch in (
            (_gpt2, lm_loss, jax_lm_loss, _lm_batch()),
            (_bert, mlm_loss, jax_mlm_loss, _mlm_batch())):
        jm, _ = build(attn_impl="xla", fused_loss_chunk=-1)
        _, tm = build(attn_impl="flash_shmap", fused_loss_chunk=-1)
        jopt = jax_optim.adamw(1e-2, weight_decay=0.0)
        js = init_train_state(jm, jopt, jax.random.PRNGKey(0))
        jstep = jax_make_train_step(jm, jopt, jloss)
        want = []
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for _ in range(3):
            js, m = jstep(js, jb)
            want.append(float(m["loss"]))
        step = make_gspmd_train_step(
            tm, optim.adamw(1e-2, weight_decay=0.0), loss, _mesh(2, 4))
        np.testing.assert_allclose(_three_losses(step, _torch_batch(batch)),
                                   want, rtol=1e-3)


def test_bert_mask_rules_and_ln_kernels_under_gspmd(devices8):
    """BERT keeps JAX's mask rules under gspmd ("auto" with a padding
    mask is composed, "flash_shmap" with one raises ValueError); GPT-2
    with the LayerNorm kernels' plain versions (``ln_impl="pallas"``)
    steps as JAX's gspmd step does with composed LayerNorms."""
    batch = _mlm_batch()
    lens = batch.pop("kv_lengths")
    batch["padding_mask"] = np.arange(16)[None, :] < lens[:, None]
    for impl in ("auto", "flash_shmap"):
        _, tm = _bert(attn_impl=impl)
        step = make_gspmd_train_step(tm, optim.adamw(LR), mlm_loss,
                                     _mesh(1, 2))
        if impl == "auto":
            assert np.isfinite(float(step(_torch_batch(batch))["loss"]))
        else:
            with pytest.raises(ValueError, match="padding mask"):
                step(_torch_batch(batch))
    jm, _ = _gpt2()
    _, tm = _gpt2(ln_impl="pallas")
    jopt = jax_optim.adamw(LR, weight_decay=0.0)
    state0 = init_train_state(jm, jopt, jax.random.PRNGKey(0))
    jmesh = jax_parallel.make_mesh({"dp": 1, "tp": 2},
                                   devices=jax.devices()[:2])
    jspecs = jax_parallel.param_specs_from_rules(
        state0["variables"]["params"], jax_parallel.GPT2_TP_RULES)
    _, jmet = jax_parallel.make_gspmd_train_step(
        jm, jopt, jax_lm_loss, jmesh, jspecs, donate=False)(
        jax_parallel.shard_train_state(state0, jmesh, jspecs),
        {k: jnp.asarray(v) for k, v in _lm_batch().items()})
    step = make_gspmd_train_step(tm, optim.adamw(LR, weight_decay=0.0),
                                 lm_loss, _mesh(1, 2))
    np.testing.assert_allclose(float(step(_torch_batch(_lm_batch()))
                                     ["loss"]), float(jmet["loss"]),
                               rtol=1e-4)


def test_scope_runs_flash_per_head_group():
    """Inside ``auto_partitioner_scope`` a plain model's ``flash_shmap``
    is the flash kernels on each of the mesh's head groups: the same
    logits as ``flash`` (both plain versions here); outside it JAX's
    ValueError."""
    _, flash = _gpt2()
    _, shmap = _gpt2(attn_impl="flash_shmap")
    toks = torch.from_numpy(_lm_batch()["tokens"][:, :-1]).long()
    with pytest.raises(ValueError, match="auto_partitioner_scope"):
        shmap(toks)
    with auto_partitioner_scope(make_mesh({"tp": 2}, device_type="cpu")):
        got = shmap(toks)
    torch.testing.assert_close(got, flash(toks), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the saves
def test_tp_save_crosses_packages_both_ways(devices8, tmp_path):
    """The port's tensor-parallel save (JAX's keys and shards) restores
    into JAX's gspmd layout, every leaf equal; JAX's gspmd save restores
    into the port's step, parameters and moments equal; a save restored
    onto one device (the generate CLI's loader) is the gathered state,
    bitwise."""
    jm, tm = _gpt2()
    step = make_gspmd_train_step(tm, optim.adamw(LR), lm_loss, _mesh(1, 2))
    step(_torch_batch(_lm_batch()))
    rng = np.asarray([0, 3], np.uint32)
    leaves = step.shard_leaves(rng)
    qkv = leaves["variables/params/h0/attn/qkv/w"]
    assert [idx for idx, _ in qkv.shards] == [((0, 32), (0, 48)),
                                              ((0, 32), (48, 96))]
    sck.save_sharded(str(tmp_path / "port"), leaves, 1)
    jopt = jax_optim.adamw(LR)
    jstate = init_train_state(jm, jopt, jax.random.PRNGKey(0))
    jmesh = jax_parallel.make_mesh({"dp": 1, "tp": 2},
                                   devices=jax.devices()[:2])
    jspecs = jax_parallel.param_specs_from_rules(
        jstate["variables"]["params"], jax_parallel.GPT2_TP_RULES)
    template = jax_parallel.shard_train_state(jstate, jmesh, jspecs)
    restored, at = jax_sck.restore_sharded(str(tmp_path / "port"), template)
    assert at == 1
    got = step.gathered_variables()
    want = params_from_jax(_flatten(jax.device_get(
        restored["variables"]["params"])))
    for name, t in got.items():
        np.testing.assert_array_equal(want[name].numpy(), t.numpy())
    mu = params_from_jax(_flatten(jax.device_get(
        restored["opt_state"]["mu"])))
    port_mu = step._logical(step.opt_state["mu"])
    for name in got:
        np.testing.assert_array_equal(mu[name].numpy(),
                                      port_mu[name].numpy())
    # JAX's save, the port's restore.
    jax_sck.save_sharded(str(tmp_path / "jax"), restored, 7)
    _, tm2 = _gpt2()
    step2 = make_gspmd_train_step(tm2, optim.adamw(LR), lm_loss,
                                  _mesh(1, 2))
    arrays, at = sck.restore_sharded(str(tmp_path / "jax"),
                                     step2.restore_request())
    step2.load_restored({k: a for k, (a, _) in arrays.items()})
    assert at == 7 and step2.opt_state["step"] == 1
    for name, t in step2.gathered_variables().items():
        np.testing.assert_array_equal(t.numpy(), got[name].numpy())
    # Onto one device.
    one = GPT2(GPT2Config(**KW), device="cpu")
    assert restore_variables_any(str(tmp_path / "port"), one) == 1
    for name, p in one.named_parameters():
        assert torch.equal(p.detach(), got[name]), name


# ---------------------------------------------------------------- CLI
def _cli(argv):
    return train_main(["--model-preset", "tiny", "--device", "cpu",
                       "--log-every", "0", "--prefetch", "1"] + argv)


def test_cli_gspmd_on_cpu(tmp_path, capsys):
    """GPT-2 at tp=2 with a save, its resume and its eval; the steps'
    losses equal single-device mode's (rtol 1e-4); BERT at dp=2,tp=2
    with its eval."""
    ck = str(tmp_path / "ck")
    base = ["--config", "gpt2_124m", "--batch-size", "4", "--steps", "2"]
    assert _cli(base + ["--parallel", "gspmd", "--mesh", "dp=1,tp=2",
                        "--ckpt-dir", ck, "--eval", "--eval-batches",
                        "1"]) == 0
    tp_final = _final(capsys)
    assert sck.latest_step(ck) == 2
    assert _cli(base + ["--parallel", "single"]) == 0
    np.testing.assert_allclose(tp_final["loss"], _final(capsys)["loss"],
                               rtol=1e-4)
    assert np.isfinite(tp_final["eval_perplexity"])
    assert _cli(["--config", "gpt2_124m", "--batch-size", "4", "--steps",
                 "1", "--parallel", "gspmd", "--mesh", "dp=1,tp=2",
                 "--ckpt-dir", ck]) == 0
    assert _final(capsys)["step"] == 3
    assert _cli(["--config", "bert_base_zero1", "--batch-size", "4",
                 "--steps", "2", "--parallel", "gspmd", "--mesh",
                 "dp=2,tp=2", "--attn-impl", "flash_shmap", "--eval",
                 "--eval-batches", "1"]) == 0
    assert np.isfinite(_final(capsys)["eval_perplexity"])


def _final(capsys):
    import json
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])["final"]


@pytest.mark.parametrize("argv,match", [
    (["--optimizer", "lamb", "--lr", "1e-3"], "statistics over whole"),
    (["--mesh", "dp=1,sp=2"], "cannot use mesh axis"),
    (["--mesh", "dp=2"], "needs mesh axis"),
    (["--mesh", "dp=1,tp=-1"], "visible cards"),
    (["--mesh", "dp=1,tp=3"], "not divisible by tp=3")])
def test_cli_gspmd_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        _cli(["--config", "gpt2_124m", "--parallel", "gspmd",
              "--steps", "1"] + argv)


def test_refusals_that_remain():
    """dp groups on other devices than group 0's (one process a group),
    typed; a flag only gspmd consumes outside it; a sequence-parallel
    attention on BERT, which has no sequence-parallel model (JAX's
    exit)."""
    with pytest.raises(NotPortedError, match="A7"):
        make_gspmd_mesh({"dp": 2, "tp": 1},
                        devices=["cpu", "meta"], device_type="cpu")
    for argv in (["--attn-impl", "flash_shmap"],
                 ["--shard-device", "cpu"]):
        with pytest.raises(SystemExit):
            _cli(["--config", "gpt2_124m"] + argv)
    with pytest.raises(SystemExit, match="no sequence-parallel model"):
        _cli(["--config", "bert_base_zero1", "--attn-impl", "ring"])
