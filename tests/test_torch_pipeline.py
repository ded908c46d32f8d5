"""Pipeline parallelism in the port (``parallel/pipeline.py``, the train
CLI's ``--parallel pp``) against the JAX package on the CPU, each test of
``tests/test_pipeline.py`` held to JAX's own function on the same weights
(the port's mesh the CPU repeated, JAX's the suite's forced host
devices), fp32:

- the pipelined forward at dp=2,pp=4 and dp=1,pp=2 against JAX's
  ``pipelined_forward`` (rtol 2e-4, JAX's test's), and for every
  microbatch count;
- the split/merge round trip and the stacked leaves, bitwise;
- two steps against JAX's ``make_pipeline_train_step`` at pp=4 (dp=2) and
  pp=2: AdamW and the fused head (loss rtol 1e-4, parameters rtol 2e-4,
  atol 5e-5); LARS, LAMB and Adafactor, whose statistics span the
  stacked leaf (rtol 2e-4, atol 1e-4; Adafactor without the key bias,
  whose gradient is zero in exact arithmetic);
- dropout: rate 0 equals the deterministic step bitwise, rate 0.5 moves
  the loss and stays finite, remat equals no remat bitwise (the masks
  replayed); remat against JAX's remat step at rate 0; the refusals
  (MoE, dropout without rng, layers over pp, batch over microbatches);
- a pipeline save read by JAX's ``restore_sharded`` and JAX's read by the
  port, every leaf bitwise; the converters' ``pparams`` keys;
- the CLI: from JAX's step-1 pipeline checkpoint, the port's step 2
  (rtol 1e-5); a save, resume and eval; the inference CLIs' refusal;
  the refusals in JAX's words."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import optim as jax_optim
from nezha_tpu import parallel as jax_parallel
from nezha_tpu.cli import train as jax_train_cli
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu.parallel import pipeline as jpp
from nezha_tpu.train import sharded_checkpoint as jax_sck
from nezha_tpu_torch import optim
from nezha_tpu_torch.cli import train as train_cli
from nezha_tpu_torch.cli.common import restore_variables_any
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.models.convert import (pipeline_params_from_jax,
                                            pipeline_params_to_jax)
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.parallel import pipeline as pp
from nezha_tpu_torch.train import sharded_checkpoint as sck

KW = dict(vocab_size=64, max_positions=16, num_heads=2, hidden_size=32)


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _gpt2(num_layers=4, **kw):
    cfg = dict(KW, num_layers=num_layers, **kw)
    jm = JaxGPT2(JaxGPT2Config(**cfg))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


def _batch(seed=0, bs=8):
    return {"tokens": np.random.RandomState(seed).randint(0, 64, (bs, 9))
            .astype(np.int32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _mesh(dp, p):
    return pp.make_pipeline_mesh({"dp": dp, "pp": p}, device_type="cpu")


def _jmesh(dp, p):
    return jax_parallel.make_mesh({"dp": dp, "pp": p},
                                  devices=jax.devices()[:dp * p])


def _step(tm, dp, p, opt=None, m=2, **kw):
    return pp.make_pipeline_train_step(
        tm, pp.gpt2_pipeline_spec(tm), opt or optim.adamw(1e-3), lm_loss,
        _mesh(dp, p), m, **kw)


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("dp,p", [(2, 4), (1, 2)])
def test_pipelined_forward_matches_jax(devices8, dp, p):
    jm, jv, tm = _gpt2()
    spec = jpp.gpt2_pipeline_spec(jm)
    outer, blocks = spec.split(jv["params"])
    pparams = {"outer": outer, "blocks": jpp.stack_block_params(blocks)}
    want = jax.jit(lambda q: jpp.pipelined_forward(
        spec, q, _jb(_batch()), _jmesh(dp, p), num_microbatches=2))(pparams)
    step = _step(tm, dp, p)
    with torch.no_grad():
        got = step.forward(_tb(_batch()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_forward_does_not_depend_on_microbatches():
    step = _step(_gpt2(num_layers=2)[2], 1, 2)
    outs = []
    for m in (1, 2, 4, 8):
        step.num_microbatches = m
        with torch.no_grad():
            outs.append(step.forward(_tb(_batch())))
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_split_merge_round_trip_and_stacked_leaves():
    """split -> stack -> unstack -> merge is the identity; the step's
    slabs are the stacked leaves cut by stage; the merged weights equal
    the model's; the converters carry JAX's ``pparams`` keys."""
    jm, jv, tm = _gpt2()
    names = {k: v.detach().clone() for k, v in tm.named_parameters()}
    spec = pp.gpt2_pipeline_spec(tm)
    outer, blocks = spec.split(names)
    merged = pp.merge_pipeline_params(spec, {
        "outer": outer, "blocks": pp.stack_block_params(blocks)})
    assert merged.keys() == names.keys()
    for k in names:
        assert torch.equal(merged[k], names[k]), k
    step = _step(tm, 1, 2)
    assert step.params["blocks.attn.qkv.w@1"].shape == (2, 32, 96)
    assert tm.h[0].attn.qkv.w.numel() == 0      # released to the slabs
    for k, v in step.merged_variables().items():
        assert torch.equal(v, names[k]), k
    jspec = jpp.gpt2_pipeline_spec(jm)
    jo, jb = jspec.split(jv["params"])
    want = {f"pparams/{k}": v for k, v in _flatten(
        {"outer": jo, "blocks": jpp.stack_block_params(jb)}).items()}
    got = pipeline_params_to_jax(step.pipeline_params())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = pipeline_params_from_jax(got)
    assert torch.equal(back["blocks"]["attn.qkv.w"],
                       step.pipeline_params()["blocks"]["attn.qkv.w"])
    assert torch.equal(step.sync_model().h[3].mlp.fc.w, names["h.3.mlp.fc.w"])


# ------------------------------------------------------- steps vs JAX
def _jax_steps(jm, jv, jopt, dp, p, batches, m=2, **kw):
    mesh = _jmesh(dp, p)
    spec = jpp.gpt2_pipeline_spec(jm)
    state = jpp.init_pipeline_state(jv, spec, jopt, mesh,
                                    jax.random.PRNGKey(0))
    step = jpp.make_pipeline_train_step(spec, jopt, jax_lm_loss, mesh,
                                        num_microbatches=m, donate=False,
                                        **kw)
    losses = []
    for b in batches:
        state, met = step(state, _jb(b))
        losses.append(float(met["loss"]))
    return losses, state, spec


@pytest.mark.parametrize("dp,p,fused", [(2, 4, 0), (1, 2, 0), (2, 4, -1)])
def test_adamw_steps_match_jax(devices8, dp, p, fused):
    jm, jv, tm = _gpt2(fused_loss_chunk=fused)
    batches = [_batch(0), _batch(1)]
    want, jstate, jspec = _jax_steps(jm, jv, jax_optim.adamw(1e-3), dp, p,
                                     batches)
    step = _step(tm, dp, p)
    got = [float(step(_tb(b))["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    wparams = params_from_jax(_flatten(jax.device_get(
        jpp.merge_pipeline_params(jspec, jstate["pparams"]))))
    for k, v in step.merged_variables().items():
        np.testing.assert_allclose(v.numpy(), wparams[k].numpy(), rtol=2e-4,
                                   atol=5e-5, err_msg=k)


@pytest.mark.parametrize("name", ["lars", "lamb", "adafactor"])
def test_whole_leaf_optimizers_match_jax(devices8, name):
    """LARS's and LAMB's trust ratios and Adafactor's factored moments
    over the whole stacked leaf, across the stages. Adafactor's key-bias
    third is left out: its gradient is zero in exact arithmetic (a key
    bias shifts a row's logits alike), and Adafactor (eps 1e-30 on g**2)
    turns each package's rounding noise there into a full-size step of
    its own sign."""
    jm, jv, tm = _gpt2()
    jopt = getattr(jax_optim, name)(1e-3)
    batches = [_batch(0), _batch(1)]
    want, jstate, jspec = _jax_steps(jm, jv, jopt, 1, 2, batches)
    step = _step(tm, 1, 2, getattr(optim, name)(1e-3))
    assert not step.optimizer.elementwise
    got = [float(step(_tb(b))["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    wparams = params_from_jax(_flatten(jax.device_get(
        jpp.merge_pipeline_params(jspec, jstate["pparams"]))))
    for k, v in step.merged_variables().items():
        v, w = v.numpy(), wparams[k].numpy()
        if name == "adafactor" and k.endswith("attn.qkv.b"):
            h = v.shape[0] // 3
            v, w = np.delete(v, np.s_[h:2 * h]), np.delete(w, np.s_[h:2 * h])
        np.testing.assert_allclose(v, w, rtol=2e-4, atol=1e-4, err_msg=k)


# ------------------------------------------------------------ dropout
def test_dropout_plumbing_identity_at_rate_zero_and_trains():
    """Seeds at rate 0 change nothing (bitwise); at rate 0.5 the loss
    leaves the deterministic one, moves between steps, stays finite."""
    _, _, tm = _gpt2()
    _, _, tm2 = _gpt2()
    det, sto = _step(tm, 2, 4), _step(tm2, 2, 4, dropout_rng=True)
    assert float(det(_tb(_batch()))["loss"]) == \
        float(sto(_tb(_batch()))["loss"])
    _, _, tm = _gpt2(dropout=0.5)
    with torch.no_grad():
        det_loss = float(lm_loss(tm(_tb(_batch())), _tb(_batch())))
    step = _step(tm, 2, 4, dropout_rng=True)
    losses = []
    for i in range(3):
        tm.drop.generator.manual_seed(100 + i)     # a step's seed
        losses.append(float(step(_tb(_batch()))["loss"]))
    assert np.isfinite(losses).all()
    assert abs(losses[0] - det_loss) > 1e-3 and losses[0] != losses[1]


def test_remat_equals_no_remat_bitwise_and_jax():
    """Per-stage checkpointing changes memory, not math: with dropout 0.3
    the losses and updated weights equal the plain step's bitwise (the
    recompute replays the masks); at rate 0 the remat step matches JAX's
    remat step."""
    runs = []
    for remat in (False, True):
        _, _, tm = _gpt2(dropout=0.3)
        step = _step(tm, 2, 4, dropout_rng=True, remat=remat)
        assert step.remat == remat
        losses = []
        for i in range(2):
            tm.drop.generator.manual_seed(7 + i)
            losses.append(float(step(_tb(_batch()))["loss"]))
        runs.append((losses, step.merged_variables()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    jm, jv, tm = _gpt2(remat=True)
    want, _, _ = _jax_steps(jm, jv, jax_optim.adamw(1e-3), 2, 4,
                            [_batch(0), _batch(1)])
    step = _step(tm, 2, 4)
    assert step.remat             # the spec's, from the model config
    got = [float(step(_tb(b))["loss"]) for b in (_batch(0), _batch(1))]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_refusals():
    """JAX's: a MoE model, dropout without rng, layers not divisible by
    pp, a local batch not divisible by the microbatches; and a dp group
    on other devices (one process a group)."""
    _, _, moe = _gpt2(num_layers=2, moe_experts=4)
    with pytest.raises(ValueError, match="MoE"):
        pp.gpt2_pipeline_spec(moe)
    _, _, tm = _gpt2(dropout=0.1)
    with pytest.raises(ValueError, match="dropout_rng=True"):
        _step(tm, 2, 4)
    _, _, tm = _gpt2(num_layers=3)
    with pytest.raises(ValueError, match="3 layers not divisible by pp=2"):
        _step(tm, 1, 2)
    _, _, tm = _gpt2()
    with pytest.raises(ValueError, match="not divisible by num_microbatches"):
        _step(tm, 2, 2, m=3)(_tb(_batch()))
    with pytest.raises(NotPortedError, match="A7"):
        pp.make_pipeline_mesh({"dp": 2, "pp": 1}, devices=["cpu", "meta"],
                              device_type="cpu")


# -------------------------------------------------------------- saves
def test_pipeline_save_crosses_packages_both_ways(devices8, tmp_path):
    jm, jv, tm = _gpt2()
    step = _step(tm, 1, 2)
    step(_tb(_batch()))
    leaves = step.shard_leaves(np.asarray([0, 3], np.uint32))
    qkv = leaves["pparams/blocks/attn/qkv/w"]
    assert [idx[0] for idx, _ in qkv.shards] == [(0, 2), (2, 4)]
    sck.save_sharded(str(tmp_path / "port"), leaves, 1)
    mesh = _jmesh(1, 2)
    spec = jpp.gpt2_pipeline_spec(jm)
    template = jpp.init_pipeline_state(jv, spec, jax_optim.adamw(1e-3),
                                       mesh, jax.random.PRNGKey(0))
    restored, at = jax_sck.restore_sharded(str(tmp_path / "port"), template)
    assert at == 1
    flat = _flatten(jax.device_get(restored))
    assert flat.keys() == {k for k in leaves}
    for k, leaf in leaves.items():
        whole = np.zeros(leaf.shape, flat[k].dtype)
        for idx, a in leaf.shards:
            whole[tuple(slice(lo, hi) for lo, hi in idx)] = a
        np.testing.assert_array_equal(flat[k], whole, err_msg=k)
    # JAX's save, the port's restore.
    jax_sck.save_sharded(str(tmp_path / "jax"), restored, 5)
    _, _, tm2 = _gpt2()
    step2 = _step(tm2, 1, 2)
    arrays, at = sck.restore_sharded(str(tmp_path / "jax"),
                                     step2.restore_request())
    step2.load_restored({k: a for k, (a, _) in arrays.items()})
    assert at == 5 and step2.opt_state["step"] == 1
    for k, v in step2.merged_variables().items():
        assert torch.equal(v, step.merged_variables()[k]), k
    # The inference CLIs name the layout.
    with pytest.raises(SystemExit, match="pipeline layout"):
        restore_variables_any(str(tmp_path / "port"),
                              GPT2(GPT2Config(**KW, num_layers=4),
                                   device="cpu"))


# ---------------------------------------------------------------- CLI
BASE = ["--config", "gpt2_124m", "--model-preset", "tiny", "--batch-size",
        "4", "--seq-len", "32", "--parallel", "pp", "--mesh", "dp=1,pp=2",
        "--microbatches", "2"]


def _port(argv):
    return train_cli.run(train_cli.parse_args(argv + ["--device", "cpu"]))


def test_cli_pp_from_jax_checkpoint_then_resume_and_eval(devices8, tmp_path,
                                                         capsys):
    """JAX's CLI trains two pipelined steps, saving each; from its step-1
    save the port's CLI trains step 2 on the same batch (rtol 1e-5), saves
    (JAX's keys), resumes for a third and evaluates the merged weights."""
    jd = tmp_path / "jax"
    jax_train_cli.main(BASE + ["--steps", "2", "--ckpt-dir", str(jd),
                               "--ckpt-every", "1", "--log-every", "1",
                               "--metrics-file", str(tmp_path / "m.jsonl")])
    want = {r["step"]: r["loss"] for r in map(
        json.loads, (tmp_path / "m.jsonl").read_text().splitlines())
        if "loss" in r}
    import shutil
    mine = tmp_path / "port"
    shutil.copytree(sck.step_dir(str(jd), 1), sck.step_dir(str(mine), 1))
    last = _port(BASE + ["--steps", "1", "--ckpt-dir", str(mine),
                         "--log-every", "0"])
    assert "resumed from step 1 (sharded)" in capsys.readouterr().err
    assert last["step"] == 2
    np.testing.assert_allclose(last["loss"], want[2], rtol=1e-5)
    assert "pparams/blocks/attn/qkv/w" in sck.checkpoint_keys(str(mine), 2)
    last = _port(BASE + ["--steps", "1", "--ckpt-dir", str(mine),
                         "--log-every", "0", "--eval", "--eval-batches",
                         "1"])
    assert last["step"] == 3 and np.isfinite(last["eval_perplexity"])
    last = _port(BASE + ["--steps", "1", "--remat", "--log-every", "0"])
    assert np.isfinite(last["loss"])


@pytest.mark.parametrize("argv", [
    BASE + ["--wd-exclude-1d"],
    ["--config", "bert_base_zero1", "--model-preset", "tiny", "--parallel",
     "pp", "--mesh", "dp=1,pp=2"],
    BASE[:-4] + ["--mesh", "dp=1,tp=2"],
    BASE[:-4] + ["--mesh", "pp=2"],
])
def test_cli_pp_refusals_are_jax_words(devices8, argv, capsys):
    with pytest.raises(SystemExit) as e:
        jax_train_cli.main(argv + ["--steps", "1"])
    want = str(e.value.code)
    assert want and not want.isdigit()
    with pytest.raises(SystemExit) as e:
        _port(argv + ["--steps", "1"])
    assert want in str(e.value.code) + capsys.readouterr().err


def test_cli_pp_port_refusals():
    """pp across processes is not ported; a batch the microbatches do not
    divide exits with JAX's step error."""
    with pytest.raises(NotPortedError, match="across processes"):
        train_cli._run_world(train_cli.parse_args(
            BASE + ["--device", "cpu", "--coordinator", "127.0.0.1:1"]))
    with pytest.raises(SystemExit, match="not divisible by num_microbatches"):
        _port(BASE + ["--microbatches", "3", "--steps", "1"])
