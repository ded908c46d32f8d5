"""The port's training slice against the JAX package on the CPU: the tiny
GPT-2 preset in f32 with JAX's weights carried across by
``params_from_jax``, flash attention (the port's plain versions, JAX's
Pallas kernels in interpret mode), ``fused_loss_chunk`` -1 and 0.

Tolerances:

- loss and gradients: both sides compute the same f32 formulas in other
  summation orders — loss within 1e-5, every gradient element within
  1e-6 + 1e-4 of its tensor's largest magnitude;
- optimizer pieces on identical gradients: the same f32 formulas
  element by element; the clip's norm is summed in another order (one
  ulp of the scale), and an update that is a small difference of m
  across five steps amplifies that to ~25 ulps — rtol 1e-5;
- parameters after one full step: the first AdamW update is
  ``lr * m / (sqrt(v) + eps)`` = ``lr * g / (|g| + eps)`` up to weight
  decay, so where a gradient element is near eps (rounding noise on a
  gradient that is zero in exact arithmetic, such as the key bias's), a
  last-bit difference in it moves the update by up to ``2 * lr``. Every
  element is held to that. Where JAX's gradient exceeds 100 * eps, the
  update's sensitivity ``lr * eps / (|g| + eps)^2`` is below 1% of lr
  per unit of relative gradient error, and those elements are held to
  ``1e-3 * lr``.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu import optim as jax_optim
from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.data.synthetic import (
    synthetic_token_batches as jax_synthetic_token_batches)
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu.train.loop import make_train_step as jax_make_train_step
from nezha_tpu_torch import optim
from nezha_tpu_torch.data import synthetic_token_batches
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import GPT2, GPT2Config, lm_loss, params_from_jax
from nezha_tpu_torch.models.convert import params_to_jax
from nezha_tpu_torch.nn import Dropout, resolve_device
from nezha_tpu_torch.ops.losses import lm_ce_from_fused
from nezha_tpu_torch.train import Trainer, make_train_step

LR = 6e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


@pytest.fixture(scope="module", params=[-1, 0], ids=["fused", "logits"])
def step_pair(request):
    """JAX's loss, gradients and parameters after one AdamW step, and the
    port's, from the same weights and batch."""
    chunk = request.param
    kw = dict(TINY_GPT2_KW, attn_impl="flash", fused_loss_chunk=chunk)
    jm = JaxGPT2(JaxGPT2Config(**kw))
    jv = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(1).randint(0, 512, (2, 33)).astype(
        np.int32)
    jbatch = {"tokens": jnp.asarray(tokens)}

    def jloss(params):
        out, _ = jm.apply({"params": params, "state": jv["state"]}, jbatch,
                          training=True, rng=jax.random.PRNGKey(1))
        return jax_lm_loss(out, jbatch)

    jl, jg = jax.value_and_grad(jloss)(jv["params"])
    jopt = jax_optim.adamw(LR, weight_decay=0.1)
    jstep = jax_make_train_step(jm, jopt, jax_lm_loss, donate=False)
    jstate, jmetrics = jstep({"variables": jv, "opt_state":
                              jopt.init(jv["params"]),
                              "rng": jax.random.PRNGKey(1)}, jbatch)

    tm = GPT2(GPT2Config(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    step = make_train_step(tm, optim.adamw(LR, weight_decay=0.1), lm_loss)
    loss, grads = step.loss_and_grads({"tokens": tokens})
    metrics = step({"tokens": tokens})
    return {"jax_loss": float(jl), "jax_step_loss": float(jmetrics["loss"]),
            "jax_grads": _flatten(jg),
            "jax_params": _flatten(jstate["variables"]["params"]),
            "loss": loss.item(), "step_loss": metrics["loss"].item(),
            "grads": params_to_jax(grads),
            "params": params_to_jax(step.params)}


def test_loss_matches_jax(step_pair):
    assert abs(step_pair["loss"] - step_pair["jax_loss"]) <= 1e-5
    assert abs(step_pair["step_loss"] - step_pair["jax_step_loss"]) <= 1e-5


def test_every_gradient_matches_jax(step_pair):
    want = step_pair["jax_grads"]
    assert set(step_pair["grads"]) == set(want)
    for path, g in step_pair["grads"].items():
        scale = float(np.abs(want[path]).max())
        np.testing.assert_allclose(g, want[path], rtol=0,
                                   atol=1e-6 + 1e-4 * scale, err_msg=path)


def test_params_after_one_step_match_jax(step_pair):
    want = step_pair["jax_params"]
    n_clear = n_all = 0
    for path, p in step_pair["params"].items():
        diff = np.abs(p - want[path])
        assert diff.max() <= 2 * LR, path
        clear = np.abs(step_pair["jax_grads"][path]) > 100 * 1e-8
        assert diff[clear].max(initial=0.0) <= 1e-3 * LR, path
        n_clear += int(clear.sum())
        n_all += clear.size
    assert n_clear > 0.5 * n_all     # the tight check covers most weights


def _opt_trees(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(6, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-9, 0, v.shape)
                  ).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_schedule_and_clipping_match_jax(clip):
    """Five AdamW updates with warmup-cosine lr, the 1-D decay mask and
    (optionally) global-norm clipping, on identical gradients."""
    params, grads = _opt_trees(0)
    jopt = jax_optim.adamw(jax_optim.warmup_cosine_schedule(1e-2, 2, 6),
                           weight_decay=0.1,
                           mask=jax_optim.matrix_decay_mask)
    topt = optim.adamw(optim.warmup_cosine_schedule(1e-2, 2, 6),
                       weight_decay=0.1, mask=optim.matrix_decay_mask)
    if clip:
        jopt = jax_optim.with_grad_clipping(jopt, clip)
        topt = optim.with_grad_clipping(topt, clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-12, err_msg=k)
        jp = jax_optim.apply_updates(jp, ju)
        optim.apply_updates_(tp, tu)
    assert ts["step"] == int(js["step"]) == len(grads)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9)


def test_global_norm_and_clip_match_jax():
    _, grads = _opt_trees(1)
    g = grads[0]
    jn = jax_optim.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    tn = optim.global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    jc, _ = jax_optim.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 0.1)
    tc, _ = optim.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 0.1)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


def test_adam_is_adamw_without_decay():
    params, grads = _opt_trees(2)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tu, _ = optim.adam(1e-3).update(
        {k: torch.from_numpy(v) for k, v in grads[0].items()},
        optim.adam(1e-3).init(tp), tp)
    jopt = jax_optim.adam(1e-3)
    ju, _ = jopt.update({k: jnp.asarray(v) for k, v in grads[0].items()},
                        jopt.init(jp), jp)
    for k in params:
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)),
    ("cosine_decay_schedule", (1e-3, 50, 0.1)),
    ("linear_warmup_schedule", (1e-3, 10)),
    ("warmup_cosine_schedule", (6e-4, 100, 200)),
])
def test_schedules_match_jax(name, args):
    jsched = getattr(jax_optim, name)(*args)
    tsched = getattr(optim, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 99, 100, 101, 150, 199, 200, 250):
        np.testing.assert_allclose(tsched(step),
                                   float(jsched(jnp.asarray(step))),
                                   rtol=1e-6, err_msg=f"step {step}")


def test_matrix_decay_mask_matches_jax():
    params, _ = _opt_trees(3)
    want = jax_optim.matrix_decay_mask(
        {k: jnp.asarray(v) for k, v in params.items()})
    got = optim.matrix_decay_mask(
        {k: torch.from_numpy(v) for k, v in params.items()})
    assert got == {k: bool(v) for k, v in want.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_losses_match_jax(dtype):
    """The fused-head CE (compute-dtype logits, fp32 logsumexp) and the
    dense-logit CE against JAX's on the same inputs. In bf16 both sides
    round the same bf16 products of the same inputs, so only the fp32
    reduction order differs: 1e-5 relative, as in f32."""
    from nezha_tpu.ops import losses as jax_losses
    from nezha_tpu_torch.ops import losses

    rng = np.random.RandomState(5)
    hidden = rng.randn(2, 7, 16).astype(np.float32)
    emb = (rng.randn(40, 16) * 0.3).astype(np.float32)
    targets = rng.randint(0, 40, (2, 7)).astype(np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_losses.lm_cross_entropy_from_hidden(
        jnp.asarray(hidden, jdt), jnp.asarray(emb), jnp.asarray(targets))
    got = losses.lm_cross_entropy_from_hidden(
        torch.from_numpy(hidden).to(tdt), torch.from_numpy(emb),
        torch.from_numpy(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    logits = hidden @ emb.T
    want = jax_losses.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(targets))
    got = losses.softmax_cross_entropy_with_integer_labels(
        torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_synthetic_token_batches_match_jax():
    for seed in (0, 3):
        ours = synthetic_token_batches(2, seq_len=16, vocab_size=512,
                                       seed=seed)
        theirs = jax_synthetic_token_batches(2, seq_len=16, vocab_size=512,
                                             seed=seed)
        for _ in range(5):
            a, b = next(ours), next(theirs)
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_dropout_distribution():
    """Kept fraction within 6 binomial sigmas of 1 - rate, kept values
    exactly x / (1 - rate), the rest zero; the identity at rate 0 and in
    eval mode; a seeded generator repeats its masks."""
    rate, n = 0.1, 200_000
    x = torch.rand(n) + 1.0
    drop = Dropout(rate, torch.Generator().manual_seed(0))
    y = drop(x)
    kept = y != 0
    frac = kept.float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(frac - (1 - rate)) <= 6 * sigma
    assert torch.equal(y[kept], x[kept] / (1 - rate))
    again = Dropout(rate, torch.Generator().manual_seed(0))(x)
    assert torch.equal(y, again)
    assert Dropout(0.0)(x) is x
    drop.eval()
    assert drop(x) is x


def test_model_dropout_only_in_training():
    cfg = GPT2Config(**TINY_GPT2_KW, dropout=0.2)
    model = GPT2(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(2).randint(0, 512,
                                                               (2, 16)))
    plain = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    plain.load_state_dict(model.state_dict())
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(tokens), plain(tokens))
        model.train()
        a, b = model(tokens), model(tokens)
    assert not torch.equal(a, b)
    assert torch.isfinite(a).all()


def test_cli_train_tiny_on_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "nezha_tpu_torch.cli.train", "--config",
         "gpt2_124m", "--model-preset", "tiny", "--device", "cpu",
         "--steps", "3", "--seq-len", "32", "--batch-size", "2"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr
    final = json.loads(proc.stdout.strip().splitlines()[-1])["final"]
    assert final["step"] == 3
    assert math.isfinite(final["loss"]) and 0 < final["loss"] < 10


def test_cli_refuses_unported_flags_and_configs():
    from nezha_tpu_torch.cli.train import parse_args

    assert parse_args(["--config", "gpt2_124m"]).device == "cuda"
    for argv in (["--mesh", "2"], ["--ckpt-dir=/x"], ["--remat"],
                 ["--config", "bert_base_zero1"]):
        if argv[0] != "--config":
            argv = ["--config", "gpt2_124m"] + argv
        with pytest.raises(SystemExit):
            parse_args(argv)


@pytest.mark.parametrize("knob", [
    {"moe_experts": 4}, {"scan_layers": True}, {"remat": True},
    {"attn_impl": "ring"}, {"attn_impl": "ulysses"},
    {"attn_impl": "flash_shmap"}, {"fused_loss_chunk": 1},
    {"fused_loss_chunk": 128}])
def test_unported_model_knobs_raise(knob):
    with pytest.raises(NotPortedError):
        GPT2(GPT2Config(**TINY_GPT2_KW, **knob), device="cpu")


def test_unported_trainer_options_and_loss_chunk_raise():
    model = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    for opt in ({"checkpoint_dir": "/tmp/x"}, {"step_fn": lambda *a: None},
                {"shard_fn": lambda b: b}, {"save_fn": lambda *a: None},
                {"failure_mode": "rejoin"}):
        with pytest.raises(NotPortedError):
            Trainer(model, optim.adamw(LR), lm_loss, **opt)
    with pytest.raises(NotPortedError):
        lm_ce_from_fused({"hidden": None, "wte": None, "chunk": 128}, None)
    assert issubclass(NotPortedError, ValueError)


def test_entry_points_default_to_cuda():
    """Without a device or generator the model builds on the card; the CPU
    is used only when asked for. (Resolved, not built: this machine may
    have no card.)"""
    assert resolve_device().type == "cuda"
    assert resolve_device("cpu").type == "cpu"
    assert resolve_device(None, torch.Generator()).type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            GPT2(GPT2Config(**TINY_GPT2_KW))


def test_trainer_fit_logs_rates():
    model = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    logged = []
    trainer = Trainer(model, optim.adamw(LR, weight_decay=0.1), lm_loss,
                      log_every=2, metric_logger=lambda s, m: logged.append(m),
                      examples_per_step=2)
    last = trainer.fit(synthetic_token_batches(2, seq_len=16,
                                               vocab_size=512), 4)
    assert [m["step"] for m in logged] == [2, 4]
    assert last["tokens_per_sec"] == last["steps_per_sec"] * 2 * 17
    assert last["tokens_per_sec_per_chip"] == last["tokens_per_sec"]
    assert all(math.isfinite(m["loss"]) for m in logged)
