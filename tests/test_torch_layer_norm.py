"""The fused LayerNorm (``ln_impl="pallas"``) in the port against the JAX
package on the CPU: the kernels' plain versions against the Pallas
kernels in interpret mode (``fused_layer_norm``, forward and custom-VJP
backward, whose summed dscale and dbias the port's backward returns), the
GPT-2 layer against JAX's under ``NEZHA_LN_INTERPRET=1``, and one
tiny-preset train step's loss and gradients; and the kernels' launch
plans (``fwd_plan``, ``bwd_plan``) and the checks their C entry points
make (``check_fwd_plan``, ``check_bwd_plan``).

Tolerance: ``layer_norm_error_bound`` (``ops/cuda/layer_norm.py``), the
elementwise bound on two fp32 evaluations of the same formulas in other
summation orders, plus one bf16 rounding of each side's output where x is
bf16 — the bound the card holds the kernels to. It is pinned here against
float64 arithmetic, and a one-pass variance breaks it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.models.gpt2 import lm_loss as jax_lm_loss
from nezha_tpu.nn import LayerNorm as JaxLayerNorm
from nezha_tpu.ops.pallas.layer_norm import \
    fused_layer_norm as jax_fused_layer_norm
from nezha_tpu.tensor import bf16_policy as jax_bf16_policy
from nezha_tpu_torch.models import GPT2, GPT2Config, lm_loss, params_from_jax
from nezha_tpu_torch.models.convert import params_to_jax
from nezha_tpu_torch.nn import LayerNorm
from nezha_tpu_torch.ops.cuda import (fused_layer_norm, layer_norm_bwd,
                                      layer_norm_fwd)
from nezha_tpu_torch.ops.cuda.layer_norm import (BWD_BLOCKS_PER_SM,
                                                 BWD_WARPS,
                                                 FWD_BLOCKS_PER_SM,
                                                 FWD_MANY_WARPS, H100_SMS,
                                                 BwdPlan, FwdPlan,
                                                 bwd_plan, check_bwd_plan,
                                                 check_fwd_plan, fwd_plan,
                                                 layer_norm_error_bound)
from nezha_tpu_torch.optim import adamw
from nezha_tpu_torch.tensor.policy import bf16_policy
from nezha_tpu_torch.train import make_train_step

EPS = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(rows, d, seed):
    rng = np.random.RandomState(seed)
    # Rows with their own offsets and spreads, as residual streams have.
    x = (rng.randn(rows, d) * rng.uniform(0.5, 3.0, (rows, 1))
         + rng.randn(rows, 1) * 2).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(d)).astype(np.float32)
    bias = (0.2 * rng.randn(d)).astype(np.float32)
    dy = rng.randn(rows, d).astype(np.float32)
    return x, scale, bias, dy


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within(got, want, bound, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = np.asarray(bound, np.float64)
    assert np.all(err <= bound), (
        f"{what}: max |port - jax| / bound {np.max(err / bound):.3f}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d", [(37, 64), (300, 96)])
def test_plain_matches_pallas_kernels(rows, d, dtype):
    """y, dx, dscale and dbias of the plain versions against JAX's fused
    LayerNorm (its forward kernel and the custom VJP's backward kernel
    with the sums of its partials, interpret mode), each within
    layer_norm_error_bound: the backward returns dscale and dbias summed,
    fp32 ``[D]``, as the custom VJP does."""
    tdt, jdt = DTYPES[dtype]
    x, scale, bias, dy = _inputs(rows, d, seed=rows + d)
    jx = jnp.asarray(x, jdt)
    y, vjp = jax.vjp(lambda a, s, b: jax_fused_layer_norm(
        a, s, b, eps=EPS, interpret=True), jx, jnp.asarray(scale),
        jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(dy, jdt))

    tx, tdy = (torch.from_numpy(a).to(tdt) for a in (x, dy))
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    got_y = layer_norm_fwd(tx, ts, tb, EPS)
    dx, ds, db = layer_norm_bwd(tx, ts, tdy, EPS)
    assert got_y.dtype == dx.dtype == tdt
    assert ds.shape == db.shape == (d,) == jds.shape == jdb.shape
    assert ds.dtype == db.dtype == torch.float32
    _within(got_y.float(), _np(y), layer_norm_error_bound(tx, ts, tb, EPS),
            "y")
    bounds = layer_norm_error_bound(tx, ts, tb, EPS, dy=tdy)
    for name, got, want, bd in zip(("dx", "dscale", "dbias"),
                                   (dx.float(), ds, db),
                                   (jdx, jds, jdb), bounds):
        _within(got, _np(want), bd, name)


def test_autograd_function_matches_raw_entry_points():
    """fused_layer_norm's backward is layer_norm_bwd, its dscale and
    dbias returned as they are (fp32, as scale and bias are); x keeps its
    shape."""
    x, scale, bias, dy = _inputs(2 * 7, 64, seed=5)
    tx = torch.from_numpy(x).reshape(2, 7, 64).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y = fused_layer_norm(tx, ts, tb, EPS)
    assert y.shape == (2, 7, 64)
    y.backward(torch.from_numpy(dy).reshape(2, 7, 64))
    dx, ds, db = layer_norm_bwd(tx.detach().reshape(14, 64), ts.detach(),
                                torch.from_numpy(dy), EPS)
    assert torch.equal(tx.grad.reshape(14, 64), dx)
    assert torch.equal(ts.grad, ds)
    assert torch.equal(tb.grad, db)


def test_error_bound_holds_against_float64_and_is_tight():
    """The plain version (fp32) against the same formulas in float64 stays
    within the bound, on rows whose mean is 300 times their spread; a
    one-pass variance, E[x^2] - mean^2 in fp32, breaks it."""
    rng = np.random.RandomState(7)
    x = (300 + rng.randn(16, 64)).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(64)).astype(np.float32)
    bias = (0.2 * rng.randn(64)).astype(np.float32)
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    bound = layer_norm_error_bound(tx, ts, tb, EPS).numpy()
    xd = x.astype(np.float64)
    var = ((xd - xd.mean(-1, keepdims=True)) ** 2).mean(-1, keepdims=True)
    exact = ((xd - xd.mean(-1, keepdims=True)) / np.sqrt(var + EPS) * scale
             + bias)
    _within(layer_norm_fwd(tx, ts, tb, EPS).numpy(), exact, bound, "plain")
    mean = tx.mean(-1, keepdim=True)
    one_pass = (tx.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0)
    mutant = (tx - mean) * torch.rsqrt(one_pass + EPS) * ts + tb
    assert np.any(np.abs(mutant.numpy() - exact) > bound)


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_gpt2_layer_matches_jax_pallas_layer(policy, monkeypatch):
    """LayerNorm(impl="pallas") against JAX's nn.LayerNorm(impl="pallas")
    with its kernel forced on the CPU: under the bf16 policy both cast x
    to bf16 before the kernel and return bf16."""
    monkeypatch.setenv("NEZHA_LN_INTERPRET", "1")
    x, scale, bias, _ = _inputs(24, 64, seed=11)
    if policy == "bf16":
        jln = JaxLayerNorm(64, policy=jax_bf16_policy(), impl="pallas")
        tln = LayerNorm(64, policy=bf16_policy(), device="cpu",
                        impl="pallas")
    else:
        jln = JaxLayerNorm(64, impl="pallas")
        tln = LayerNorm(64, device="cpu", impl="pallas")
    want, _ = jln.apply({"params": {"scale": jnp.asarray(scale),
                                    "bias": jnp.asarray(bias)},
                         "state": {}}, jnp.asarray(x).reshape(2, 12, 64))
    with torch.no_grad():
        tln.scale.copy_(torch.from_numpy(scale))
        tln.bias.copy_(torch.from_numpy(bias))
        got = tln(torch.from_numpy(x).reshape(2, 12, 64))
    assert got.dtype == (torch.bfloat16 if policy == "bf16"
                         else torch.float32)
    bound = layer_norm_error_bound(
        torch.from_numpy(x).to(got.dtype), tln.scale.detach(),
        tln.bias.detach(), EPS)
    _within(got.float().reshape(24, 64), _np(want).reshape(24, 64), bound,
            "layer")


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def test_train_step_with_fused_layer_norm_matches_jax(monkeypatch):
    """One tiny-preset step (f32, flash attention, ln_impl="pallas") from
    the same weights and batch: the loss within 1e-5 and every gradient
    within 1e-6 + 1e-4 of its tensor's largest magnitude, the tolerances
    of tests/test_torch_train.py (the same f32 formulas in other
    summation orders)."""
    monkeypatch.setenv("NEZHA_LN_INTERPRET", "1")
    kw = dict(TINY_GPT2_KW, attn_impl="flash", ln_impl="pallas",
              fused_loss_chunk=-1)
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
    tm = GPT2(GPT2Config(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    step = make_train_step(tm, adamw(6e-4), lm_loss)
    loss, grads = step.loss_and_grads({"tokens": tokens})
    assert abs(loss.item() - float(jl)) <= 1e-5
    want = _flatten(jg)
    got = params_to_jax(grads)
    assert set(got) == set(want)
    for path, g in got.items():
        scale = float(np.abs(want[path]).max())
        np.testing.assert_allclose(g, want[path], rtol=0,
                                   atol=1e-6 + 1e-4 * scale, err_msg=path)


def test_ln_impl_pallas_builds_and_unknown_impls_refused():
    model = GPT2(GPT2Config(**TINY_GPT2_KW, ln_impl="pallas"), device="cpu")
    assert {m.impl for m in model.modules()
            if isinstance(m, LayerNorm)} == {"pallas"}
    assert sum(isinstance(m, LayerNorm) for m in model.modules()) == 9
    for bad in ({"ln_impl": "cudnn"}, {"decode_impl": "flash"}):
        with pytest.raises(ValueError, match="unknown"):
            GPT2(GPT2Config(**TINY_GPT2_KW, **bad), device="cpu")
    with pytest.raises(ValueError, match="impl"):
        LayerNorm(8, device="cpu", impl="triton")


# The rows the forward gets (one row; generate's decode step of 8; an odd
# count; one per SM; generate's prefill; a train step) and the widths it
# takes (the narrowest; GPT-2's; the widest; one short of it, whose last
# chunk only some lanes hold).
PLAN_ROWS = (1, 8, 37, 132, 4096, 8192)
PLAN_D = (8, 64, 768, 1016, 1024)


def _refused(plan, rows, d, dtype, sms=H100_SMS):
    with pytest.raises(ValueError, match="plan"):
        check_fwd_plan(plan, rows, d, dtype, sms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", PLAN_D)
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_fwd_plan_fits_every_accepted_shape(rows, d, dtype):
    """Every accepted (rows, D, dtype) gets a geometry the entry check
    takes: a lane holds exactly its row's 16-byte chunks (1-4 for bf16,
    1-8 for f32, a build of each), a row per block up to one row per SM,
    else a grid of 8-warp blocks, at most FWD_BLOCKS_PER_SM an SM, whose
    warps take every row once and the same number of rows up to one. Any
    other geometry is refused: another lane width, block size or grid."""
    plan = fwd_plan(rows, d, dtype)
    check_fwd_plan(plan, rows, d, dtype)
    vec = 16 // dtype.itemsize
    chunks = d // vec
    assert (plan.cpl - 1) * 32 < chunks <= plan.cpl * 32
    assert plan.cpl <= (4 if dtype == torch.bfloat16 else 8)
    warps = plan.blocks * plan.warps
    if rows <= H100_SMS:
        assert plan == FwdPlan(plan.cpl, 1, rows)
    else:
        assert plan.warps == FWD_MANY_WARPS
        assert plan.blocks <= H100_SMS * FWD_BLOCKS_PER_SM
    # The kernel's walk: warp w takes rows w, w + warps, ...
    taken = sorted(r for w in range(warps) for r in range(w, rows, warps))
    assert taken == list(range(rows))
    per_warp = [len(range(w, rows, warps)) for w in range(warps)]
    assert max(per_warp) - min(per_warp) <= 1
    bad = [dataclasses.replace(plan, cpl=plan.cpl + 1),
           dataclasses.replace(plan, blocks=0),
           dataclasses.replace(plan, blocks=plan.blocks + 1),
           dataclasses.replace(plan, blocks=-(-rows // plan.warps) + 1)]
    bad += [dataclasses.replace(plan, warps=w) for w in (2, 3, 4, 8, 16)
            if w != plan.warps]
    if plan.cpl > 1:
        bad.append(dataclasses.replace(plan, cpl=plan.cpl - 1))
    if plan.blocks > 1:
        bad.append(dataclasses.replace(plan, blocks=plan.blocks - 1))
    for other in bad:
        _refused(other, rows, d, dtype)


def test_fwd_plan_follows_the_card_and_refuses_other_widths():
    """The plan's few-rows limit is the card's SM count, and the entry
    check takes the plan for its own card only; a width past the kernel's
    1024 is refused whatever the plan."""
    assert fwd_plan(100, 768, torch.bfloat16, sms=64).warps == FWD_MANY_WARPS
    assert fwd_plan(64, 768, torch.bfloat16, sms=64) == FwdPlan(3, 1, 64)
    check_fwd_plan(FwdPlan(3, 1, 64), 64, 768, torch.bfloat16, sms=64)
    _refused(FwdPlan(3, 1, 64), 64, 768, torch.bfloat16, sms=32)
    _refused(fwd_plan(8192, 768, torch.bfloat16, sms=64), 8192, 768,
             torch.bfloat16)
    _refused(FwdPlan(5, 1, 8), 8, 1032, torch.bfloat16)
    _refused(FwdPlan(9, 1, 8), 8, 1032, torch.float32)


# The rows the backward gets: PLAN_ROWS and one past a train step's, whose
# last row a warp takes as its ninth.
BWD_PLAN_ROWS = PLAN_ROWS + (8193,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", PLAN_D)
@pytest.mark.parametrize("rows", BWD_PLAN_ROWS)
def test_bwd_plan_fits_every_accepted_shape(rows, d, dtype):
    """Every accepted (rows, D, dtype) gets a backward geometry the entry
    check takes: a lane holds exactly its row's 16-byte chunks, blocks of
    BWD_WARPS warps, as many as the rows fill and at most
    BWD_BLOCKS_PER_SM an SM (a grid resident at once), whose
    warps take every row once and the same number of rows up to one. Any
    other geometry is refused."""
    plan = bwd_plan(rows, d, dtype)
    check_bwd_plan(plan, rows, d, dtype)
    chunks = d // (16 // dtype.itemsize)
    assert (plan.cpl - 1) * 32 < chunks <= plan.cpl * 32
    assert plan.warps == BWD_WARPS
    assert plan.blocks <= H100_SMS * BWD_BLOCKS_PER_SM
    warps = plan.blocks * plan.warps
    # Every warp but the last block's spares takes a row.
    assert warps - BWD_WARPS < rows or plan.blocks == 1
    taken = sorted(r for w in range(warps) for r in range(w, rows, warps))
    assert taken == list(range(rows))
    per_warp = [len(range(w, rows, warps)) for w in range(warps)]
    assert max(per_warp) - min(per_warp) <= 1
    bad = [dataclasses.replace(plan, cpl=plan.cpl + 1),
           dataclasses.replace(plan, blocks=0),
           dataclasses.replace(plan, blocks=plan.blocks + 1)]
    bad += [dataclasses.replace(plan, warps=w) for w in (1, 4, 16)]
    if plan.cpl > 1:
        bad.append(dataclasses.replace(plan, cpl=plan.cpl - 1))
    if plan.blocks > 1:
        bad.append(dataclasses.replace(plan, blocks=plan.blocks - 1))
    for other in bad:
        with pytest.raises(ValueError, match="backward plan"):
            check_bwd_plan(other, rows, d, dtype)


def test_bwd_plan_follows_the_card_and_refuses_other_widths():
    """The backward's grid fills at most the card's SMs, and the entry
    check takes the plan for its own card only; a width past the
    kernel's 1024 is refused whatever the plan."""
    per_sm = BWD_BLOCKS_PER_SM
    assert bwd_plan(8192, 768, torch.bfloat16) == BwdPlan(3, 8, 132 * per_sm)
    assert bwd_plan(8192, 768, torch.bfloat16, sms=64) == BwdPlan(
        3, 8, 64 * per_sm)
    assert bwd_plan(37, 768, torch.float32) == BwdPlan(6, 8, 5)
    check_bwd_plan(BwdPlan(3, 8, 64 * per_sm), 8192, 768, torch.bfloat16,
                   sms=64)
    with pytest.raises(ValueError, match="backward plan"):
        check_bwd_plan(BwdPlan(3, 8, 64 * per_sm), 8192, 768,
                       torch.bfloat16)
    for d, dtype in ((1032, torch.bfloat16), (1032, torch.float32)):
        with pytest.raises(ValueError, match="backward plan"):
            check_bwd_plan(bwd_plan(8, d, dtype), 8, d, dtype)
