"""Flash attention for training: the port's ``flash_block_fwd`` /
``flash_block_bwd`` (their plain versions, on CPU tensors) and its
``flash_attention`` autograd function against the JAX Pallas kernels in
interpret mode, on the same numpy inputs. The CUDA kernels are held
against the plain versions on the card in test_torch_kernels_gpu.py.

Tolerances:

- f32: both sides compute the same fp32 formulas; the port folds the
  forward in the same 512-key blocks, so only the summation order of the
  dots differs — atol 2e-5 and rtol 1e-5 on values of order 1-10;
- bf16: both sides cast p and dS to bf16 before the dots and round their
  outputs to bf16; a one-ulp flip of a rounding moves an element by
  2^-8 of its size, so rtol 2^-7 (two ulps) plus atol 2^-9 of the
  largest value, and lse (fp32 on both sides) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from nezha_tpu.ops.pallas.flash_attention import (
    flash_block_bwd as jax_flash_block_bwd)
from nezha_tpu.ops.pallas.flash_attention import (
    flash_block_fwd as jax_flash_block_fwd)
from nezha_tpu_torch.ops.cuda import (flash_attention, flash_block_bwd,
                                      flash_block_fwd)

CASES = [(24, 16, True), (64, 64, False), (100, 64, True), (128, 16, False),
         (128, 64, True)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, s, d, b=2, h=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(4)]


def _close(got: torch.Tensor, want, dtype: str, what: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5,
                                   err_msg=what)
    else:
        atol = 2.0 ** -9 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=atol, rtol=2.0 ** -7,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s,d,causal", CASES)
def test_block_fwd_and_bwd_match_pallas(s, d, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(s + d, s, d)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jout, jlse = jax_flash_block_fwd(jq, jk, jv, causal, interpret=True)
    jdq, jdk, jdv = jax_flash_block_bwd(jq, jk, jv, jout, jlse, jdo, causal,
                                        interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    out, lse = flash_block_fwd(tq, tk, tv, causal)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (2, 2, s)
    _close(out, jout.astype(jnp.float32), dtype, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-6, err_msg="lse")
    # The backward from JAX's own forward residuals, so both sides
    # differentiate the same values.
    tout = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(tdt)
    tlse = torch.from_numpy(np.array(jlse))
    grads = flash_block_bwd(tq, tk, tv, tout, tlse, tdo, causal)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        assert got.dtype == tdt
        _close(got, want.astype(jnp.float32), dtype, name)


def test_autograd_matches_jax_grad_with_lengths():
    """jax.grad of flash_attention with kv_lengths (a zero-length row,
    clamped to 1, and a row cut mid-block) against the port's autograd
    function: same gradients in f32; padded keys get exactly zero dk/dv;
    position 0 of the zero-length row carries gradient."""
    s, d = 64, 16
    q, k, v, w = _inputs(7, s, d)
    lens = np.asarray([0, 37], np.int32)

    def jloss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, causal=True,
                                  kv_lengths=jnp.asarray(lens))
        return jnp.sum(out * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True,
                          kv_lengths=torch.from_numpy(lens))
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, want in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=1e-5, err_msg=name)
    for t in (tk, tv):
        assert torch.all(t.grad[0, :, 1:] == 0)
        assert torch.all(t.grad[1, :, 37:] == 0)
        assert torch.any(t.grad[0, :, 0] != 0)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(causal):
    """The differentiable call on non-contiguous q/k/v views (the model's
    qkv permute) against jax.grad of the dense custom VJP."""
    s, d = 40, 16
    qkv = np.random.RandomState(3).randn(2, s, 3, 2, d).astype(np.float32)
    w = np.random.RandomState(4).randn(2, 2, s, d).astype(np.float32)
    jqkv = jnp.asarray(qkv).transpose(2, 0, 3, 1, 4)

    def jloss(q_, k_, v_):
        return jnp.sum(jax_flash_attention(q_, k_, v_, causal=causal)
                       * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jqkv[0], jqkv[1], jqkv[2])
    tqkv = torch.from_numpy(qkv).requires_grad_()
    view = tqkv.permute(2, 0, 3, 1, 4)
    out = flash_attention(view[0], view[1], view[2], causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    got = tqkv.grad.permute(2, 0, 3, 1, 4)
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(jgrads[i]),
                                   atol=2e-5, rtol=1e-5)


def test_refusals():
    q = torch.zeros(1, 1, 8, 16)
    k = torch.zeros(1, 1, 12, 16)
    with pytest.raises(ValueError, match="s_q == s_k"):
        flash_block_fwd(q, k, k, causal=True)
    flash_block_fwd(q, k, k, causal=False)           # rectangular, full
    odd = torch.zeros(1, 1, 8, 12)
    with pytest.raises(ValueError, match="head dim"):
        flash_block_fwd(odd, odd, odd, causal=True)
    half = q.half()
    with pytest.raises(ValueError, match="not supported"):
        flash_block_fwd(half, half, half, causal=True)
    with pytest.raises(ValueError, match="differ"):
        flash_block_fwd(q, q.bfloat16(), q, causal=True)


def _bwd_float64(q, k, v, o, lse, do, causal, lengths):
    """The backward's function in float64 with the kernels' bf16 casts of
    ds and p: the same math as the plain version in another precision,
    hence another rounding of every intermediate."""
    d, s = q.shape[-1], q.shape[2]
    f = [t.double() for t in (q, k, v, o, do)]
    s_ = torch.einsum("bhqd,bhkd->bhqk", f[0], f[1]) / d ** 0.5
    qi = torch.arange(s)[:, None]
    kj = torch.arange(s)[None, :]
    valid = (kj <= qi) if causal else torch.ones(s, s, dtype=torch.bool)
    valid = valid[None, None] & (
        kj[None, None] < torch.tensor(lengths).clamp(1, s)[:, None, None,
                                                           None])
    p = torch.where(valid, torch.exp(s_ - lse.double()[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", f[4], f[2])
    ds = p * (dp - (f[4] * f[3]).sum(-1, keepdim=True)) / d ** 0.5
    cast = lambda t: t.to(q.dtype).double()
    return (torch.einsum("bhqk,bhkd->bhqd", cast(ds), f[1]),
            torch.einsum("bhqk,bhqd->bhkd", cast(ds), f[0]),
            torch.einsum("bhqk,bhqd->bhkd", cast(p), f[4]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_error_bound_holds_and_is_tight(dtype):
    """``flash_bwd_error_bound`` (the tolerance the card holds the CUDA
    backward to) covers the plain backward against the same function
    computed in float64, on rows with lengths 0, 1 and 40 (the zero-length
    row's dS is pure cancellation noise); and it is not vacuous: moving
    every dq by 4% of its row's largest value breaks it somewhere."""
    from nezha_tpu_torch.ops.cuda.flash_attention import (
        flash_block_bwd_plain, flash_block_fwd_plain, flash_bwd_error_bound)

    g = torch.Generator().manual_seed(0)
    lengths = [0, 1, 40, 96]
    q, k, v, do = (torch.randn(4, 2, 96, 64, generator=g).to(dtype)
                   for _ in range(4))
    lens = torch.tensor(lengths)
    o, lse = flash_block_fwd_plain(q, k, v, True, kv_lengths=lens)
    got = flash_block_bwd_plain(q, k, v, o, lse, do, True, kv_lengths=lens)
    bounds = flash_bwd_error_bound(q, k, v, o, lse, do, True,
                                   kv_lengths=lens)
    exact = _bwd_float64(q, k, v, o, lse, do, True, lengths)
    for name, x, want, b in zip(("dq", "dk", "dv"), got, exact, bounds):
        err = (x.double() - want).abs()
        assert torch.all(err <= b.double()), (
            name, (err / b.double()).max().item())
    dq = got[0].double()
    moved = dq + 0.04 * dq.abs().amax(dim=-1, keepdim=True)
    assert torch.any((moved - exact[0]).abs() > bounds[0].double())
