"""Paged flash-prefill: the port's ``paged_prefill_attention`` against the
JAX Pallas kernel (``flash_prefill_attention``, float pools, interpret
mode) on the same numpy inputs. The CUDA kernel is held against its
plain version on the card in test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.ops.pallas.prefill_attention import flash_prefill_attention
from nezha_tpu_torch.ops.cuda import paged_prefill_attention

BS, M, H, D, S = 8, 12, 2, 16, 16
# Cold start, a mid-block start (a shared-prefix hit capped inside a
# block), a block-aligned chunked continuation, and the last chunk that
# fits the table.
STARTS = (0, 5, 16, M * BS - S)


def _case(seed):
    rng = np.random.RandomState(seed)
    b = len(STARTS)
    n = 1 + b * M
    q, kc, vc = (rng.randn(b, H, S, D).astype(np.float32) for _ in range(3))
    kp = rng.randn(n, H, BS, D).astype(np.float32)
    vp = rng.randn(n, H, BS, D).astype(np.float32)
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    return q, kc, vc, kp, vp, tab, np.asarray(STARTS, np.int32)


def _jax(q, kc, vc, kp, vp, tab, starts, pool_dtype):
    out = flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kp, pool_dtype), jnp.asarray(vp, pool_dtype),
        jnp.asarray(tab), jnp.asarray(starts), interpret=True)
    return np.asarray(out)


def _torch(q, kc, vc, kp, vp, tab, starts, pool_dtype):
    t = torch.from_numpy
    out = paged_prefill_attention(
        t(q), t(kc), t(vc), t(kp).to(pool_dtype), t(vp).to(pool_dtype),
        t(tab), t(starts))
    return out.numpy()


def test_matches_pallas_kernel_f32():
    """f32 end to end, every start class in one call: same fold order as
    the TPU kernel, so agreement to fp32 rounding (atol 1e-5)."""
    case = _case(0)
    np.testing.assert_allclose(_torch(*case, torch.float32),
                               _jax(*case, jnp.float32), atol=1e-5, rtol=0)


def test_matches_pallas_kernel_bf16_pool():
    """f32 compute over a bf16 pool: both sides round q and p to bf16 in
    the prefix fold and route the fresh chunk K/V through bf16, so the
    inputs to every dot are identical. What may still differ is where an
    fp32 sum's last bit moves a p across a bf16 rounding boundary: one
    bf16 ulp of p (2^-8 relative), which moves an output by at most
    2^-8 * max|v| — the tolerance used."""
    case = _case(1)
    atol = 2.0 ** -8 * float(np.abs(case[4]).max())
    np.testing.assert_allclose(_torch(*case, torch.bfloat16),
                               _jax(*case, jnp.bfloat16), atol=atol, rtol=0)


def test_rejects_bad_shapes():
    q, kc, vc, kp, vp, tab, starts = (torch.from_numpy(a)
                                      for a in _case(2))
    with pytest.raises(ValueError, match="chunk k/v"):
        paged_prefill_attention(q, kc[:, :, :4], vc, kp, vp, tab, starts)
    with pytest.raises(ValueError, match="starts"):
        paged_prefill_attention(q, kc, vc, kp, vp, tab, starts[:1])
