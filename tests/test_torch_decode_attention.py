"""Paged flash-decode: the port's ``paged_decode_attention`` against the
JAX Pallas kernel (``flash_decode_attention(..., block_tables=...)`` in
interpret mode) on the same numpy inputs. The CUDA kernel is held against
its plain version on the card in test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.ops.pallas.decode_attention import flash_decode_attention
from nezha_tpu_torch.ops.cuda import paged_decode_attention
from nezha_tpu_torch.ops.cuda.common import fold_error_bound
from nezha_tpu_torch.ops.cuda.decode_attention import check_head_dim

BS, M, H, D = 8, 6, 2, 16
# Every length class the kernel treats differently: inactive (0), one
# position, a partial first block, exactly one block, one past a block
# boundary, and the full table.
LENGTHS = (0, 1, BS - 1, BS, BS + 1, M * BS)


def _case(seed, q_dtype=np.float32):
    rng = np.random.RandomState(seed)
    b = len(LENGTHS)
    n = 1 + b * M
    q = rng.randn(b, H, 1, D).astype(q_dtype)
    kp = rng.randn(n, H, BS, D).astype(np.float32)
    vp = rng.randn(n, H, BS, D).astype(np.float32)
    # Shuffled tables: row blocks scattered over the pool, block 0 (the
    # scratch block) never bound.
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    return q, kp, vp, np.asarray(LENGTHS, np.int32), tab


def _jax(q, kp, vp, lengths, tab, pool_dtype=jnp.float32):
    out = flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kp, pool_dtype),
        jnp.asarray(vp, pool_dtype), jnp.asarray(lengths),
        block_tables=jnp.asarray(tab), interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch(q, kp, vp, lengths, tab, pool_dtype=torch.float32):
    out = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp).to(pool_dtype),
        torch.from_numpy(vp).to(pool_dtype), torch.from_numpy(lengths),
        torch.from_numpy(tab))
    return out.float().numpy()


def test_matches_pallas_kernel_f32():
    """f32 end to end: both fold the same blocks in the same order, so
    they agree to fp32 rounding (atol 1e-5); the length-0 row is exact
    zero in both."""
    case = _case(0)
    got, want = _torch(*case), _jax(*case)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(got[0] == 0.0)


def test_matches_pallas_kernel_bf16_pool():
    """f32 queries over a bf16 pool (the tiny preset's serving layout):
    q and p are rounded to bf16 before the dots on both sides, so they
    still agree to fp32 rounding of the sums (atol 1e-5)."""
    case = _case(1)
    got = _torch(*case, pool_dtype=torch.bfloat16)
    want = _jax(*case, pool_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("d,fits", [(64, True), (104, True), (112, False),
                                    (128, False), (60, False)])
def test_head_dim_limit(d, fits):
    """The CUDA wrapper refuses, typed, the head dims whose 16-byte loads
    or per-block shared memory the decode kernel cannot take."""
    if fits:
        check_head_dim(d)
    else:
        with pytest.raises(ValueError, match="head dim"):
            check_head_dim(d)


def test_fold_error_bound_separates_a_dropped_tile():
    """fold_error_bound (the kernel-vs-plain tolerance on the card) holds
    between the bf16 plain version and exact float64 attention, which
    differ by one side's p and output rounding, and is broken by dropping
    one 32-key tile of the full-length row."""
    b, m, h, d, bs = 3, 16, 2, 64, 16
    g = torch.Generator().manual_seed(3)
    q = torch.randn(b, h, 1, d, generator=g).to(torch.bfloat16)
    kp, vp = (torch.randn(1 + b * m, h, bs, d, generator=g)
              .to(torch.bfloat16) for _ in range(2))
    tab = (1 + torch.randperm(b * m, generator=g)).reshape(b, m).int()
    lengths = torch.tensor([1, 100, m * bs], dtype=torch.int32)
    want = paged_decode_attention(q, kp, vp, lengths, tab)
    bound = fold_error_bound(
        want, paged_decode_attention(q, kp, vp.abs(), lengths, tab), True)
    kd, vd = (p[tab.long()].transpose(1, 2).reshape(b, h, m * bs, d)
              .double() for p in (kp, vp))
    keep = torch.arange(m * bs)[None, :] < lengths[:, None].long()

    def exact(keep):
        s = (q.double() @ kd.transpose(-1, -2)) / d ** 0.5
        s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
        return torch.softmax(s, -1) @ vd

    assert torch.all((exact(keep) - want.double()).abs() <= bound)
    keep[2, 96:128] = False
    assert torch.any((exact(keep)[2] - want[2].double()).abs() > bound[2])


def test_rejects_bad_shapes():
    q, kp, vp, lengths, tab = (torch.from_numpy(a) for a in _case(2))
    with pytest.raises(ValueError, match="block_tables"):
        paged_decode_attention(q, kp, vp, lengths, tab[:2])
    with pytest.raises(ValueError, match="q must be"):
        paged_decode_attention(q.expand(-1, -1, 2, -1), kp, vp, lengths,
                               tab)
