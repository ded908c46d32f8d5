"""Paged flash-decode: the port's ``paged_decode_attention`` against the
JAX Pallas kernel (``flash_decode_attention(..., block_tables=...)`` in
interpret mode) on the same numpy inputs; the split walks and merges the
CUDA kernels run, restated in tensor ops: the dense kernel's
(``decode_split_walk``) against the dense Pallas kernel, the float paged
kernel's (``paged_split_walk``) against the paged Pallas kernel, and the
int8 paged kernel's (``quant_split_walk``) against its plain version,
with its split count and workspace. The CUDA kernels are held against
their plain versions on the card in test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.ops.pallas.decode_attention import flash_decode_attention
from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                      paged_quant_decode_attention_plain)
from nezha_tpu_torch.ops.cuda.common import fold_error_bound
from nezha_tpu_torch.ops.attention import NEG_BIG, masked_scores
from nezha_tpu_torch.ops.cuda.build import check_head_dim
from nezha_tpu_torch.ops.cuda.decode_attention import split_workspace
from nezha_tpu_torch.ops.quant import dequantize_kv_block, quantize_kv_block

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


@pytest.mark.parametrize("d,fits", [(64, True), (104, True), (112, True),
                                    (128, True), (136, False), (60, False)])
def test_head_dim_limit(d, fits):
    """The float decode kernels (B6 and B7, split over the KV length,
    staging a split in the cache dtype) take D a multiple of 8 up to
    MAX_D = 128; their wrappers' check (``build.check_head_dim``)
    refuses, typed, the head dims their 16-byte loads or per-lane
    accumulators cannot take."""
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


# The dense kernel's split sizes (csrc/flash_decode.cu SPLIT, timed on the
# card: 128 or 256) and a cache length that is a multiple of neither.
DENSE_SPLITS = (128, 256)
DENSE_L = 800
DENSE_LENGTHS = (0, 1, 17, 127, 128, 129, 768, DENSE_L)


def decode_split_walk(q, k, v, lengths, split: int, scale=None):
    """The dense kernel's walk and merge in tensor ops: each row's
    positions ``[0, length)`` cut into splits of ``split`` keys, each
    split folded as one TPU block step (its own max; q cast to the cache
    dtype before Q·Kᵀ, p to v's dtype before P·V; fp32 statistics), then
    the splits merged by log-sum-exp in split order into ``acc / max(l,
    1e-30)`` in q's dtype. A row of length 0 folds no split: exact
    zeros."""
    b, h, _, d = q.shape
    cap = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    lengths = lengths.long().clamp(0, cap)
    qk = q.to(k.dtype)
    offs = torch.arange(split, device=q.device)
    m = torch.full((b, h, 1), NEG_BIG, dtype=torch.float32, device=q.device)
    parts = []
    for s0 in range(0, cap, split):
        valid = (s0 + offs[:min(split, cap - s0)])[None, :] < lengths[:, None]
        s = masked_scores(qk, k[:, :, s0:s0 + split],
                          valid[:, None, None, :], scale)       # [B,H,1,n]
        m_s = s.amax(-1)
        p = torch.exp(s - m_s[..., None])
        acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                           v[:, :, s0:s0 + split].float())
        live = (s0 < lengths)[:, None, None]                    # [B,1,1]
        parts.append((live, m_s, p.sum(-1), acc))
        m = torch.where(live, torch.maximum(m, m_s), m)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, 1, d, dtype=torch.float32, device=q.device)
    for live, m_s, l_s, acc_s in parts:
        c = torch.where(live, torch.exp(m_s - m), torch.zeros_like(m))
        l = l + l_s * c
        acc = acc + acc_s * c[..., None]
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("split", DENSE_SPLITS)
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_dense_split_walk_matches_pallas_kernel(split, cache):
    """B6's walk restated: each row's positions cut into splits, each
    folded as one block step, merged by log-sum-exp in split order. It
    agrees with JAX's dense ``flash_decode_attention`` (interpret mode,
    200-key blocks at L=800) on the same numpy inputs: over an f32 cache
    to fp32 rounding of the sums (atol 1e-5, as the paged tests), over a
    bf16 cache within ``fold_error_bound`` (the two round p to bf16 after
    subtracting maxima of different key blocks); the length-0 row exact
    zero on both sides."""
    rng = np.random.RandomState(11)
    b, h, d = len(DENSE_LENGTHS), 2, 16
    q = rng.randn(b, h, 1, d).astype(np.float32)
    k, v = (rng.randn(b, h, DENSE_L, d).astype(np.float32)
            for _ in range(2))
    lengths = np.asarray(DENSE_LENGTHS, np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if cache == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.array(flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(lengths), interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tk, tv = tk.to(tdt), tv.to(tdt)
    tl = torch.from_numpy(lengths)
    got = decode_split_walk(tq, tk, tv, tl, split)
    assert got.dtype == torch.float32 and got.shape == (b, h, 1, d)
    assert torch.all(got[0] == 0) and np.all(want[0] == 0)
    if cache == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        bound = fold_error_bound(
            torch.from_numpy(want),
            decode_split_walk(tq, tk, tv.abs(), tl, split), True)
        assert torch.all((got - torch.from_numpy(want)).abs() <= bound)


# The int8 paged kernel's split sizes (csrc/paged_quant_decode.cu SPLIT,
# timed on the card over these three) and a pool block of the serving
# engine's 16 positions.
QUANT_SPLITS = (64, 128, 256)
QUANT_BS = 16


@pytest.mark.parametrize("split", QUANT_SPLITS)
@pytest.mark.parametrize("m", [1, 5, 9, 17, 63, 64])
def test_quant_split_count_and_workspace(split, m):
    """A row's M*bs positions take ceil(M*bs / SPLIT) splits, the last one
    ragged where M*bs is not a multiple of SPLIT (one split of a single
    pool block; 9 * 16 = 144 keys), and the workspace holds one fp32
    (acc[D], m, l) a split of each (row, head) of the serving shape."""
    b, h, d = 8, 12, 64
    keys = m * QUANT_BS
    n_splits, floats = split_workspace(b, h, keys, d, split)
    assert (n_splits - 1) * split < keys <= n_splits * split
    assert floats == b * h * n_splits * (d + 2)


def quant_split_walk(q, k_pool, v_pool, k_scales, v_scales, lengths, tab,
                     split: int):
    """B8's walk and merge in tensor ops: each row's pool blocks
    dequantized as the kernel does (``(int8 * scale).to(q.dtype)``, one
    scale per block), gathered in table order, then cut into splits of
    ``split`` keys, each folded as one block step with the dots and p in
    q's dtype, and merged by log-sum-exp in split order
    (``decode_split_walk`` over the gathered rows)."""
    b, h, _, d = q.shape
    m, bs = tab.shape[1], k_pool.shape[2]
    idx = tab.long()
    kd, vd = (dequantize_kv_block(p[idx], s[idx], q.dtype)
              .transpose(1, 2).reshape(b, h, m * bs, d)
              for p, s in ((k_pool, k_scales), (v_pool, v_scales)))
    return decode_split_walk(q, kd, vd, lengths, split)


@pytest.mark.parametrize("split", QUANT_SPLITS)
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_quant_split_walk_matches_plain(split, q_dtype):
    """Splitting the int8 decode over the KV length and merging in split
    order stays within fold_error_bound of the one-walk plain version
    (``paged_quant_decode_attention_plain``, B8's function in tensor ops)
    at lengths 0, 1, SPLIT-1, SPLIT, SPLIT+1 and M*bs (M*bs = 2 SPLIT +
    48, not a multiple of SPLIT), with both q dtypes; the length-0 row is
    exact zero on both sides."""
    rng = np.random.RandomState(split)
    h, d = 2, 16
    m = (2 * split + 48) // QUANT_BS
    lengths = [0, 1, split - 1, split, split + 1, m * QUANT_BS]
    b, n = len(lengths), 1 + len(lengths) * m
    kq, ks = quantize_kv_block(torch.from_numpy(
        (rng.randn(n, h, QUANT_BS, d) * 2).astype(np.float32)))
    vq, vs = quantize_kv_block(torch.from_numpy(
        rng.randn(n, h, QUANT_BS, d).astype(np.float32)))
    q = torch.from_numpy(rng.randn(b, h, 1, d).astype(np.float32)).to(
        q_dtype)
    tab = torch.from_numpy((1 + rng.permutation(b * m)).reshape(b, m)
                           .astype(np.int32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = quant_split_walk(q, kq, vq, ks, vs, lens, tab, split)
    want = paged_quant_decode_attention_plain(q, kq, vq, ks, vs, lens, tab)
    abs_v = paged_quant_decode_attention_plain(q, kq, vq.abs(), ks, vs,
                                               lens, tab)
    bound = fold_error_bound(want, abs_v, q_dtype == torch.bfloat16)
    assert got.dtype == q_dtype
    assert torch.all((got.float() - want.float()).abs() <= bound)
    assert torch.all(got[0] == 0) and torch.all(want[0] == 0)


# The float paged kernel's split sizes (csrc/paged_decode.cu SPLIT, timed
# on the card) and the serving engine's 16-position pool blocks.
PAGED_SPLITS = (64, 128)


def paged_split_walk(q, k_pool, v_pool, lengths, tab, split: int):
    """B7's walk and merge in tensor ops: each row's pool blocks gathered
    in table order as stored, then cut into splits of ``split`` keys,
    each folded as one block step (q cast to the pool dtype before Q·Kᵀ,
    p to the pool dtype before P·V) and merged by log-sum-exp in split
    order (``decode_split_walk`` over the gathered rows)."""
    b, h, _, d = q.shape
    m, bs = tab.shape[1], k_pool.shape[2]
    idx = tab.long()
    kd, vd = (p[idx].transpose(1, 2).reshape(b, h, m * bs, d)
              for p in (k_pool, v_pool))
    return decode_split_walk(q, kd, vd, lengths, split)


@pytest.mark.parametrize("split", PAGED_SPLITS)
@pytest.mark.parametrize("pool", ["f32", "bf16"])
def test_paged_split_walk_matches_pallas_kernel(split, pool):
    """B7's split walk against JAX's paged ``flash_decode_attention``
    (interpret mode, one 16-position pool block a grid step) on the same
    numpy inputs, at lengths 0, 1, SPLIT-1, SPLIT, SPLIT+1, 2 SPLIT and
    M*bs (= 2 SPLIT + 48, not a multiple of SPLIT) through shuffled
    tables: over an f32 pool to fp32 rounding of the sums (atol 1e-5, as
    the paged tests above), over a bf16 pool within ``fold_error_bound``
    (the two round p to bf16 after subtracting maxima of different key
    blocks); the length-0 row exact zero on both sides."""
    rng = np.random.RandomState(split + len(pool))
    h, d = 2, 16
    m = (2 * split + 48) // QUANT_BS
    lengths = np.asarray([0, 1, split - 1, split, split + 1, 2 * split,
                          m * QUANT_BS], np.int32)
    b, n = len(lengths), 1 + len(lengths) * m
    q = rng.randn(b, h, 1, d).astype(np.float32)
    kp, vp = (rng.randn(n, h, QUANT_BS, d).astype(np.float32)
              for _ in range(2))
    tab = (1 + rng.permutation(b * m)).reshape(b, m).astype(np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if pool == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = _jax(q, kp, vp, lengths, tab, pool_dtype=jdt)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    tk, tv = tk.to(tdt), tv.to(tdt)
    tl, tt = torch.from_numpy(lengths), torch.from_numpy(tab)
    got = paged_split_walk(tq, tk, tv, tl, tt, split)
    assert got.dtype == torch.float32 and got.shape == (b, h, 1, d)
    assert torch.all(got[0] == 0) and np.all(want[0] == 0)
    if pool == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        bound = fold_error_bound(
            torch.from_numpy(want),
            paged_split_walk(tq, tk, tv.abs(), tl, tt, split), True)
        assert torch.all((got - torch.from_numpy(want)).abs() <= bound)
