"""The port's CUDA kernels on the card, against their plain versions; the
engine, generate and a training step on the card against the same on the
CPU.
Every test here needs a CUDA card: it is marked ``gpu`` and skips
without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from nezha_tpu_torch.cli.common import gpt2_for_preset
from nezha_tpu_torch.models import generate
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.ops.cuda import (flash_block_bwd, flash_block_bwd_plain,
                                      flash_block_fwd, flash_block_fwd_plain,
                                      flash_decode_attention,
                                      flash_decode_attention_plain,
                                      layer_norm_bwd, layer_norm_bwd_plain,
                                      layer_norm_fwd, layer_norm_fwd_plain,
                                      paged_decode_attention,
                                      paged_decode_attention_plain,
                                      paged_prefill_attention,
                                      paged_prefill_attention_plain,
                                      paged_prefill_qoff_attention,
                                      paged_prefill_qoff_attention_plain,
                                      paged_quant_decode_attention,
                                      paged_quant_decode_attention_plain,
                                      paged_quant_prefill_attention,
                                      paged_quant_prefill_attention_plain)
from nezha_tpu_torch.ops.cuda.common import fold_error_bound
from nezha_tpu_torch.ops.cuda import build
from nezha_tpu_torch.ops.cuda.decode_attention import split_size
from nezha_tpu_torch.ops.cuda.flash_attention import (LAUNCHES,
                                                      flash_bwd_error_bound)
from nezha_tpu_torch.ops.cuda.layer_norm import LAUNCHES as LN_LAUNCHES
from nezha_tpu_torch.ops.cuda.layer_norm import (FWD_LAUNCHES_BY_ROWS,
                                                 layer_norm_error_bound)
from nezha_tpu_torch.ops.quant import quantize_kv_block
from nezha_tpu_torch.optim import adamw
from nezha_tpu_torch.serve import (Engine, Request, Scheduler, ServeConfig,
                                   ShardedEngine)
from nezha_tpu_torch.train import make_train_step

BS, M, H, D = 8, 12, 2, 64
DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
          (torch.float32, torch.float32)]
# Prefill chunk widths: one query, a tile-aligned 16, and widths that are
# not a multiple of 16, one spanning two 64-row query blocks and two
# 64-key chunk tiles.
PREFILL_S = [1, 16, 40, 77]
# Head dims of the prefill fold: one 8-column group set (ND = 8) and the
# widest (ND = 16).
PREFILL_D = [64, 128]


def _prefill_starts(s):
    """Cold, mid-block, block-aligned, off a 64-key tile boundary (70),
    the last chunk of width ``s`` that fits the table, and the table's
    end (a prefix of every block)."""
    return np.asarray([0, 5, 16, 70, M * BS - s, M * BS], np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_within_bound(got, want, want_abs_v, p_bf16):
    """|kernel - plain| within fold_error_bound: fp32 rounding (1e-5),
    plus 2^-7 of the weighted |v| where p is rounded to bf16, plus 2^-7
    of |out| where the output is bf16."""
    bound = fold_error_bound(want, want_abs_v, p_bf16)
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= bound), (
        f"max |kernel - plain| / bound {(err / bound).max().item():.3f}")


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", DTYPES)
def test_decode_kernel_matches_plain(cuda_device, q_dtype, pool_dtype):
    rng = np.random.RandomState(0)
    lengths = np.asarray([0, 1, BS - 1, BS, BS + 1, 33, M * BS], np.int32)
    b, n = len(lengths), 1 + len(lengths) * M
    q = rng.randn(b, H, 1, D).astype(np.float32)
    kp, vp = (rng.randn(n, H, BS, D).astype(np.float32) for _ in range(2))
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    dev = cuda_device
    args = (torch.from_numpy(q).to(dev, q_dtype),
            torch.from_numpy(kp).to(dev, pool_dtype),
            torch.from_numpy(vp).to(dev, pool_dtype),
            torch.from_numpy(lengths).to(dev), torch.from_numpy(tab).to(dev))
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_plain(*args)
    abs_v = paged_decode_attention_plain(*args[:2], args[2].abs(), *args[3:])
    _assert_within_bound(got, want, abs_v, pool_dtype == torch.bfloat16)
    assert torch.all(got[0] == 0)


# The float kernels' (q, pool) dtype pairs: all four they take.
ALL_DTYPES = DTYPES + [(torch.bfloat16, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", ALL_DTYPES)
@pytest.mark.parametrize("h,d", [(12, 64), (3, 64), (12, 128), (3, 128)])
def test_paged_decode_split_kernel_matches_plain(cuda_device, q_dtype,
                                                 pool_dtype, h, d):
    """The float paged decode kernel split over the KV length, at the
    serving engine's heads (12) and a 4-way mesh shard's (3), D 64 and
    128, within fold_error_bound of its plain version over lengths that
    end inside a split, one before, at and one past each of the first two
    split boundaries, at the table's end (not a multiple of the split)
    and past it; the grid (splits of M*bs, H, B); the zero-length row
    exact zero; NaN in blocks past every row's length changes nothing;
    two launches bitwise equal; one launch a call."""
    split = split_size("paged_decode")
    bs = 16
    m = (2 * split + 48) // bs
    rng = np.random.RandomState(h + d)
    lengths = np.asarray([0, 1, 31, split - 1, split, split + 1,
                          2 * split - 1, 2 * split, 2 * split + 1, m * bs,
                          m * bs + 9], np.int32)
    b, n = len(lengths), 1 + len(lengths) * m
    dev = cuda_device
    q = torch.from_numpy(rng.randn(b, h, 1, d).astype(np.float32)).to(
        dev, q_dtype)
    kp, vp = (torch.from_numpy(rng.randn(n, h, bs, d).astype(np.float32))
              .to(dev, pool_dtype) for _ in range(2))
    tab = torch.from_numpy((1 + rng.permutation(b * m)).reshape(b, m)
                           .astype(np.int32)).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    args = (q, kp, vp, lens, tab)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert _launched_grid("paged_decode") == (-(-m * bs // split), h, b)
    assert got.dtype == q_dtype
    want = paged_decode_attention_plain(*args)
    abs_v = paged_decode_attention_plain(q, kp, vp.abs(), lens, tab)
    _assert_within_bound(got, want, abs_v, pool_dtype == torch.bfloat16)
    assert torch.all(got[0] == 0)
    assert torch.equal(paged_decode_attention(*args), got)
    for r, length in enumerate(lengths.tolist()):
        dead = tab[r, -(-length // bs):].long()
        kp[dead], vp[dead] = float("nan"), float("nan")
    assert torch.equal(paged_decode_attention(*args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", DTYPES)
@pytest.mark.parametrize("s", PREFILL_S)
@pytest.mark.parametrize("d", PREFILL_D)
def test_prefill_kernel_matches_plain(cuda_device, q_dtype, pool_dtype, s,
                                      d):
    rng = np.random.RandomState(1)
    starts = _prefill_starts(s)
    b, n = len(starts), 1 + len(starts) * M
    q, kc, vc = (rng.randn(b, H, s, d).astype(np.float32) for _ in range(3))
    kp, vp = (rng.randn(n, H, BS, d).astype(np.float32) for _ in range(2))
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    dev = cuda_device
    args = (torch.from_numpy(q).to(dev, q_dtype),
            torch.from_numpy(kc).to(dev, q_dtype),
            torch.from_numpy(vc).to(dev, q_dtype),
            torch.from_numpy(kp).to(dev, pool_dtype),
            torch.from_numpy(vp).to(dev, pool_dtype),
            torch.from_numpy(tab).to(dev), torch.from_numpy(starts).to(dev))
    before = paged_prefill_attention.launches
    got = paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == before + 1
    want = paged_prefill_attention_plain(*args)
    abs_v = paged_prefill_attention_plain(args[0], args[1], args[2].abs(),
                                          args[3], args[4].abs(), *args[5:])
    _assert_within_bound(got, want, abs_v, torch.bfloat16 in (q_dtype,
                                                             pool_dtype))


def _qoff_case(rng, s_kc, q_dtype, pool_dtype, dev, d=D):
    """One row per start of ``_prefill_starts``, a chunk of ``s_kc``
    rows."""
    starts = _prefill_starts(s_kc)
    b, n = len(starts), 1 + len(starts) * M
    q, kc, vc = (torch.from_numpy(rng.randn(b, H, s_kc, d).astype(
        np.float32)).to(dev, q_dtype) for _ in range(3))
    kp, vp = (torch.from_numpy(rng.randn(n, H, BS, d).astype(np.float32))
              .to(dev, pool_dtype) for _ in range(2))
    tab = torch.from_numpy((1 + rng.permutation(b * M)).reshape(b, M)
                           .astype(np.int32)).to(dev)
    return q, kc, vc, kp, vp, tab, torch.from_numpy(starts).to(dev)


# (S_kc, S_q) of the q-offset cases: one query; chunks cut into slices of
# 16 and of widths that are not a multiple of 16; a 96-row chunk over two
# 64-key tiles in two 48-query slices.
QOFF_CASES = [(1, 1), (32, 16), (40, 20), (64, 16), (77, 11), (96, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", DTYPES)
@pytest.mark.parametrize("s_kc,s_q", QOFF_CASES)
@pytest.mark.parametrize("d", PREFILL_D)
def test_prefill_qoff_kernel_matches_plain(cuda_device, q_dtype, pool_dtype,
                                           s_kc, s_q, d):
    """The q-offset kernel (B11) within fold_error_bound of its plain
    version, for every query slice of the chunk (q_offsets = starts +
    k * S_q); one launch per call, counted apart from B9's."""
    rng = np.random.RandomState(8)
    q, kc, vc, kp, vp, tab, st = _qoff_case(rng, s_kc, q_dtype, pool_dtype,
                                            cuda_device, d)
    for k in range(s_kc // s_q):
        qs = q[:, :, k * s_q:(k + 1) * s_q].contiguous()
        qoff = st + k * s_q
        b9, b11 = (paged_prefill_attention.launches,
                   paged_prefill_qoff_attention.launches)
        got = paged_prefill_attention(qs, kc, vc, kp, vp, tab, st,
                                      q_offsets=qoff)
        torch.cuda.synchronize()
        assert paged_prefill_qoff_attention.launches == b11 + 1
        assert paged_prefill_attention.launches == b9
        want = paged_prefill_qoff_attention_plain(qs, kc, vc, kp, vp, tab,
                                                  st, qoff)
        abs_v = paged_prefill_qoff_attention_plain(qs, kc, vc.abs(), kp,
                                                   vp.abs(), tab, st, qoff)
        _assert_within_bound(got, want, abs_v, torch.bfloat16 in (
            q_dtype, pool_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", DTYPES)
@pytest.mark.parametrize("s_kc,s_q", QOFF_CASES)
@pytest.mark.parametrize("d", PREFILL_D)
def test_prefill_qoff_slices_bitwise_equal_b9(cuda_device, q_dtype,
                                              pool_dtype, s_kc, s_q, d):
    """Each query slice through B11 gives the bits B9 gives the same rows
    of the full chunk, and q_offsets = starts with S_q = S_kc is B9."""
    rng = np.random.RandomState(9)
    q, kc, vc, kp, vp, tab, st = _qoff_case(rng, s_kc, q_dtype, pool_dtype,
                                            cuda_device, d)
    full = paged_prefill_attention(q, kc, vc, kp, vp, tab, st)
    for k in range(s_kc // s_q):
        got = paged_prefill_attention(
            q[:, :, k * s_q:(k + 1) * s_q].contiguous(), kc, vc, kp, vp, tab,
            st, q_offsets=st + k * s_q)
        assert torch.equal(got, full[:, :, k * s_q:(k + 1) * s_q])
    assert torch.equal(paged_prefill_attention(q, kc, vc, kp, vp, tab, st,
                                               q_offsets=st), full)


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda_device):
    """The tiny preset in f32 with f32 pools serves the same greedy tokens
    on the card (CUDA kernels) as on the CPU (plain versions), through
    chunked prefill and a prefix-cache hit."""
    rng = np.random.RandomState(2)
    prefix = rng.randint(0, 512, 24).tolist()
    prompts = [rng.randint(0, 512, 5).tolist(),
               rng.randint(0, 512, 40).tolist(),
               prefix + [7, 8, 9], prefix + [1]]
    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu")
    results = []
    for device in ("cpu", cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu").to(device)
        model.load_state_dict(cpu_model.state_dict())
        sched = Scheduler(Engine(model, ServeConfig(
            max_batch_size=2, max_len=96, max_prefill_len=16,
            kv_block_size=8, cache_dtype=torch.float32)))
        for i, p in enumerate(prompts):
            sched.submit(Request(prompt=p, max_new_tokens=8,
                                 request_id=str(i)))
        sched.run_until_idle(max_iters=200)
        sched.engine.pool.leak_check()
        results.append({k: r.tokens for k, r in sched.results.items()})
    assert results[0] == results[1]


def _int8_pools(rng, n, dev, d=D, h=H, bs=BS):
    """int8 K/V pools [n, h, bs, d] quantized from random values, with
    their fp32 scales, on ``dev``."""
    out = []
    for amp in (2.0, 1.0):
        qv, sv = quantize_kv_block(torch.from_numpy(
            (rng.randn(n, h, bs, d) * amp).astype(np.float32)))
        out += [qv.to(dev), sv.to(dev)]
    return out          # kq, ks, vq, vs


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_quant_decode_kernel_matches_plain(cuda_device, q_dtype):
    """The int8 decode kernel within fold_error_bound of its plain version
    on the card (the dots run in q's dtype, so p rounds to bf16 only with
    a bf16 q); the zero-length row exact zero; NaN scales and saturated
    int8 in blocks past every row's length change nothing."""
    rng = np.random.RandomState(6)
    lengths = np.asarray([0, 1, BS - 1, BS, BS + 1, 33, M * BS], np.int32)
    b, n = len(lengths), 1 + len(lengths) * M
    dev = cuda_device
    kq, ks, vq, vs = _int8_pools(rng, n, dev)
    q = torch.from_numpy(rng.randn(b, H, 1, D).astype(np.float32)).to(
        dev, q_dtype)
    tab = torch.from_numpy((1 + rng.permutation(b * M)).reshape(b, M)
                           .astype(np.int32)).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    before = paged_quant_decode_attention.launches
    got = paged_decode_attention(q, kq, vq, lens, tab, block_scales=(ks, vs))
    torch.cuda.synchronize()
    assert paged_quant_decode_attention.launches == before + 1
    want = paged_quant_decode_attention_plain(q, kq, vq, ks, vs, lens, tab)
    abs_v = paged_quant_decode_attention_plain(q, kq, vq.abs(), ks, vs,
                                               lens, tab)
    _assert_within_bound(got, want, abs_v, q_dtype == torch.bfloat16)
    assert torch.all(got[0] == 0)
    for r, length in enumerate(lengths.tolist()):
        dead = tab[r, -(-length // BS):].long()
        kq[dead], vq[dead] = 127, -127
        ks[dead], vs[dead] = float("nan"), float("nan")
    assert torch.equal(paged_quant_decode_attention(q, kq, vq, ks, vs, lens,
                                                    tab), got)


def _launched_grid(kernel):
    """The grid its library recorded at the kernel's last launch."""
    import ctypes

    xyz = (ctypes.c_int * 3)()
    build.bind(kernel, f"nezha_{kernel}_last_grid", (ctypes.c_void_p,))(xyz)
    return tuple(xyz)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,d", [(12, 64), (3, 64), (3, 128)])
def test_quant_decode_split_kernel_matches_plain(cuda_device, q_dtype, h, d):
    """The int8 decode kernel split over the KV length, at the serving
    engine's heads (12) and a 4-way mesh shard's (3), within
    fold_error_bound of its plain version over lengths that end inside a
    split, one before, at and one past each of the first two split
    boundaries, at the table's end (not a multiple of the split) and past
    it; the grid (splits of M*bs, H, B); the zero-length row exact zero;
    NaN scales and saturated int8 in blocks past every row's length
    change nothing; two launches bitwise equal; one launch a call."""
    split = split_size("paged_quant_decode")
    bs = 16
    m = (2 * split + 48) // bs
    rng = np.random.RandomState(h + d)
    lengths = np.asarray([0, 1, 31, split - 1, split, split + 1,
                          2 * split - 1, 2 * split, 2 * split + 1, m * bs,
                          m * bs + 9], np.int32)
    b, n = len(lengths), 1 + len(lengths) * m
    dev = cuda_device
    kq, ks, vq, vs = _int8_pools(rng, n, dev, d=d, h=h, bs=bs)
    q = torch.from_numpy(rng.randn(b, h, 1, d).astype(np.float32)).to(
        dev, q_dtype)
    tab = torch.from_numpy((1 + rng.permutation(b * m)).reshape(b, m)
                           .astype(np.int32)).to(dev)
    lens = torch.from_numpy(lengths).to(dev)
    args = (q, kq, vq, ks, vs, lens, tab)
    before = paged_quant_decode_attention.launches
    got = paged_quant_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_quant_decode_attention.launches == before + 1
    assert _launched_grid("paged_quant_decode") == (-(-m * bs // split), h,
                                                     b)
    assert got.dtype == q_dtype
    want = paged_quant_decode_attention_plain(*args)
    abs_v = paged_quant_decode_attention_plain(q, kq, vq.abs(), ks, vs,
                                               lens, tab)
    _assert_within_bound(got, want, abs_v, q_dtype == torch.bfloat16)
    assert torch.all(got[0] == 0)
    assert torch.equal(paged_quant_decode_attention(*args), got)
    for r, length in enumerate(lengths.tolist()):
        dead = tab[r, -(-length // bs):].long()
        kq[dead], vq[dead] = 127, -127
        ks[dead], vs[dead] = float("nan"), float("nan")
    assert torch.equal(paged_quant_decode_attention(*args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", PREFILL_S)
@pytest.mark.parametrize("d", PREFILL_D)
def test_quant_prefill_kernel_matches_plain(cuda_device, q_dtype, s, d):
    """The int8 prefill kernel against its plain version on the card:
    the output within fold_error_bound; the pools and scales after the
    call bitwise equal on every block but scratch block 0, untouched
    blocks unchanged; qerr within 1e-6 relative; a second run from the
    same pools bitwise equal to the first. The starts of
    ``_prefill_starts`` whose chunk fits the table, as the engine's
    always does (the table's end: test_quant_prefill_kernel_at_table_end)."""
    rng = np.random.RandomState(7)
    starts = np.asarray([x for x in _prefill_starts(s) if x + s <= M * BS],
                        np.int32)
    b, n = len(starts), 1 + len(starts) * M
    dev = cuda_device
    pools = _int8_pools(rng, n, dev, d)
    q, kc, vc = (torch.from_numpy(rng.randn(b, H, s, d).astype(np.float32))
                 .to(dev, q_dtype) for _ in range(3))
    tab = torch.from_numpy((1 + rng.permutation(b * M)).reshape(b, M)
                           .astype(np.int32)).to(dev)
    st = torch.from_numpy(starts).to(dev)

    def run(fn):
        kq, ks, vq, vs = (t.clone() for t in pools)
        out, qerr = fn(q, kc, vc, kq, vq, ks, vs, tab, st)
        return out, qerr, (kq, ks, vq, vs)

    before = paged_quant_prefill_attention.launches
    got, qerr, got_pools = run(paged_quant_prefill_attention)
    torch.cuda.synchronize()
    assert paged_quant_prefill_attention.launches == before + 1
    want, want_err, want_pools = run(paged_quant_prefill_attention_plain)
    kq, ks, vq, vs = pools
    abs_v = paged_quant_prefill_attention_plain(
        q, kc, vc.abs(), kq.clone(), vq.abs(), ks.clone(), vs.clone(), tab,
        st)[0]
    _assert_within_bound(got, want, abs_v, q_dtype == torch.bfloat16)
    for g, w in zip(got_pools, want_pools):
        assert torch.equal(g[1:], w[1:])
    touched = {int(tab[r, t]) for r, x in enumerate(starts.tolist())
               for t in range(x // BS, (x + s - 1) // BS + 1)}
    untouched = sorted(set(range(1, n)) - touched)
    for g, orig in zip(got_pools, pools):
        assert torch.equal(g[untouched], orig[untouched])
    assert abs(qerr.item() - want_err.item()) <= 1e-6 * want_err.item()
    again, qerr2, again_pools = run(paged_quant_prefill_attention)
    assert torch.equal(again, got) and torch.equal(qerr2, qerr)
    assert all(torch.equal(x, y) for x, y in zip(again_pools, got_pools))


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", PREFILL_S)
@pytest.mark.parametrize("d", PREFILL_D)
def test_quant_prefill_kernel_at_table_end(cuda_device, q_dtype, s, d):
    """Start at the table's end (M * bs): the prefix is every block, and
    the output lies within fold_error_bound of the plain version's. The
    chunk itself lies past the table, where the engine never writes; the
    kernel's write grid touches no block there (t >= M), so the pools
    come back unchanged and qerr is 0."""
    rng = np.random.RandomState(11)
    b = 3
    n = 1 + b * M
    dev = cuda_device
    pools = _int8_pools(rng, n, dev, d)
    q, kc, vc = (torch.from_numpy(rng.randn(b, H, s, d).astype(np.float32))
                 .to(dev, q_dtype) for _ in range(3))
    tab = torch.from_numpy((1 + rng.permutation(b * M)).reshape(b, M)
                           .astype(np.int32)).to(dev)
    st = torch.full((b,), M * BS, dtype=torch.int32, device=dev)
    kq, ks, vq, vs = (t.clone() for t in pools)
    got, qerr = paged_quant_prefill_attention(q, kc, vc, kq, vq, ks, vs, tab,
                                              st)
    torch.cuda.synchronize()
    assert all(torch.equal(a, o) for a, o in zip((kq, ks, vq, vs), pools))
    assert qerr.item() == 0.0
    kq, ks, vq, vs = pools
    want = paged_quant_prefill_attention_plain(
        q, kc, vc, kq.clone(), vq.clone(), ks.clone(), vs.clone(), tab, st)[0]
    abs_v = paged_quant_prefill_attention_plain(
        q, kc, vc.abs(), kq.clone(), vq.abs(), ks.clone(), vs.clone(), tab,
        st)[0]
    _assert_within_bound(got, want, abs_v, q_dtype == torch.bfloat16)


@pytest.mark.gpu
def test_int8_engine_on_card_matches_cpu(cuda_device):
    """The tiny preset in f32 serves the same greedy tokens from an int8
    pool on the card (the int8 kernels) as on the CPU (plain versions),
    through chunked prefill and a prefix-cache hit, and the card's run
    launches both int8 kernels and neither float one."""
    rng = np.random.RandomState(8)
    prefix = rng.randint(0, 512, 24).tolist()
    prompts = [rng.randint(0, 512, 5).tolist(),
               rng.randint(0, 512, 40).tolist(),
               prefix + [7, 8, 9], prefix + [1]]
    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu")
    results = []
    for device in ("cpu", cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu").to(device)
        model.load_state_dict(cpu_model.state_dict())
        engine = Engine(model, ServeConfig(
            max_batch_size=2, max_len=96, max_prefill_len=16,
            kv_block_size=8, cache_dtype=torch.float32, kv_dtype="int8"))
        before = engine.kernel_launches()
        sched = Scheduler(engine)
        for i, p in enumerate(prompts):
            sched.submit(Request(prompt=p, max_new_tokens=8,
                                 request_id=str(i)))
        sched.run_until_idle(max_iters=200)
        engine.pool.leak_check()
        assert engine.pool.prefix_hits >= 1
        if device != "cpu":
            ran = {k: v - before[k]
                   for k, v in engine.kernel_launches().items()}
            assert ran["paged_quant_decode"] > 0
            assert ran["paged_quant_prefill"] > 0
            assert ran["paged_decode"] == ran["paged_prefill"] == 0
        results.append({k: r.tokens for k, r in sched.results.items()})
    assert results[0] == results[1]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["ring", "ulysses"])
def test_sequence_sharded_engine_on_card_matches_cpu(cuda_device, variant):
    """The tiny preset in f32 on a 2-shard mesh of one card
    (``devices=[cuda] * 2``) with sequence-sharded prefill serves the
    CPU mesh's greedy tokens; ring launches B11 4 times per layer per
    chunk (2 hops x 2 shards) and never B9, ulysses B9 twice."""
    rng = np.random.RandomState(10)
    prefix = rng.randint(0, 512, 24).tolist()
    prompts = [rng.randint(0, 512, 5).tolist(),
               rng.randint(0, 512, 40).tolist(),
               prefix + [7, 8, 9], prefix + [1]]
    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu")
    layers = cpu_model.cfg.num_layers
    results = []
    for device in (torch.device("cpu"), cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu").to(device)
        model.load_state_dict(cpu_model.state_dict())
        engine = ShardedEngine(model, ServeConfig(
            max_batch_size=2, max_len=96, max_prefill_len=16,
            long_prefill_buckets=(32, 64), kv_block_size=8,
            cache_dtype=torch.float32, prefill_mode="sequence",
            seq_prefill_variant=variant), mesh_devices=2,
            devices=[device] * 2)
        before = engine.kernel_launches()
        sched = Scheduler(engine)
        for i, p in enumerate(prompts):
            sched.submit(Request(prompt=p, max_new_tokens=8,
                                 request_id=str(i)))
        sched.run_until_idle(max_iters=200)
        engine.pool.leak_check()
        assert engine.pool.prefix_hits >= 1
        if device.type == "cuda":
            ran = {k: v - before[k]
                   for k, v in engine.kernel_launches().items()}
            per_chunk = 2 * layers * engine.prefill_chunks
            assert ran["paged_prefill_qoff"] == (
                2 * per_chunk if variant == "ring" else 0)
            assert ran["paged_prefill"] == (
                per_chunk if variant == "ulysses" else 0)
            assert ran["paged_decode"] == 2 * layers * engine.step_calls
        results.append({k: r.tokens for k, r in sched.results.items()})
    assert results[0] == results[1]


# (S_q, S_k, D, causal, kv_lengths): a causal row cut mid-tile, a
# rectangular full case with a D that is 8 mod 16 (the padded last mma
# step; the Hopper bodies pad it to 64 columns), D=128 with a zero-length
# row and a length past S, the training length (eight 128-query tiles,
# heaviest first), and D=128 over two 128-key tiles with a length that
# ends inside the second; then the dq kernel's cases: S=130 at B*H=6 with
# D=64 (lse and delta rows start at odd multiples of 4 bytes), D=64 and
# D=128 at the training length with lengths [0, 700], and D=40 at S=200.
# One row per length, else B=2; B=1 at S=1024.
FLASH_CASES = [(100, 100, 64, True, None), (100, 70, 40, False, None),
               (130, 130, 128, True, [0, 77, 500]),
               (1024, 1024, 64, True, None),
               (200, 200, 128, True, [0, 150]),
               (130, 130, 64, True, [0, 77, 500]),
               (1024, 1024, 64, True, [0, 700]),
               (1024, 1024, 128, True, [0, 700]),
               (200, 200, 40, True, None)]
# The kernels each dtype's call must launch (profiler names): bf16 the
# Hopper bodies, fp32 the first ones; the delta pre-pass for both.
FLASH_KERNELS = {
    torch.bfloat16: {"flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                     "flash_bwd_delta_kernel", "flash_bwd_dkv_wgmma_kernel"},
    torch.float32: {"flash_fwd_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_delta_kernel", "flash_bwd_dkv_kernel"}}


def _device_kernels(fn, attempts=3, calls=2):
    """Names of the CUDA kernels ``fn`` launches, under torch.profiler
    (return type, namespaces and template arguments dropped). The profiler
    records ``calls`` calls of fn after a warm-up one: CUPTI drops events
    while it starts up, and now and then the first kernel of the recorded
    step, so a kernel that every call launches is named unless all of
    its launches were dropped. A profile that caught no device event at
    all is taken again, up to ``attempts`` times, as ``chip_smoke.py``
    does. Each profile that caught no event, or caught a kernel a number
    of times that is not a multiple of ``calls``, is reported as a
    warning, so a run's warnings summary says how often, and in which
    cases, events were dropped."""
    import collections
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for n in (1, calls):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        seen = collections.Counter()
        for e in prof.events():
            if e.device_type != DeviceType.CUDA \
                    or e.name.startswith("ProfilerStep"):
                continue
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1]
            seen[name.replace("void ", "").strip()] += 1
        dropped = {k: c for k, c in seen.items() if c % calls}
        if dropped:
            warnings.warn(f"torch.profiler dropped launches of {dropped} "
                          f"over {calls} calls (attempt {attempt})")
        if seen:
            break
        warnings.warn(f"torch.profiler caught no device event (attempt "
                      f"{attempt} of {attempts})")
    return set(seen)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_q,s_k,d,causal,lengths", FLASH_CASES)
def test_flash_kernels_match_plain(cuda_device, dtype, s_q, s_k, d, causal,
                                   lengths):
    """Forward out within fold_error_bound and lse within 1e-4 (fp32 sums
    in another order), dq/dk/dv within flash_bwd_error_bound, padded keys'
    dk/dv exactly zero, the backward bitwise repeatable, and each call on
    its dtype's kernels: the Hopper (wgmma) bodies for bf16."""
    rng = np.random.RandomState(s_q + d)
    b = len(lengths) if lengths else (1 if s_q >= 1024 else 2)
    q, do = (torch.from_numpy(rng.randn(b, 2, s_q, d).astype(np.float32))
             .to(cuda_device, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, 2, s_k, d).astype(np.float32))
            .to(cuda_device, dtype) for _ in range(2))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=cuda_device))
    before = dict(LAUNCHES)
    out, lse = flash_block_fwd(q, k, v, causal, kv_lengths=lens)
    torch.cuda.synchronize()
    want, want_lse = flash_block_fwd_plain(q, k, v, causal, kv_lengths=lens)
    abs_v = flash_block_fwd_plain(q, k, v.abs(), causal, kv_lengths=lens)[0]
    _assert_within_bound(out, want, abs_v, dtype == torch.bfloat16)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    args = (q, k, v, want, want_lse, do, causal)
    grads = flash_block_bwd(*args, kv_lengths=lens)
    torch.cuda.synchronize()
    plain = flash_block_bwd_plain(*args, kv_lengths=lens)
    bounds = flash_bwd_error_bound(*args, kv_lengths=lens)
    for name, got, w, bd in zip(("dq", "dk", "dv"), grads, plain, bounds):
        err = (got.float() - w.float()).abs()
        assert torch.all(err <= bd), (
            f"{name}: max |kernel - plain| / bound "
            f"{(err / bd).max().item():.3f}")
    for i, n in enumerate(lengths or []):
        n = max(1, min(n, s_k))
        assert torch.all(grads[1][i, :, n:] == 0)
        assert torch.all(grads[2][i, :, n:] == 0)
    again = flash_block_bwd(*args, kv_lengths=lens)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    # One delta pre-pass a backward, read by both dq and dK/dV.
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "flash_fwd": 1, "flash_bwd_dq": 2, "flash_bwd_delta": 2,
        "flash_bwd_dkv": 2}
    ran = _device_kernels(lambda: (
        flash_block_fwd(q, k, v, causal, kv_lengths=lens),
        flash_block_bwd(*args, kv_lengths=lens)))
    assert {n for n in ran if n.startswith("flash_")} == \
        FLASH_KERNELS[dtype], ran


# BERT-base's attention shape (B=16, H=12, S=512, D=64, non-causal) and
# the right-padded lengths of chip_smoke.py's train_bert check.
BERT_LENGTHS = [512, 300, 1, 0, 511, 257, 256, 128, 64, 65, 500, 200, 100,
                450, 350, 2]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [8, 8192])
def test_layer_norm_kernels_take_bert_eps(cuda_device, dtype, rows):
    """BERT's ln_eps of 1e-12 reaches both LayerNorm kernels unclamped:
    on rows of variance 1e-8, where rsqrt(var + eps) is 1e4 with it and
    316 with an eps of 1e-5, the forward and backward stay within
    layer_norm_error_bound of the plain versions at eps 1e-12."""
    eps = 1e-12
    rng = np.random.RandomState(rows)
    x, dy = (torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
             for a in (1e-4 * rng.randn(rows, 768), rng.randn(rows, 768)))
    scale, bias = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                   for a in (1 + 0.3 * rng.randn(768), 0.2 * rng.randn(768)))
    y = layer_norm_fwd(x, scale, bias, eps)
    grads = layer_norm_bwd(x, scale, dy, eps)
    torch.cuda.synchronize()
    err = (y.float() - layer_norm_fwd_plain(x, scale, bias, eps).float())
    bound = layer_norm_error_bound(x, scale, bias, eps)
    assert torch.all(err.abs() <= bound), (err.abs() / bound).max().item()
    assert y.float().std().item() > 0.5      # normalized, not shrunk
    plain = layer_norm_bwd_plain(x, scale, dy, eps)
    bounds = layer_norm_error_bound(x, scale, bias, eps, dy=dy)
    for name, g, w, bd in zip(("dx", "dscale", "dbias"),
                              (grads[0].float(), grads[1], grads[2]),
                              (plain[0].float(), plain[1], plain[2]),
                              bounds):
        assert torch.all((g - w).abs() <= bd), (
            f"{name}: max |kernel - plain| / bound "
            f"{((g - w).abs() / bd).max().item():.3f}")


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [None, BERT_LENGTHS],
                         ids=["full", "right-padded"])
def test_bert_flash_shape_matches_plain(cuda_device, lengths):
    """The three flash kernels and the delta pre-pass at BERT's shape in
    bf16, non-causal, with and without lengths: the forward within
    fold_error_bound and its lse within 1e-4, dq/dk/dv within
    flash_bwd_error_bound, padded keys' dk/dv exactly zero, one launch of
    each a forward and backward."""
    rng = np.random.RandomState(16)
    q, k, v, do = (torch.from_numpy(rng.randn(16, 12, 512, 64).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(4))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=cuda_device))
    before = dict(LAUNCHES)
    out, lse = flash_block_fwd(q, k, v, False, kv_lengths=lens)
    torch.cuda.synchronize()
    want, want_lse = flash_block_fwd_plain(q, k, v, False, kv_lengths=lens)
    abs_v = flash_block_fwd_plain(q, k, v.abs(), False, kv_lengths=lens)[0]
    _assert_within_bound(out, want, abs_v, True)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    args = (q, k, v, want, want_lse, do, False)
    grads = flash_block_bwd(*args, kv_lengths=lens)
    torch.cuda.synchronize()
    plain = flash_block_bwd_plain(*args, kv_lengths=lens)
    bounds = flash_bwd_error_bound(*args, kv_lengths=lens)
    for name, got, w, bd in zip(("dq", "dk", "dv"), grads, plain, bounds):
        err = (got.float() - w.float()).abs()
        assert torch.all(err <= bd), (
            f"{name}: max |kernel - plain| / bound "
            f"{(err / bd).max().item():.3f}")
    for i, n in enumerate(lengths or []):
        n = max(1, n)
        assert torch.all(grads[1][i, :, n:] == 0)
        assert torch.all(grads[2][i, :, n:] == 0)
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_delta": 1,
        "flash_bwd_dkv": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("padded", [False, True], ids=["full", "lengths"])
def test_bert_train_step_flash_matches_composed_on_card(cuda_device, padded):
    """One tiny-preset (f32) BERT step on the card with the flash kernels
    (non-causal) against the same step with composed attention, same
    weights and batch, with or without right-padding lengths (labels -100
    past them): loss within 1e-5, every gradient within 1e-6 + 1e-4 of
    its tensor's largest magnitude."""
    from nezha_tpu_torch.cli.common import TINY_BERT_KW
    from nezha_tpu_torch.data import synthetic_mlm_batches
    from nezha_tpu_torch.models.bert import Bert, BertConfig, mlm_loss

    batch = dict(next(synthetic_mlm_batches(4, seq_len=64, vocab_size=512,
                                            mask_token=1)))
    if padded:
        lengths = np.array([64, 37, 1, 0], np.int32)
        past = np.arange(64)[None, :] >= lengths[:, None]
        batch["labels"] = np.where(past, -100, batch["labels"])
        batch["kv_lengths"] = lengths
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    results = []
    for impl in ("flash", "xla"):
        model = Bert(BertConfig(**TINY_BERT_KW, attn_impl=impl),
                     generator=gen)
        if results:
            model.load_state_dict(first)
        else:
            first = model.state_dict()
        before = LAUNCHES["flash_fwd"]
        loss, grads = make_train_step(model, adamw(1e-4, weight_decay=0.01),
                                      mlm_loss).loss_and_grads(batch)
        launched = LAUNCHES["flash_fwd"] - before
        assert launched == (2 if impl == "flash" else 0)   # 2 layers
        results.append((loss.item(), {k: g.cpu() for k, g in grads.items()}))
    (l_flash, g_flash), (l_xla, g_xla) = results
    assert abs(l_flash - l_xla) <= 1e-5
    for name, g in g_xla.items():
        tol = 1e-6 + 1e-4 * g.abs().max().item()
        assert (g_flash[name] - g).abs().max().item() <= tol, name


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda_device):
    """One tiny-preset (f32) AdamW step on the card (flash kernels) and on
    the CPU (plain versions), same weights and batch: loss within 1e-5,
    every gradient within 1e-6 + 1e-4 of its tensor's largest magnitude,
    weights after the step within 2 * lr (an update flips where a
    gradient element sits near Adam's eps) and within 1e-3 * lr where the
    CPU gradient exceeds 100 * eps."""
    lr = 6e-4
    tokens = np.random.RandomState(3).randint(0, 512, (2, 33)).astype(
        np.int32)
    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu")
    results = []
    for device in ("cpu", cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu").to(device)
        model.load_state_dict(cpu_model.state_dict())
        step = make_train_step(model, adamw(lr, weight_decay=0.1), lm_loss)
        before = LAUNCHES["flash_fwd"]
        loss, grads = step.loss_and_grads({"tokens": tokens})
        step({"tokens": tokens})
        if device != "cpu":
            assert LAUNCHES["flash_fwd"] - before == 2 * 4   # 2 x 4 layers
        results.append((loss.item(), {k: g.cpu() for k, g in grads.items()},
                        {k: p.detach().cpu() for k, p in
                         step.params.items()}))
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = results
    assert abs(l_cpu - l_gpu) <= 1e-5
    for name, g in g_cpu.items():
        tol = 1e-6 + 1e-4 * g.abs().max().item()
        assert (g_gpu[name] - g).abs().max().item() <= tol, name
        diff = (p_gpu[name] - p_cpu[name]).abs()
        assert diff.max().item() <= 2 * lr, name
        clear = g.abs() > 100 * 1e-8
        if clear.any():
            assert diff[clear].max().item() <= 1e-3 * lr, name


# The dense decode kernel's (q, cache) dtype pairs: all four it takes.
DENSE_DTYPES = ALL_DTYPES


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,cache_dtype", DENSE_DTYPES)
def test_dense_decode_kernel_matches_plain(cuda_device, q_dtype,
                                           cache_dtype):
    """The dense flash-decode kernel, split over the KV length, within
    fold_error_bound of its plain version over lengths that end inside a
    split, on its boundaries (one before, at, one past each of the first
    two), at the cache's end (not a multiple of the split) and past it;
    the zero-length row exact zero; two launches bitwise equal; one launch
    a call."""
    split = split_size("flash_decode")
    rng = np.random.RandomState(4)
    cap = 2 * split + 44
    lengths = np.asarray([0, 1, 31, split - 1, split, split + 1,
                          2 * split - 1, 2 * split, 2 * split + 1, cap,
                          cap + 9], np.int32)
    b = len(lengths)
    q = rng.randn(b, H, 1, D).astype(np.float32)
    k, v = (rng.randn(b, H, cap, D).astype(np.float32) for _ in range(2))
    dev = cuda_device
    args = (torch.from_numpy(q).to(dev, q_dtype),
            torch.from_numpy(k).to(dev, cache_dtype),
            torch.from_numpy(v).to(dev, cache_dtype),
            torch.from_numpy(lengths).to(dev))
    before = flash_decode_attention.launches
    got = flash_decode_attention(*args)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    assert got.dtype == q_dtype
    want = flash_decode_attention_plain(*args)
    abs_v = flash_decode_attention_plain(*args[:2], args[2].abs(), args[3])
    _assert_within_bound(got, want, abs_v, cache_dtype == torch.bfloat16)
    assert torch.all(got[0] == 0)
    assert torch.equal(flash_decode_attention(*args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,cache_dtype", DENSE_DTYPES)
def test_dense_decode_kernel_at_d128(cuda_device, q_dtype, cache_dtype):
    """The dense flash-decode kernel at the widest head it takes (D=128,
    MAX_D): within fold_error_bound of its plain version over lengths on
    and off its split boundaries, the zero-length row exact zero, two
    launches bitwise equal, one launch a call."""
    split = split_size("flash_decode")
    rng = np.random.RandomState(128)
    h, d, cap = 3, 128, 2 * split + 44
    lengths = np.asarray([0, 1, split - 1, split, split + 1, 2 * split + 1,
                          cap], np.int32)
    b = len(lengths)
    dev = cuda_device
    q = torch.from_numpy(rng.randn(b, h, 1, d).astype(np.float32)).to(
        dev, q_dtype)
    k, v = (torch.from_numpy(rng.randn(b, h, cap, d).astype(np.float32))
            .to(dev, cache_dtype) for _ in range(2))
    lens = torch.from_numpy(lengths).to(dev)
    before = flash_decode_attention.launches
    got = flash_decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    want = flash_decode_attention_plain(q, k, v, lens)
    abs_v = flash_decode_attention_plain(q, k, v.abs(), lens)
    _assert_within_bound(got, want, abs_v, cache_dtype == torch.bfloat16)
    assert torch.all(got[0] == 0)
    assert torch.equal(flash_decode_attention(q, k, v, lens), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(37, 768), (300, 64), (8, 1024)])
def test_layer_norm_kernels_match_plain(cuda_device, dtype, rows, d):
    """Forward y and backward dx, dscale, dbias (summed by the backward's
    second kernel) within layer_norm_error_bound of the plain versions;
    the backward bitwise repeatable; one launch of each kernel."""
    rng = np.random.RandomState(rows + d)
    x = rng.randn(rows, d) * 2 + rng.randn(rows, 1)
    x, dy = (torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
             for a in (x, rng.randn(rows, d)))
    scale, bias = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                   for a in (1 + 0.3 * rng.randn(d), 0.2 * rng.randn(d)))
    before = dict(LN_LAUNCHES)
    y = layer_norm_fwd(x, scale, bias, 1e-5)
    grads = layer_norm_bwd(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    assert {k: LN_LAUNCHES[k] - before[k] for k in LN_LAUNCHES} == {
        "layer_norm_fwd": 1, "layer_norm_bwd": 1, "layer_norm_bwd_sums": 1}
    err = (y.float() - layer_norm_fwd_plain(x, scale, bias, 1e-5).float())
    bound = layer_norm_error_bound(x, scale, bias, 1e-5)
    assert torch.all(err.abs() <= bound), (err.abs() / bound).max().item()
    plain = layer_norm_bwd_plain(x, scale, dy, 1e-5)
    got = (grads[0].float(), grads[1], grads[2])
    want = (plain[0].float(), plain[1], plain[2])
    bounds = layer_norm_error_bound(x, scale, bias, 1e-5, dy=dy)
    for name, g, w, bd in zip(("dx", "dscale", "dbias"), got, want, bounds):
        assert torch.all((g - w).abs() <= bd), (
            f"{name}: max |kernel - plain| / bound "
            f"{((g - w).abs() / bd).max().item():.3f}")
    again = layer_norm_bwd(x, scale, dy, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 768, 1024])
@pytest.mark.parametrize("rows", [1, 37, 8192, 8193])
def test_layer_norm_bwd_kernel_on_each_plan(cuda_device, dtype, d, rows):
    """The backward on its persistent grid (one row; fewer rows than
    warps; a train step's 8192 rows, 3-4 a warp; one past it) within
    layer_norm_error_bound of the plain version on dx, dscale and dbias
    (fp32 [D], summed over the rows by its second kernel); one launch of
    the backward kernel and of its sums kernel, none of the forward; two
    runs bitwise equal."""
    rng = np.random.RandomState(rows + d)
    x = rng.randn(rows, d) * rng.uniform(0.5, 3.0, (rows, 1)) \
        + rng.randn(rows, 1) * 2
    x, dy = (torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
             for a in (x, rng.randn(rows, d)))
    scale, bias = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                   for a in (1 + 0.3 * rng.randn(d), 0.2 * rng.randn(d)))
    before = dict(LN_LAUNCHES)
    grads = layer_norm_bwd(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    assert {k: LN_LAUNCHES[k] - before[k] for k in LN_LAUNCHES} == {
        "layer_norm_fwd": 0, "layer_norm_bwd": 1, "layer_norm_bwd_sums": 1}
    assert grads[0].dtype == dtype
    assert grads[1].shape == grads[2].shape == (d,)
    assert grads[1].dtype == grads[2].dtype == torch.float32
    plain = layer_norm_bwd_plain(x, scale, dy, 1e-5)
    bounds = layer_norm_error_bound(x, scale, bias, 1e-5, dy=dy)
    for name, g, w, bd in zip(("dx", "dscale", "dbias"), grads, plain,
                              bounds):
        err = (g.float() - w.float()).abs()
        assert torch.all(err <= bd), (
            f"{name}: max |kernel - plain| / bound "
            f"{(err / bd).max().item():.3f}")
    again = layer_norm_bwd(x, scale, dy, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 8192])
def test_layer_norm_bwd_entry_takes_only_its_plan(cuda_device, rows):
    """The backward's C entry point launches bwd_plan's geometry for the
    card; any other geometry (a grid one block larger or smaller, another
    lane width, another block size) is refused with cudaErrorInvalidValue
    and writes nothing."""
    import ctypes
    import dataclasses

    from nezha_tpu_torch.ops.cuda import layer_norm as ln

    d = 768
    x, dy = (torch.randn(rows, d, device=cuda_device).to(torch.bfloat16)
             for _ in range(2))
    scale = torch.ones(d, device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = ln.bwd_plan(rows, d, x.dtype, sms)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    parts = ln._bwd_workspace(x.device, stream, 2 * (plan.blocks + 1) * d)
    fn = build.bind("layer_norm", "nezha_layer_norm_bwd", ln._BWD_ARGTYPES)
    others = [dataclasses.replace(plan, blocks=plan.blocks + 1),
              dataclasses.replace(plan, blocks=plan.blocks - 1),
              dataclasses.replace(plan, cpl=plan.cpl + 1),
              dataclasses.replace(plan, warps=4)]
    for other in others:
        dx = torch.full_like(x, 7.0)
        ds = torch.full((d,), 7.0, device=cuda_device)
        db = torch.full((d,), 7.0, device=cuda_device)
        rc = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                ds.data_ptr(), db.data_ptr(), rows, d, ctypes.c_float(1e-5),
                build.DTYPE_CODES[x.dtype], stream, other.cpl, other.warps,
                other.blocks, parts.data_ptr())
        torch.cuda.synchronize()
        assert rc == 1, (other, rc)                 # cudaErrorInvalidValue
        assert torch.all(dx == 7.0) and torch.all(ds == 7.0)
        assert torch.all(db == 7.0)
    grads = layer_norm_bwd(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    assert torch.all(torch.isfinite(grads[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 768, 1024])
@pytest.mark.parametrize("rows", [1, 8, 132, 4096, 8192])
def test_layer_norm_fwd_kernel_on_each_plan(cuda_device, dtype, d, rows):
    """The forward on the rows each path gives it (a row per block up to
    one per SM; the persistent grid past that, its warps taking several
    rows each at 4096 and 8192) within layer_norm_error_bound of the
    plain version, and bitwise repeatable."""
    rng = np.random.RandomState(rows + d)
    x = rng.randn(rows, d) * rng.uniform(0.5, 3.0, (rows, 1)) \
        + rng.randn(rows, 1) * 2
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device, dtype)
    scale, bias = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                   for a in (1 + 0.3 * rng.randn(d), 0.2 * rng.randn(d)))
    y = layer_norm_fwd(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    err = (y.float() - layer_norm_fwd_plain(x, scale, bias, 1e-5).float())
    bound = layer_norm_error_bound(x, scale, bias, 1e-5)
    assert torch.all(err.abs() <= bound), (err.abs() / bound).max().item()
    assert torch.equal(layer_norm_fwd(x, scale, bias, 1e-5), y)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 8192])
def test_layer_norm_fwd_entry_takes_only_its_plan(cuda_device, rows):
    """The forward's C entry point launches fwd_plan's geometry for the
    card and records it (launched_fwd_plan); the wrapper counts the launch
    under its row count; any other geometry is refused with
    cudaErrorInvalidValue and writes nothing."""
    import ctypes
    import dataclasses

    from nezha_tpu_torch.ops.cuda import layer_norm as ln

    d = 768
    x = torch.randn(rows, d, device=cuda_device).to(torch.bfloat16)
    scale = torch.ones(d, device=cuda_device)
    bias = torch.zeros(d, device=cuda_device)
    before = FWD_LAUNCHES_BY_ROWS.get(rows, 0)
    layer_norm_fwd(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert FWD_LAUNCHES_BY_ROWS[rows] == before + 1
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = ln.fwd_plan(rows, d, x.dtype, sms)
    assert ln.launched_fwd_plan() == plan
    fn = build.bind("layer_norm", "nezha_layer_norm_fwd", ln._FWD_ARGTYPES)
    others = [dataclasses.replace(plan, blocks=plan.blocks + 1),
              dataclasses.replace(plan, blocks=plan.blocks - 1),
              dataclasses.replace(plan, cpl=plan.cpl + 1),
              dataclasses.replace(plan, warps=4)]
    for other in others:
        y = torch.full_like(x, 7.0)
        rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                y.data_ptr(), rows, d, ctypes.c_float(1e-5),
                build.DTYPE_CODES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream, other.cpl,
                other.warps, other.blocks)
        torch.cuda.synchronize()
        assert rc == 1, (other, rc)                 # cudaErrorInvalidValue
        assert torch.all(y == 7.0)
    assert ln.launched_fwd_plan() == plan


@pytest.mark.gpu
def test_generate_on_card_matches_cpu(cuda_device):
    """The tiny preset (f32) with ln_impl="pallas" and an f32 cache
    generates the same greedy tokens on the card (flash, flash-decode and
    LayerNorm kernels) as on the CPU (plain versions), and the card's run
    launches the decode kernel once per layer per decode step and the
    LayerNorm forward 9 times per forward (2 per block + ln_f)."""
    prompt = torch.from_numpy(
        np.random.RandomState(5).randint(0, 512, (2, 8)))
    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu",
                                ln_impl="pallas")
    results = []
    for device in ("cpu", cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu",
                                ln_impl="pallas").to(device)
        model.load_state_dict(cpu_model.state_dict())
        dec, ln = flash_decode_attention.launches, dict(LN_LAUNCHES)
        out = generate(model, prompt, 12, cache_dtype=torch.float32)
        if device != "cpu":
            assert flash_decode_attention.launches - dec == 11 * 4
            assert LN_LAUNCHES["layer_norm_fwd"] - ln["layer_norm_fwd"] \
                == 12 * 9
        results.append(out.cpu())
    assert torch.equal(results[0], results[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_checkpoint_round_trip_on_card_is_exact(cuda_device, tmp_path, dtype):
    """The tiny GPT-2 on the card (f32, or bf16 compute over fp32 master
    weights), two AdamW steps through the flash kernels, saved in the
    reference's npz format and restored into a fresh module and
    optimizer: every leaf bitwise, the fixed-batch loss bitwise, and one
    more step from both states gives bitwise-equal weights (the flash
    backward is deterministic: no atomics in dq or dK/dV)."""
    from nezha_tpu_torch.cli.common import TINY_GPT2_KW
    from nezha_tpu_torch.models import GPT2, GPT2Config
    from nezha_tpu_torch.tensor.policy import bf16_policy, f32_policy
    from nezha_tpu_torch.train import Trainer
    from nezha_tpu_torch.train import checkpoint as ckpt

    policy = bf16_policy() if dtype == "bf16" else f32_policy()
    r = np.random.RandomState(4)
    batches = [{"tokens": r.randint(0, 512, (2, 65)).astype(np.int32)}
               for _ in range(4)]

    def trainer(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = GPT2(GPT2Config(**TINY_GPT2_KW), policy=policy,
                     generator=gen)
        return Trainer(model, adamw(6e-4, weight_decay=0.1), lm_loss,
                       checkpoint_dir=str(tmp_path), log_every=0)

    def fixed_loss(model):
        batch = {"tokens": torch.as_tensor(batches[3]["tokens"]).long()
                 .cuda()}
        with torch.no_grad():
            return lm_loss(model(batch), batch).float()

    a = trainer(0)
    launched = LAUNCHES["flash_bwd_dq"]
    a.fit(iter(batches[:2]), 2)
    assert LAUNCHES["flash_bwd_dq"] - launched == 2 * 4
    a.model.train()
    before = fixed_loss(a.model)
    a.save()
    saved = ckpt.verify_checkpoint(str(tmp_path), 2)
    b = trainer(1)
    assert b.initialize() == 2
    mine = b.state_dict()
    assert mine.keys() == saved.keys()
    for key, want in saved.items():
        assert mine[key].dtype == want.dtype, key
        np.testing.assert_array_equal(mine[key], want, err_msg=key)
    b.model.train()
    assert torch.equal(fixed_loss(b.model), before)
    a.fit(iter(batches[2:3]), 1)
    b.fit(iter(batches[2:3]), 1)
    for name, t in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[name], t), name


@pytest.mark.gpu
def test_int8_wire_quantizes_on_card_as_on_cpu(cuda_device):
    """The int8 gradient wire's blocks on the card: the same int8 bytes
    and fp32 scales as on the CPU, and the same round trip."""
    from nezha_tpu_torch.ops.quant import quantize_blocks
    from nezha_tpu_torch.parallel.quantized import quantize_roundtrip

    x = torch.from_numpy(
        (np.random.RandomState(3).randn(4, 64 * 512) * 7).astype(np.float32))
    x[0, :512] = 0.0          # an all-zero block: scale 1
    q_cpu, s_cpu = quantize_blocks(x, 512)
    q_gpu, s_gpu = quantize_blocks(x.cuda(), 512)
    assert torch.equal(q_gpu.cpu(), q_cpu)
    assert torch.equal(s_gpu.cpu(), s_cpu)
    assert torch.equal(quantize_roundtrip(x.cuda()).cpu(),
                       quantize_roundtrip(x))


@pytest.mark.gpu
def test_dp_and_zero1_over_nccl_at_world1_are_the_single_step(cuda_device):
    """NCCL at world 1: the dp and ZeRO-1 steps give bitwise the weights
    of the single-device step (the mean over one rank is a copy; AdamW
    is elementwise on ZeRO-1's flat chunks); the int8 wire trains."""
    import torch.distributed as dist

    from nezha_tpu_torch.cli.common import TINY_GPT2_KW
    from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from nezha_tpu_torch.parallel.data_parallel import DPTrainStep
    from nezha_tpu_torch.parallel.zero1 import Zero1TrainStep

    r = np.random.RandomState(5)
    batches = [{"tokens": r.randint(0, 512, (2, 65)).astype(np.int32)}
               for _ in range(3)]

    def run(kind, **kw):
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = GPT2(GPT2Config(**TINY_GPT2_KW), generator=gen)
        step = kind(model, adamw(6e-4, weight_decay=0.1), lm_loss, **kw)
        losses = [step(b)["loss"].item() for b in batches]
        return losses, model.state_dict()

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        want_losses, want = run(lambda *a: make_train_step(*a))
        for kind in (DPTrainStep, Zero1TrainStep):
            losses, got = run(kind)
            assert losses == want_losses, kind
            for k, t in want.items():
                assert torch.equal(got[k], t), (kind, k)
        losses, _ = run(DPTrainStep, grad_reduce="int8")
        assert all(np.isfinite(losses))
    finally:
        dist.destroy_process_group()


def _tier_traffic(sched):
    """Two-block prompts of four users, evicted by a wide one, then
    revisited with new tails. -> every request's tokens."""
    users = [[(13 * u + 3 * i + 5) % 97 for i in range(10)]
             for u in range(4)]
    waves = [[(f"u{u}", p) for u, p in enumerate(users)],
             [("wide", [(7 * i + 1) % 97 for i in range(30)])],
             [(f"r{u}", p[:8] + [u, 2 * u]) for u, p in enumerate(users)]]
    for wave in waves:
        for rid, p in wave:
            sched.submit(Request(prompt=p, max_new_tokens=2,
                                 request_id=rid))
        sched.run_until_idle(max_iters=400)
        sched.engine.pool.leak_check()
    return {k: r.tokens for k, r in sched.results.items()}


@pytest.mark.gpu
def test_host_tier_on_card_matches_cpu(cuda_device):
    """The int8 host tier on the card (its pinned arena, the copies queued
    on the stream with an event an entry) against the CPU's plain host
    arrays: the same demotions, promotions and keys, the same greedy
    tokens; a demoted entry read on the host equals its block as
    gathered on the card before the eviction, and a promoted block
    equals the entry."""
    from nezha_tpu_torch.serve.slots import _gather_blocks_quantized

    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu")
    cfg = ServeConfig(max_batch_size=2, max_len=32, max_prefill_len=8,
                      prefill_buckets=(4, 8), kv_block_size=4,
                      kv_num_blocks=9, kv_dtype="int8", kv_host_blocks=16,
                      cache_dtype=torch.float32)
    out = {}
    for device in ("cpu", cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu").to(device)
        model.load_state_dict(cpu_model.state_dict())
        engine = Engine(model, cfg)
        pool = engine.pool
        assert (pool._arena is not None) == (device != "cpu")
        seen = {}
        inner = pool._demote

        def demote(path, block, pool=pool, inner=inner, seen=seen):
            idx = torch.tensor([block], device=pool.caches[0]["k"].device)
            seen[tuple(path)] = [
                {k: v.cpu().numpy() for k, v in layer.items()}
                for layer in _gather_blocks_quantized(pool.caches, idx)]
            inner(path, block)

        pool._demote = demote
        tokens = _tier_traffic(Scheduler(engine))
        assert pool.demotions > 0 and pool.promotions > 0
        for key, entry in pool._host_tier.items():
            entry.wait()
            for mine, want in zip(entry, seen[key]):
                for name in want:
                    np.testing.assert_array_equal(mine[name], want[name])
        out[str(device)] = (tokens, pool.demotions, pool.promotions,
                            list(pool._host_tier), dict(pool.fleet_hits))
    assert out["cpu"] == out["cuda"]


@pytest.mark.gpu
def test_corrupt_poisons_on_the_card(cuda_device):
    """``faults.corrupt`` poisons a copy on the tensor's own card, the same
    seeded row as on the CPU, and leaves its input alone."""
    from nezha_tpu_torch import faults

    x = torch.arange(6 * 5, dtype=torch.float32).reshape(6, 5)
    got = {}
    for device in ("cpu", cuda_device):
        faults.install(faults.FaultPlan.parse("a.b:nan@1", seed=3))
        try:
            t = x.to(device)
            out = faults.corrupt("a.b", t, rows=[1, 3, 4])
        finally:
            faults.clear()
        assert out.device == t.device and torch.equal(t.cpu(), x)
        got[str(device)] = out.cpu()
    assert torch.equal(got["cpu"].isnan(), got["cuda"].isnan())
    assert int(got["cuda"].isnan().any(dim=1).sum()) == 1


@pytest.mark.gpu
def test_thread_fleet_on_card_matches_one_engine_and_releases_killed_engines(
        cuda_device):
    """A two-replica thread fleet of the serve CLI on the card answers
    one engine's greedy tokens, a request at a time; killing a replica
    and letting the supervisor restart it, twice, leaves the card's
    allocated memory where one restart left it (the killed worker's
    engine and pool are released)."""
    import http.client
    import json
    import threading
    import time

    from nezha_tpu_torch.cli import serve as serve_cli

    argv = ["--random-init", "--model-preset", "tiny", "--device", "cuda",
            "--max-len", "64", "--max-prefill-len", "16", "--kv-block-size",
            "8"]
    prompts = [[(5 * i + 3 * s) % 512 for i in range(n)]
               for s, n in enumerate((3, 12, 20, 9))]
    ref = serve_cli.build_scheduler(serve_cli.build_parser().parse_args(
        argv))
    want = []
    for i, p in enumerate(prompts):
        ref.submit(Request(prompt=p, max_new_tokens=6, request_id=f"r{i}"))
        ref.run_until_idle()
        want.append(ref.results[f"r{i}"].tokens)
    del ref
    args = serve_cli.build_parser().parse_args(argv + [
        "--replicas", "2", "--replica-backend", "thread", "--http", "0",
        "--probe-interval", "0.05", "--restart-backoff", "0.05"])
    ready, drain, box = threading.Event(), threading.Event(), {}

    def cb(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=lambda: serve_cli.run(
        args, ready_cb=cb, drain_event=drain), daemon=True)
    th.start()
    assert ready.wait(120)
    srv = box["server"]

    def post(port, prompt):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", "/generate", body=json.dumps({
                "prompt_tokens": prompt, "max_new_tokens": 6}).encode())
            resp = conn.getresponse()
            assert resp.status == 200
            return json.loads(resp.read())["tokens"]
        finally:
            conn.close()

    levels = []
    try:
        assert srv.router.wait_live(2, 120)
        assert [post(srv.server_address[1], p) for p in prompts] == want
        for _ in range(2):
            n = srv.supervisor.restarts
            srv.supervisor.kill(0)
            t_end = time.monotonic() + 60
            while not (srv.supervisor.restarts == n + 1
                       and srv.supervisor.live_count() == 2):
                assert time.monotonic() < t_end
                time.sleep(0.01)
            assert post(srv.supervisor.replicas()[0].port,
                        prompts[2]) == want[2]
            torch.cuda.synchronize()
            levels.append(torch.cuda.memory_allocated())
    finally:
        drain.set()
        th.join(60)
    assert levels[1] <= levels[0], levels
