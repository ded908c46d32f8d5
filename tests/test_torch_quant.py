"""The int8 KV policy and the two int8 attention kernels of the port against
the JAX package, on the same numpy inputs:

- ``ops/quant`` bitwise against ``nezha_tpu.ops.quant`` run eagerly;
- the int8 paged decode kernel's plain version against the Pallas kernel
  (``flash_decode_attention(..., block_tables, block_scales)``, interpret
  mode);
- the int8 prefill kernel's plain version: its block write bitwise against
  the composed ``models/gpt2._quant_prefill_write``, its output and error
  sample against the Pallas kernel (``flash_prefill_attention(...,
  block_scales=...)``, interpret mode).

The CUDA kernels are held against these plain versions on the card in
test_torch_kernels_gpu.py."""

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.models.gpt2 import _quant_prefill_write as jax_prefill_write
from nezha_tpu.ops import quant as jq
from nezha_tpu.ops.pallas.decode_attention import flash_decode_attention
from nezha_tpu.ops.pallas.prefill_attention import flash_prefill_attention
from nezha_tpu_torch.models.gpt2 import _quant_prefill_write
from nezha_tpu_torch.ops import quant as tq
from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                      paged_prefill_attention,
                                      paged_quant_decode_attention,
                                      paged_quant_prefill_attention)


@pytest.fixture
def pallas_load(monkeypatch):
    # jax 0.9.0 dropped pl.load, which prefill_attention.py:212 calls in
    # the int8 kernel's write; a plain ref read does the same.
    monkeypatch.setattr(jax.experimental.pallas, "load",
                        lambda ref, idx: ref[idx], raising=False)


def _bits(x) -> np.ndarray:
    """Array -> its raw bits, so that equality is bitwise (NaN included)."""
    a = np.asarray(x)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.itemsize])


def _kv_cases():
    rng = np.random.default_rng(0)
    cases = {f"normal{i}": (rng.normal(size=(6, 4, 8, 16)) * 3.0 * 10.0
                            ** (i - 1)).astype(np.float32) for i in range(3)}
    # amax 127 gives scale 1.0 exactly, so x / scale is x: halves round to
    # even (0.5 -> 0, 1.5 -> 2, -2.5 -> -2, 2.5 -> 2).
    ties = np.zeros((2, 1, 4, 16), np.float32)
    ties[0, 0, 0, :6] = [127.0, 0.5, 1.5, -2.5, 2.5, -0.5]
    ties[1, 0, 1, :3] = [-127.0, 126.5, -125.5]
    cases["ties"] = ties
    cases["zero"] = np.zeros((3, 2, 4, 8), np.float32)
    nonfinite = rng.normal(size=(3, 2, 4, 8)).astype(np.float32)
    nonfinite[0, 0, 0, :3] = [np.nan, np.inf, -np.inf]
    nonfinite[1, 1, 2, 5] = np.nan
    nonfinite[2, 0, 3, 7] = -np.inf
    cases["nonfinite"] = nonfinite
    return cases


KV_CASES = _kv_cases()


@pytest.mark.parametrize("name", list(KV_CASES) + ["bf16"])
def test_quantize_kv_block_bitwise(name):
    """int8 values, scales and the dequantized tiles bitwise equal to
    JAX's; kv_roundtrip_error within 1e-6 relative (a max over the same
    fp32 values, so in practice equal)."""
    x = KV_CASES["normal1" if name == "bf16" else name]
    if name == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jqv, jsv = jq.quantize_kv_block(jx)
    tqv, tsv = tq.quantize_kv_block(tx)
    assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_bits(tsv), _bits(jsv))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize_kv_block(tqv, tsv, dtype).float()
        want = jq.dequantize_kv_block(jqv, jsv, jdtype).astype(jnp.float32)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(tq.sanitize(tx)), _bits(jq.sanitize(jx)))
    want_err = float(jq.kv_roundtrip_error(jx))
    got_err = tq.kv_roundtrip_error(tx).item()
    assert got_err == pytest.approx(want_err, rel=1e-6, abs=0.0)
    if name == "ties":
        np.testing.assert_array_equal(tqv.numpy()[0, 0, 0, :6],
                                      [127, 0, 2, -2, 2, 0])
        assert tsv[0, 0].item() == 1.0
    if name == "zero":
        assert torch.all(tsv == 1.0) and torch.all(tqv == 0)
    if name == "nonfinite":
        assert torch.isfinite(tsv).all()
        assert tqv[0, 0, 0, 1].item() == 127 and tqv[0, 0, 0, 2] == -127


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_blocks_bitwise(dtype):
    """The wire layout: int8 [..., k, block] and scales [..., k, 1]
    bitwise equal to JAX's, an all-zero block at scale 1, and
    dequantize bitwise."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 256)) * 2.0).astype(np.float32)
    x[1, 64:128] = 0.0
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x)
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    jqv, jsv = jq.quantize_blocks(jx, 64)
    tqv, tsv = tq.quantize_blocks(tx, 64)
    assert tuple(tqv.shape) == (3, 4, 64) and tuple(tsv.shape) == (3, 4, 1)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(_bits(tsv), _bits(jsv))
    assert tsv[1, 1, 0].item() == 1.0
    np.testing.assert_array_equal(_bits(tq.dequantize(tqv, tsv)),
                                  _bits(jq.dequantize(jqv, jsv)))


def test_scale_division_is_true_division():
    """The port divides amax by 127 exactly as JAX run eagerly does, over
    2^16 random magnitudes; jitted JAX multiplies by the reciprocal of 127
    instead, which moves the last bit of some scales (why the model and
    engine tests allow one ulp of scale)."""
    rng = np.random.default_rng(2)
    x = (np.abs(rng.normal(size=(1 << 16, 1, 1, 1)))
         * 10.0 ** rng.integers(-4, 4, (1 << 16, 1, 1, 1))).astype(np.float32)
    eager = np.asarray(jq.quantize_kv_block(jnp.asarray(x))[1]).ravel()
    jitted = np.asarray(
        jax.jit(jq.quantize_kv_block)(jnp.asarray(x))[1]).ravel()
    got = tq.quantize_kv_block(torch.from_numpy(x))[1].numpy().ravel()
    np.testing.assert_array_equal(_bits(got), _bits(eager))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(x[:, 0, 0, 0] / np.float32(127)))
    ulps = np.abs(_bits(jitted) - _bits(eager))
    assert ulps.max() == 1 and np.count_nonzero(ulps) > 0


# ------------------------------------------------------ int8 paged decode
BS, M, H, D = 8, 6, 2, 16
LENGTHS = (0, 1, BS - 1, BS, BS + 3, 2 * BS + 5, M * BS)


def _decode_case(seed, q_dtype):
    rng = np.random.RandomState(seed)
    b = len(LENGTHS)
    n = 1 + b * M
    q = rng.randn(b, H, 1, D).astype(np.float32)
    kq, ks = jq.quantize_kv_block(jnp.asarray(rng.randn(n, H, BS, D) * 2,
                                              jnp.float32))
    vq, vs = jq.quantize_kv_block(jnp.asarray(rng.randn(n, H, BS, D),
                                              jnp.float32))
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    jargs = (jnp.asarray(q, q_dtype), kq, vq, ks, vs,
             jnp.asarray(LENGTHS, jnp.int32), jnp.asarray(tab))
    return jargs


def _torch_decode_args(jargs, q_dtype):
    q, kq, vq, ks, vs, lengths, tab = (torch.from_numpy(np.array(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a))
        for a in jargs)
    return q.to(q_dtype), kq, vq, ks, vs, lengths, tab


@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
def test_quant_decode_matches_pallas_kernel(q_dtype):
    """Same tiles (int8 * scale rounded to q's dtype), same blocks folded
    in the same order: f32 agrees to fp32 rounding (atol 1e-5, the float
    decode test's); a bf16 output may round once the other way where the
    fp32 sums differ in the last bit (plus 2^-8 |out|). The length-0 row
    is exact zero."""
    jdt, tdt = ((jnp.float32, torch.float32) if q_dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jargs = _decode_case(0, jdt)
    q, kq, vq, ks, vs, lengths, tab = jargs
    want = np.asarray(flash_decode_attention(
        q, kq, vq, lengths, block_tables=tab, block_scales=(ks, vs),
        interpret=True).astype(jnp.float32))
    targs = _torch_decode_args(jargs, tdt)
    before = paged_quant_decode_attention.launches
    got = paged_decode_attention(targs[0], targs[1], targs[2], targs[5],
                                 targs[6], block_scales=targs[3:5])
    assert got.dtype == tdt and paged_quant_decode_attention.launches == before
    got = got.float().numpy()
    atol = 1e-5 + (2.0 ** -8 * np.abs(want) if q_dtype == "bf16" else 0.0)
    assert np.all(np.abs(got - want) <= atol)
    assert np.all(got[0] == 0.0)


def test_quant_decode_skips_blocks_past_length():
    """Blocks at or past a row's length are never read: NaN data-scale
    rows and saturated int8 there change nothing, bit for bit."""
    targs = list(_torch_decode_args(_decode_case(1, jnp.float32),
                                    torch.float32))
    q, kq, vq, ks, vs, lengths, tab = targs
    clean = paged_quant_decode_attention(*targs)
    for r, n in enumerate(LENGTHS):
        dead = tab[r, -(-n // BS):].long()
        kq[dead], vq[dead] = 127, -127
        ks[dead], vs[dead] = float("nan"), float("nan")
    poisoned = paged_quant_decode_attention(q, kq, vq, ks, vs, lengths, tab)
    assert torch.equal(clean, poisoned)


def test_quant_decode_rejects_bad_scales():
    q, kq, vq, ks, vs, lengths, tab = _torch_decode_args(
        _decode_case(2, jnp.float32), torch.float32)
    with pytest.raises(ValueError, match="block_scales"):
        paged_decode_attention(q, kq, vq, lengths, tab,
                               block_scales=(ks[:, :1], vs))


# ------------------------------------------------- int8 prefill + write
S = 12
# A cold start, a mid-block start, a block-aligned start, and a chunk that
# ends mid-block two blocks in.
STARTS = (0, 5, 2 * BS, 3 * BS + 2)


def _prefill_case(seed):
    """Pools whose blocks below each row's start hold real quantized
    content, and whose touched positions at or past start are poisoned:
    int8 +-127, and scale 1e3 on the blocks the chunk fills from their
    first position."""
    rng = np.random.RandomState(seed)
    b = len(STARTS)
    n = 1 + b * M
    q, kc, vc = (rng.randn(b, H, S, D).astype(np.float32) for _ in range(3))
    kq, ks = (np.array(a) for a in jq.quantize_kv_block(
        jnp.asarray(rng.randn(n, H, BS, D) * 3, jnp.float32)))
    vq, vs = (np.array(a) for a in jq.quantize_kv_block(
        jnp.asarray(rng.randn(n, H, BS, D), jnp.float32)))
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    for r, start in enumerate(STARTS):
        for t in range(start // BS, (start + S - 1) // BS + 1):
            blk = tab[r, t]
            lo = max(start - t * BS, 0)
            kq[blk, :, lo:], vq[blk, :, lo:] = 127, -127
            if lo == 0:
                ks[blk], vs[blk] = 1e3, 1e3
    return (q, kc, vc, kq.copy(), vq.copy(), ks.copy(), vs.copy(), tab,
            np.asarray(STARTS, np.int32))


def _torch_prefill(case):
    q, kc, vc, kq, vq, ks, vs, tab, starts = (torch.from_numpy(a.copy())
                                              for a in case)
    out, qerr = paged_prefill_attention(q, kc, vc, kq, vq, tab, starts,
                                        block_scales=(ks, vs))
    return out, qerr, kq, vq, ks, vs


def test_quant_prefill_write_bitwise_vs_composed():
    """The int8 prefill's pools and scales after the call are bitwise
    what JAX's composed write (``_quant_prefill_write``, run eagerly,
    row by row) leaves, on every block but scratch block 0; no poisoned
    value reaches a new scale; untouched blocks keep their bits; the
    port's own ``_quant_prefill_write`` agrees bitwise too."""
    case = _prefill_case(0)
    q, kc, vc, kq, vq, ks, vs, tab, starts = case
    _, qerr, tkq, tvq, tks, tvs = _torch_prefill(case)
    jpools = [jnp.asarray(a) for a in (kq, ks, vq, vs)]
    errs = []
    for r, start in enumerate(STARTS):
        row_tab = jnp.asarray(tab[r:r + 1])
        for i, new in ((0, kc), (2, vc)):
            jpools[i], jpools[i + 1], err = jax_prefill_write(
                jpools[i], jpools[i + 1], row_tab, start,
                jnp.asarray(new[r:r + 1]), S)
            errs.append(float(err))
    for got, want in zip((tkq, tks, tvq, tvs), jpools):
        np.testing.assert_array_equal(_bits(got[1:]), _bits(want[1:]))
    assert qerr.item() == max(errs)
    touched = {int(tab[r, t]) for r, st in enumerate(STARTS)
               for t in range(st // BS, (st + S - 1) // BS + 1)}
    untouched = sorted(set(range(1, kq.shape[0])) - touched)
    assert np.array_equal(tkq.numpy()[untouched], kq[untouched])
    assert np.array_equal(tks.numpy()[untouched], ks[untouched])
    assert tks[sorted(touched)].max().item() < 1.0    # 1e3 never survives
    # The port's composed write, row by row, gives the same bits.
    pools = [torch.from_numpy(a.copy()) for a in (kq, ks, vq, vs)]
    for r, start in enumerate(STARTS):
        row_tab = torch.from_numpy(tab[r:r + 1])
        _quant_prefill_write(pools[0], pools[1], row_tab, start,
                             torch.from_numpy(kc[r:r + 1]), S)
        _quant_prefill_write(pools[2], pools[3], row_tab, start,
                             torch.from_numpy(vc[r:r + 1]), S)
    for got, want in zip(pools, (tkq, tks, tvq, tvs)):
        assert torch.equal(got[1:], want[1:])


def test_quant_prefill_matches_pallas_kernel(pallas_load):
    """Output within 1e-5 of the Pallas kernel (f32: the same tiles folded
    in the same order), the error sample within 1e-6 relative, and every
    data block within one int8 step of the kernel's (its scales within
    one ulp: the kernel runs under jit, which multiplies by 1/127)."""
    case = _prefill_case(1)
    q, kc, vc, kq, vq, ks, vs, tab, starts = case
    out, kp2, vp2, ks2, vs2, jerr = flash_prefill_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, kq, vq, tab, starts)),
        block_scales=(jnp.asarray(ks), jnp.asarray(vs)), interpret=True)
    got, qerr, tkq, tvq, tks, tvs = _torch_prefill(case)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5,
                               rtol=0)
    assert qerr.item() == pytest.approx(float(jerr), rel=1e-6, abs=0.0)
    for got_s, want_s in ((tks, ks2), (tvs, vs2)):
        assert np.abs(_bits(got_s[1:]) - _bits(want_s[1:])).max() <= 1
    for got_q, want_q in ((tkq, kp2), (tvq, vp2)):
        diff = np.abs(got_q.numpy()[1:].astype(np.int32)
                      - np.asarray(want_q)[1:].astype(np.int32))
        assert diff.max() <= 1


def test_quant_prefill_attends_old_prefix():
    """The attention reads the prefix as it was before the call's own
    write re-rounds the block at ``start``: the output equals a float
    prefill over the dequantized pool taken before the call."""
    case = _prefill_case(2)
    q, kc, vc, kq, vq, ks, vs, tab, starts = (torch.from_numpy(a.copy())
                                              for a in case)
    kd = tq.dequantize_kv_block(kq, ks)
    vd = tq.dequantize_kv_block(vq, vs)
    want = paged_prefill_attention(q, kc, vc, kd, vd, tab, starts)
    got, _ = paged_quant_prefill_attention(q, kc, vc, kq, vq, ks, vs, tab,
                                           starts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("fault,match", [
    ("pool_dtype", "k_pool must be torch.int8"),
    ("scale_dtype", "v_scales must be torch.float32"),
    ("strided", "k_pool must be contiguous"),
    ("q_dtype", "q dtype"),
    ("head_dim", "a multiple of 16")])
def test_int8_operand_checks(fault, match):
    """What the int8 wrappers refuse, typed, before a CUDA launch: pools
    that are not int8, scales that are not fp32, strided operands, a
    query dtype the kernels lack, and a head dim that is not a multiple
    of 16 (one 16-byte load of int8)."""
    from nezha_tpu_torch.ops.cuda import build

    kq = torch.zeros(3, 2, 4, 16, dtype=torch.int8)
    ks = torch.zeros(3, 2)
    q = torch.zeros(2, 2, 1, 16)
    named = dict(k_pool=(kq, torch.int8), v_scales=(ks, torch.float32))
    with pytest.raises(ValueError, match=match):
        if fault == "pool_dtype":
            named["k_pool"] = (kq.float(), torch.int8)
        elif fault == "scale_dtype":
            named["v_scales"] = (ks.double(), torch.float32)
        elif fault == "strided":
            named["k_pool"] = (kq.transpose(2, 3), torch.int8)
        elif fault == "q_dtype":
            q = q.half()
        else:
            build.check_head_dim(24, multiple=16)
        build.check_operands(q, **named)
