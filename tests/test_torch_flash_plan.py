"""The flash kernels' launch geometry, decided in Python
(``nezha_tpu_torch/ops/cuda/flash_attention.py``: ``fwd_plan``,
``dq_plan``, ``dkv_plan``, ``launch_order``, ``fwd_visits``,
``dq_visits``, ``dkv_visits``, ``attended_pairs``) and passed to the CUDA
entry points, held here on the
CPU: every head dim the kernels took before still has a plan, every plan
fits in Hopper's shared memory, the causal launch order is heaviest first,
and the tiles each kernel visits, with the ones it masks, let through
exactly the (query, key) pairs the reference mask (``_valid``) leaves.
Also the delta pre-pass's plain version against JAX's delta.

Tolerance of the delta test: both sides sum ``dO * O`` in fp32 over D
terms in their own order. Their roundings differ in sign from term to
term, so the two sums drift apart like ``sqrt(D) * 2^-24`` of the row's
``sum |dO * O|`` (4.8e-7 at D = 64; the worst case, every rounding one
way, is ``D * 2^-24``); the test allows 1e-6 of it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu_torch.ops.cuda.flash_attention import (DKV_BUILDS,
                                                      DQ_BUILDS,
                                                      FWD_BUILDS,
                                                      MAX_SMEM_BYTES,
                                                      hopper_plan,
                                                      _valid, attended_pairs,
                                                      dkv_plan,
                                                      dkv_visits,
                                                      dq_plan, dq_visits,
                                                      flash_bwd_delta_plain,
                                                      fwd_plan, fwd_visits,
                                                      launch_order)

HEAD_DIMS = list(range(8, 129, 8))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
PLANS = {"fwd": fwd_plan, "dq": dq_plan, "dkv": dkv_plan}
LENGTHS = (0, 1, 517, None)   # None: the full sequence
SEQS = (1, 63, 64, 65, 100, 130, 1024)


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_head_dim_has_a_plan_that_fits(kernel, dtype):
    """D = 8..128 in steps of 8, in bf16 and fp32, as the kernels took
    before: each gets a plan whose shared memory fits in 232,448 bytes,
    whose tiles hold all of D, and whose rows split into whole groups."""
    for d in HEAD_DIMS:
        plan = PLANS[kernel](d, DTYPES[dtype])
        assert plan.kernel == kernel
        assert 0 < plan.smem_bytes <= MAX_SMEM_BYTES, (d, plan)
        assert plan.d_pad >= d
        assert plan.rows % 64 == 0
        if plan.wgmma:
            assert dtype == "bf16"
            # whole 128-byte swizzled lines, one or two a row
            assert plan.d_pad in (64, 128) and plan.d_pad - d < 64
            assert plan.stages >= 2
        else:
            assert dtype == "f32" and plan.d_pad == d


# Geometries of the Hopper bodies besides the shipped ones, as
# tools/tune_flash_plans.py builds them: the walks below hold for each.
OTHER_GEOMETRIES = {"fwd": [(2, 128, 2), (2, 128, 3), (1, 64, 4)],
                    "dq": [(2, 64, 2), (1, 64, 2), (1, 64, 4), (1, 128, 2)],
                    "dkv": [(2, 64, 2)]}


def _plans(kernel, dtype, d=64):
    """The plan the wrapper launches, and in bf16 the other geometries."""
    plans = [PLANS[kernel](d, DTYPES[dtype])]
    if dtype == "bf16":
        plans += [hopper_plan(kernel, plans[0].d_pad, *g)
                  for g in OTHER_GEOMETRIES[kernel]]
    return plans


def test_every_hopper_build_fits():
    """Each shipped build of the Hopper bodies fits in shared memory, and
    a one-consumer build (two blocks an SM) also fits twice, with the
    1 KiB the card reserves a block, in the SM's 233,472 bytes."""
    for kernel, builds in (("fwd", FWD_BUILDS), ("dq", DQ_BUILDS),
                           ("dkv", DKV_BUILDS)):
        assert sorted(builds) == [64, 128]
        for d_pad, geometry in builds.items():
            plan = hopper_plan(kernel, d_pad, *geometry)
            assert plan == PLANS[kernel](d_pad, torch.bfloat16)
            assert plan.smem_bytes <= MAX_SMEM_BYTES, plan
            assert plan.tile % 16 == 0 and plan.rows % 64 == 0
            if plan.rows == 64:
                assert 2 * (plan.smem_bytes + 1024) <= 233472, plan


def test_plans_pick_the_bodies_by_dtype_and_refuse_the_rest():
    assert fwd_plan(64, torch.bfloat16).wgmma
    assert dkv_plan(128, torch.bfloat16).wgmma
    assert not fwd_plan(64, torch.float32).wgmma
    assert not dkv_plan(40, torch.float32).wgmma
    for bad_d in (0, 4, 12, 136):
        with pytest.raises(ValueError):
            fwd_plan(bad_d, torch.bfloat16)
    with pytest.raises(ValueError):
        dkv_plan(64, torch.float16)


@pytest.mark.parametrize("d", [8, 40, 64, 72, 128])
def test_dq_plan_picks_the_body_by_dtype_and_refuses_the_rest(d):
    """bf16 takes the Hopper dq body at D padded to 64 or 128 columns
    (DQ_BUILDS), fp32 the first body at D itself, and any other dtype or
    head dim is refused before a launch."""
    bf, f32 = dq_plan(d, torch.bfloat16), dq_plan(d, torch.float32)
    assert bf.kernel == f32.kernel == "dq"
    assert bf.wgmma and bf.heavy_first and bf.d_pad == (64 if d <= 64
                                                        else 128)
    assert bf == hopper_plan("dq", bf.d_pad, *DQ_BUILDS[bf.d_pad])
    assert not f32.wgmma and not f32.heavy_first and f32.d_pad == d
    assert (f32.rows, f32.tile, f32.stages) == (64, 64, 1)
    # Q, dO, K and V tiles of D + 8 fp32 columns (csrc/flash_bwd.cu
    # launch_dq_f32)
    assert f32.smem_bytes == 4 * 4 * 64 * (d + 8)
    for dtype in (torch.float16, torch.int8):
        with pytest.raises(ValueError):
            dq_plan(d, dtype)
    for bad_d in (0, d + 4, 136):
        with pytest.raises(ValueError):
            dq_plan(bad_d, torch.bfloat16)


def test_plan_passes_six_ints_in_the_c_order():
    plan = hopper_plan("fwd", 128, 2, 128, 2)
    assert list(plan.as_c()) == [plan.d_pad, plan.rows, plan.tile,
                                 plan.stages, plan.smem_bytes,
                                 int(plan.heavy_first)]
    # Shared bytes the C side computes: Q, 2 stages of K and V, 5
    # barriers and 1024 bytes of alignment (csrc/flash_fwd.cu Fwd).
    assert plan.smem_bytes == 1024 + 128 * 128 * 2 * 5 + 8 * 5
    dkv = hopper_plan("dkv", 64, 2, 64, 2)
    # K, V, 2 stages of Q, dO, lse and delta (csrc/flash_bwd.cu Dkv)
    assert dkv.smem_bytes == (1024 + 2 * 128 * 64 * 2 + 2 * 2 * 64 * 64 * 2
                              + 2 * 2 * 64 * 4 + 8 * 5)
    dq = hopper_plan("dq", 128, 1, 64, 3)
    # Q, dO, 3 stages of K and V, 7 barriers (csrc/flash_bwd.cu Dq)
    assert dq.smem_bytes == (1024 + 2 * 64 * 128 * 2
                             + 3 * 2 * 64 * 128 * 2 + 8 * 7)


def _work(kernel, plan, s):
    """Tiles each row tile of a causal full-length (b, h) folds."""
    if kernel == "fwd":
        return [len(t) for t in fwd_visits(plan, s, s, True, s)]
    visits = dq_visits if kernel == "dq" else dkv_visits
    per_group = visits(plan, s, s, True, s)
    groups = plan.rows // 64
    return [sum(len(t) for t in per_group[i * groups:(i + 1) * groups])
            for i in range(len(per_group) // groups)]


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", SEQS)
def test_causal_launch_order_is_heaviest_first(kernel, dtype, s):
    for plan in _plans(kernel, dtype):
        order = launch_order(plan, s, causal=True)
        n = -(-s // plan.rows)
        assert sorted(order) == list(range(n))
        if plan.heavy_first:
            work = _work(kernel, plan, s)
            along = [work[t] for t in order]
            assert along == sorted(along, reverse=True), (order, work)
        assert launch_order(plan, s, causal=False) == list(range(n))


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", SEQS)
def test_tile_walk_lets_through_exactly_the_valid_pairs(kernel, dtype,
                                                        causal, s):
    """For lengths 0, 1, 517 and S (clamped to [1, S] as the kernels
    clamp them), the pairs of the tiles folded unmasked plus the pairs the
    mask keeps in the masked tiles are exactly _valid's; and an unmasked
    tile holds only valid pairs, so the mask is skipped only where it has
    nothing to remove."""
    for plan in _plans(kernel, dtype):
        _check_walk(plan, kernel, causal, s)


# BERT-base's training shape (B=16, H=12, S=512, D=64, non-causal; the
# walk is the same for every (b, h) of a length) and the right-padded
# lengths of chip_smoke.py's train_bert check, one a row.
BERT_S = 512
BERT_LENGTHS = (512, 300, 1, 0, 511, 257, 256, 128, 64, 65, 500, 200, 100,
                450, 350, 2)


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bert_shape_walks_non_causal(kernel, dtype):
    """At BERT's shape every plan launches its row tiles in order, and
    for each row's length the walk lets through exactly the valid pairs;
    dK/dV's key groups below the length each fold every query tile, from
    query 0."""
    plan = PLANS[kernel](64, DTYPES[dtype])
    n_rows = -(-BERT_S // plan.rows)
    assert launch_order(plan, BERT_S, causal=False) == list(range(n_rows))
    _check_walk(plan, kernel, False, BERT_S, BERT_LENGTHS)
    if kernel == "dkv":
        for n in BERT_LENGTHS:
            kv_len = max(1, n)
            for g, tiles in enumerate(dkv_visits(plan, BERT_S, BERT_S,
                                                 False, n)):
                want = (list(range(-(-BERT_S // plan.tile)))
                        if g * 64 < kv_len else [])
                assert [qt for qt, _ in tiles] == want, (n, g)


def _check_walk(plan, kernel, causal, s, lengths=LENGTHS):
    for n in lengths:
        n = s if n is None else n
        kv_len = max(1, min(n, s))
        want = _valid(s, s, causal, torch.tensor([kv_len]), "cpu")[0, 0]
        got = attended_pairs(plan, s, s, causal, n)
        assert torch.equal(got, want), (s, n)
        if kernel == "fwd":
            visits = fwd_visits(plan, s, s, causal, n)
            for qt, tiles in enumerate(visits):
                for kt, masked in tiles:
                    block = want[qt * plan.rows:(qt + 1) * plan.rows,
                                 kt * plan.tile:(kt + 1) * plan.tile]
                    assert masked or bool(block.all()), (qt, kt)
        elif kernel == "dq":
            visits = dq_visits(plan, s, s, causal, n)
            for g, tiles in enumerate(visits):
                for kt, masked in tiles:
                    block = want[g * 64:(g + 1) * 64,
                                 kt * plan.tile:(kt + 1) * plan.tile]
                    assert masked or bool(block.all()), (g, kt)
        else:
            visits = dkv_visits(plan, s, s, causal, n)
            for g, tiles in enumerate(visits):
                for qt, masked in tiles:
                    block = want[qt * plan.tile:(qt + 1) * plan.tile,
                                 g * 64:(g + 1) * 64]
                    assert masked or bool(block.all()), (g, qt)


def test_rectangular_walks_cover_the_valid_pairs():
    """Sq != Sk (non-causal only): the forward's and dK/dV's walks."""
    for kernel in PLANS:
        plan = PLANS[kernel](40, torch.bfloat16)
        for s_q, s_k in ((100, 70), (70, 100), (1, 300), (300, 1)):
            for n in (1, 37, s_k):
                want = _valid(s_q, s_k, False, torch.tensor([n]),
                              "cpu")[0, 0]
                assert torch.equal(
                    attended_pairs(plan, s_q, s_k, False, n), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_delta_plain_matches_jax(dtype):
    rng = np.random.RandomState(7)
    o, do = (rng.randn(2, 3, 37, 64).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jo, jdo = jnp.asarray(o, jdt), jnp.asarray(do, jdt)
    want = np.asarray(jnp.sum(jdo.astype(jnp.float32)
                              * jo.astype(jnp.float32), -1))
    got = flash_bwd_delta_plain(
        torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
            DTYPES[dtype]),
        torch.from_numpy(np.array(jdo.astype(jnp.float32))).to(
            DTYPES[dtype]))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 37)
    row = np.abs(np.asarray(jdo.astype(jnp.float32))
                 * np.asarray(jo.astype(jnp.float32))).sum(-1)
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * row)
