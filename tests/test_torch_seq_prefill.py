"""Sequence-sharded prefill in the port against the JAX package:

- the q-offset prefill kernel's plain version (B11,
  ``paged_prefill_attention(..., q_offsets=...)``) against the Pallas
  kernel (``flash_prefill_attention(..., q_offsets=..., interpret=True)``)
  on the same numpy inputs: f32 to fp32 rounding, a bf16 pool to one bf16
  ulp of p; query slices bitwise equal to B9's rows of the full chunk;
  the int8 refusal;
- ``ring_attention_lse`` against one-shot causal attention;
- the port's ``ShardedEngine(prefill_mode="sequence")`` against JAX's
  (M=2, and M=4 for ring), greedy tokens identical: ulysses; ring against
  both JAX ring forms (its default composed ring-KV and, with
  ``prefill_impl="kernel"``, ring-q on B11 in interpret mode); int8 pools
  under ulysses (``auto``) and ring; long-bucket prompts and a
  shared-prefix repeat throughout;
- the port's ring and ulysses give bitwise-equal last-prompt logits.

Tiny model and weights as in test_torch_sharded.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.ops.pallas.prefill_attention import flash_prefill_attention
from nezha_tpu_torch.ops import dot_product_attention
from nezha_tpu_torch.ops.cuda import (paged_prefill_attention,
                                      paged_prefill_qoff_attention)
from nezha_tpu_torch.parallel import ring_attention_lse
from nezha_tpu_torch.serve import (Request, Scheduler, ServeConfig,
                                   ShardedEngine)
from test_torch_sharded import KW, jax_tokens, make_pair, run_waves

BS, M, H, D = 8, 12, 2, 16
S_KC, S_Q = 16, 8
# Cold, block-aligned (a chunked continuation) and mid-block (a
# shared-prefix hit capped inside a block) starts, one row each.
STARTS = (0, 16, 5)


def _case(seed):
    rng = np.random.RandomState(seed)
    b = len(STARTS)
    n = 1 + b * M
    q, kc, vc = (rng.randn(b, H, S_KC, D).astype(np.float32)
                 for _ in range(3))
    kp, vp = (rng.randn(n, H, BS, D).astype(np.float32) for _ in range(2))
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    return q, kc, vc, kp, vp, tab, np.asarray(STARTS, np.int32)


def _slices(q, starts):
    """-> [(q slice k, q_offsets k)] for the chunk's S_KC / S_Q slices."""
    return [(np.ascontiguousarray(q[:, :, k * S_Q:(k + 1) * S_Q]),
             (starts + k * S_Q).astype(np.int32))
            for k in range(S_KC // S_Q)]


def _jax(q, kc, vc, kp, vp, tab, starts, qoff, pool_dtype):
    return np.asarray(flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kp, pool_dtype), jnp.asarray(vp, pool_dtype),
        jnp.asarray(tab), jnp.asarray(starts), interpret=True,
        q_offsets=jnp.asarray(qoff)))


def _torch(q, kc, vc, kp, vp, tab, starts, qoff, pool_dtype):
    t = torch.from_numpy
    return paged_prefill_attention(
        t(q), t(kc), t(vc), t(kp).to(pool_dtype), t(vp).to(pool_dtype),
        t(tab), t(starts), q_offsets=t(qoff)).numpy()


# ------------------------------------------------------------------- B11
@pytest.mark.parametrize("pool", ["f32", "bf16"])
def test_qoff_matches_pallas_kernel(pool):
    """f32: the same fold order as the TPU kernel, so fp32 rounding (atol
    1e-5). A bf16 pool: both sides round q, p and the chunk's K/V through
    bf16, so what may differ is an fp32 sum's last bit moving a p across
    a bf16 rounding boundary: one bf16 ulp of p (2^-8 relative), at most
    2^-8 * max|v| on an output."""
    q, kc, vc, kp, vp, tab, starts = _case(0)
    tdt, jdt = ((torch.float32, jnp.float32) if pool == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    atol = 1e-5 if pool == "f32" else 2.0 ** -8 * float(np.abs(vp).max())
    for qs, qoff in _slices(q, starts):
        np.testing.assert_allclose(
            _torch(qs, kc, vc, kp, vp, tab, starts, qoff, tdt),
            _jax(qs, kc, vc, kp, vp, tab, starts, qoff, jdt),
            atol=atol, rtol=0)


def test_qoff_slices_bitwise_equal_b9():
    """Each query slice at its offset gets the bits B9 gives the same
    rows of the full chunk; q_offsets = starts over the whole chunk is
    B9."""
    q, kc, vc, kp, vp, tab, starts = (torch.from_numpy(a)
                                      for a in _case(1))
    for pool_dtype in (torch.float32, torch.bfloat16):
        kpp, vpp = kp.to(pool_dtype), vp.to(pool_dtype)
        full = paged_prefill_attention(q, kc, vc, kpp, vpp, tab, starts)
        for k in range(S_KC // S_Q):
            rows = slice(k * S_Q, (k + 1) * S_Q)
            got = paged_prefill_attention(
                q[:, :, rows].contiguous(), kc, vc, kpp, vpp, tab, starts,
                q_offsets=starts + k * S_Q)
            assert torch.equal(got, full[:, :, rows])
        assert torch.equal(paged_prefill_qoff_attention(
            q, kc, vc, kpp, vpp, tab, starts, starts), full)


def test_qoff_refusals():
    q, kc, vc, kp, vp, tab, starts = (torch.from_numpy(a)
                                      for a in _case(2))
    scales = (torch.ones(kp.shape[:2]), torch.ones(kp.shape[:2]))
    with pytest.raises(ValueError, match="float path"):
        paged_prefill_attention(q, kc, vc, kp.to(torch.int8),
                                vp.to(torch.int8), tab, starts,
                                block_scales=scales, q_offsets=starts)
    with pytest.raises(ValueError, match=r"on \(B, H, D\)"):
        paged_prefill_attention(q[:, :, :S_Q], kc[:, :1], vc, kp, vp, tab,
                                starts, q_offsets=starts)
    with pytest.raises(ValueError, match="q_offsets"):
        paged_prefill_attention(q[:, :, :S_Q], kc, vc, kp, vp, tab, starts,
                                q_offsets=starts[:1])
    with pytest.raises(ValueError, match="chunk k/v"):
        paged_prefill_attention(q[:, :, :S_Q], kc, vc, kp, vp, tab, starts)


# ------------------------------------------------------------------ ring
@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_lse_matches_causal_attention(world):
    """Sequence-sharded ring hops against one-shot causal attention over
    the whole sequence: the output, and the log-sum-exp the merge uses."""
    gen = torch.Generator().manual_seed(world)
    b, h, s, d = 2, 3, 16, 8
    q, k, v = (torch.randn(b, h, s, d, generator=gen) for _ in range(3))
    split = [list(t.chunk(world, dim=2)) for t in (q, k, v)]
    outs, lses = ring_attention_lse(*split)
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool))
    mask = torch.where(causal, 0.0, float("-inf"))
    want = dot_product_attention(q, k, v, mask=mask)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / d ** 0.5 + mask
    torch.testing.assert_close(torch.cat(outs, 2), want, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(torch.cat(lses, 2),
                               torch.logsumexp(scores, -1), atol=1e-5,
                               rtol=0)


# ------------------------------------------------------- engines vs JAX
@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def kernel_pair():
    """JAX with ``prefill_impl="kernel"``: its ring runs ring-q on B11 in
    interpret mode."""
    return make_pair(prefill_impl="kernel")


def _port(tm, m, **cfg_kw):
    return ShardedEngine(tm, ServeConfig(**KW, cache_dtype=torch.float32,
                                         prefill_mode="sequence", **cfg_kw),
                         mesh_devices=m)


@pytest.mark.parametrize("m,kv_dtype,variant,jax_impl", [
    (2, "bf16", "ulysses", None),
    (2, "bf16", "ring", None),
    (2, "bf16", "ring", "kernel"),
    (4, "bf16", "ring", None),
    (2, "int8", "auto", None),
    (2, "int8", "ring", None),
])
def test_sequence_greedy_matches_jax(pair, kernel_pair, m, kv_dtype,
                                     variant, jax_impl):
    """Greedy tokens identical to JAX's sequence-sharded engine over the
    long-bucket and shared-prefix waves (int8: tokens, as the JAX engine
    quantizes under jit, ROADMAP C); clean per-shard books after
    drain."""
    jm, jv, _ = kernel_pair if jax_impl == "kernel" else pair
    tm = pair[2]
    kw = dict(kv_dtype=kv_dtype, seq_prefill_variant=variant)
    want = jax_tokens(jm, jv, m, prefill_mode="sequence", **kw)
    eng = _port(tm, m, **kw)
    assert eng._seq_variant == ("ulysses" if variant == "auto" else variant)
    got = run_waves(eng, Request, Scheduler)
    assert got == want
    assert len({tuple(t) for t in got.values()}) > 3
    assert eng.pool.prefix_hits >= 1
    eng.pool.leak_check()
    eng.pool.clear_prefix_cache()
    assert eng.pool.bytes_resident_per_shard == 0


@pytest.mark.parametrize("m", [2, 4])
def test_ring_and_ulysses_last_logits_bitwise_equal(pair, m):
    """A fresh prefill of each prompt gives the same last-position logits
    to the bit under ring (B11 per hop) and ulysses (B9 per shard). The
    plain versions reduce through the CPU's matmul, which can give a row
    other bits for another row count when the chunk is under 16 rows or
    the slice under 4; these prompts plan into 16- and 32-wide chunks
    (no prefix cache, so no short suffix). On the card the kernels fold
    each row alone, and chip_smoke.py holds GPT-2's prompts bitwise."""
    tm = pair[2]
    engines = [_port(tm, m, seq_prefill_variant=v, prefix_cache=False)
               for v in ("ulysses", "ring")]
    rng = np.random.RandomState(3)
    for n in (12, 17, 27, 32, 48):
        prompt = rng.randint(0, 64, n).tolist()
        logits = []
        for eng in engines:
            assert all(w >= 16 for _, _, w in eng._plan_chunks(n))
            slot = eng.pool.alloc()
            eng.prefill(slot, prompt, max_new_tokens=1)
            logits.append(eng.last_logits[slot].clone())
            eng.pool.free(slot)
        assert torch.equal(logits[0], logits[1]), n
    for eng in engines:
        eng.pool.leak_check()
