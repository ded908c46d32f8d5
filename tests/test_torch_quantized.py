"""The port's int8 gradient wire (``parallel/quantized.py``) against the
JAX package's on the CPU: the helpers and the byte accounting exactly;
the collectives in 2 and 4 gloo processes (tests/torch_dist_worker.py)
against JAX's under ``shard_map`` on its host devices.

Under ``jax.jit`` XLA turns ``amax / 127`` into ``amax * (1/127)``, one ulp
off in about one scale in twenty (ROADMAP C8); the port keeps the
division, as JAX's eager functions do. A block whose scale moved by that
ulp dequantizes every element differently, and may round one to the
neighbouring int8 step, so against JAX's jitted collectives each element
is held within two steps of its block's scale (amax / 127, one a phase).
The exact oracle is the same algorithm composed from JAX's eager
``quantize_blocks`` and ``dequantize`` rank by rank: the port matches it
bit for bit at world 2 (a sum of two addends has one order) and within
rtol 1e-6 at world 4 (the fp32 sum of four rows in another order). Every
rank decodes the same bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nezha_tpu import parallel as jax_parallel
from nezha_tpu.parallel import quantized as jq
from nezha_tpu.parallel._compat import shard_map
from nezha_tpu_torch.parallel import quantized as tq
from torch_dist_worker import run_world

BLOCK = 128


def test_roundtrip_bitwise_jax_eager():
    x = np.random.RandomState(0).randn(7, 331).astype(np.float32) * 10
    for block in (128, 512):
        got = tq.quantize_roundtrip(torch.from_numpy(x), block).numpy()
        want = np.asarray(jq.quantize_roundtrip(jnp.asarray(x), block))
        np.testing.assert_array_equal(got, want)
        bound = np.abs(x).max() / 127.0
        assert np.abs(got - x).max() <= bound + 1e-6
    z = tq.quantize_roundtrip(torch.zeros(130))
    assert torch.equal(z, torch.zeros(130))


def test_cutoff_split_and_wire_bytes_match_jax():
    tree = {"big": np.ones((64, 64), np.float32),
            "small": np.ones(16, np.float32),
            "steps": np.ones(8192, np.int32)}
    tq_q, tq_e = tq.split_quantized_leaves(
        {k: torch.from_numpy(v) for k, v in tree.items()}, 4096)
    jq_q, jq_e = jq.split_quantized_leaves(
        {k: jnp.asarray(v) for k, v in tree.items()}, 4096)
    assert [t.shape for t in tq_q] == [tuple(a.shape) for a in jq_q]
    assert [t.shape for t in tq_e] == [tuple(a.shape) for a in jq_e]
    assert tq.DEFAULT_MIN_NUMEL == jq.DEFAULT_MIN_NUMEL
    for n in (1, 511, 512, 4096, 124_439_808):
        for block in (128, 512):
            assert tq.wire_payload_bytes(n, block) == \
                jq.wire_payload_bytes(n, block)
            for world in (1, 2, 8):
                assert tq.quantized_wire_bytes(n, block, world) == \
                    jq.quantized_wire_bytes(n, block, world)


def _jax_collectives(world, tree, flat):
    mesh = jax_parallel.make_mesh({"dp": world},
                                  devices=jax.devices()[:world])

    def body(t, f):
        t = jax.tree_util.tree_map(lambda a: a[0], t)
        out = jq.quantized_all_reduce_mean(t, "dp", block=BLOCK,
                                           min_numel=4096)
        rs = jq.quantized_reduce_scatter_mean(f[0], "dp", BLOCK)
        ag = jq.quantized_all_gather(rs, "dp", BLOCK)
        return (jax.tree_util.tree_map(lambda a: a[None], out), rs[None],
                ag[None])

    specs = {k: P("dp") for k in tree}
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P("dp")),
                           out_specs=(specs, P("dp"), P("dp"))))
    out, rs, ag = fn({k: jnp.asarray(v) for k, v in tree.items()},
                     jnp.asarray(flat))
    return ({k: np.asarray(v) for k, v in out.items()}, np.asarray(rs),
            np.asarray(ag))


def _held_to_jax(got, want, x_amax):
    """Each element within two int8 steps of JAX's jitted result."""
    step = x_amax / 127.0
    assert np.all(np.abs(got - want) <= 2 * step + 1e-7)


def _eager_rs(flats, block):
    """quantized_reduce_scatter_mean over ranks from JAX's eager pieces:
    -> each rank's owned chunk."""
    n = len(flats)
    q, s = zip(*(jq._quantize_blocks(jnp.pad(
        jnp.asarray(f).reshape(n, -1),
        ((0, 0), (0, (-(f.size // n)) % block))), block) for f in flats))
    chunk = flats[0].size // n
    out = []
    for j in range(n):
        parts = [np.asarray(jq._dequantize(q[r][j], s[r][j]))
                 for r in range(n)]
        owned = parts[0]
        for p in parts[1:]:
            owned = owned + p
        out.append((owned / np.float32(n)).reshape(-1)[:chunk])
    return out


def _eager_ag(chunks, block):
    n, c = len(chunks), chunks[0].size
    parts = []
    for ch in chunks:
        q, s = jq._quantize_blocks(jnp.pad(jnp.asarray(ch), (
            0, (-c) % block)).reshape(1, -1), block)
        parts.append(np.asarray(jq._dequantize(q, s)).reshape(-1)[:c])
    return np.concatenate(parts)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_jax_and_ranks_agree(world, tmp_path):
    r = np.random.RandomState(world)
    # Ragged sizes (not multiples of world * block) take the padding path.
    tree = {"big": r.randn(world, 64, 77).astype(np.float32) * 5,
            "small": r.randn(world, 16).astype(np.float32),
            "steps": np.tile(np.arange(world, dtype=np.int32)[:, None],
                             (1, 4))}
    flat = r.randn(world, world * 1000).astype(np.float32)
    ranks = run_world("quantized", world, {"tree": tree, "flat": flat,
                                           "block": BLOCK,
                                           "min_numel": 4096}, tmp_path)
    jtree, jrs, jag = _jax_collectives(world, tree, flat)
    mean = tree["big"].mean(axis=0)
    bound = (np.abs(tree["big"]).max() + np.abs(mean).max()) / 127.0
    for rank, res in enumerate(ranks):
        # Every rank decodes the same bytes.
        for k in tree:
            np.testing.assert_array_equal(res["tree"][k],
                                          ranks[0]["tree"][k])
        np.testing.assert_array_equal(res["ag"], ranks[0]["ag"])
        # The exact path: the small float leaf and the integer leaf.
        np.testing.assert_allclose(res["tree"]["small"],
                                   tree["small"].mean(axis=0), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(res["tree"]["steps"],
                                      jtree["steps"][rank])
        # Two quantized hops from the exact mean, and next to JAX's.
        assert np.abs(res["tree"]["big"] - mean).max() <= bound + 1e-6
        _held_to_jax(res["tree"]["big"], jtree["big"][rank],
                     np.abs(tree["big"]).max() * 2)
        _held_to_jax(res["rs"], jrs[rank], np.abs(flat).max())
        _held_to_jax(res["ag"], jag[rank], np.abs(flat).max())
    # Bitwise (world 2) against the algorithm in JAX's eager pieces.
    owned = _eager_rs(list(flat), BLOCK)
    gathered = _eager_ag(owned, BLOCK)
    check = (np.testing.assert_array_equal if world == 2 else
             lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6,
                                                     atol=1e-7))
    for rank, res in enumerate(ranks):
        check(res["rs"], owned[rank])
        check(res["ag"], gathered)
