"""GPT-2 in the port against the JAX model on the same weights (tiny
preset, f32): the ``params_from_jax`` round trip, the no-cache forward,
and a prefill chunk plus decode steps through the paged cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu_torch.models import (GPT2, GPT2Config, params_from_jax,
                                    params_to_jax)

BS, M, N_BLOCKS = 8, 6, 16


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables, torch model with the same weights)."""
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**TINY_GPT2_KW))
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


def test_params_round_trip(pair):
    jm, jv, tm = pair
    flat = _flatten(jv["params"])
    back = params_to_jax(tm.state_dict())
    assert set(back) == set(flat)
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


def test_no_cache_forward_matches(pair):
    jm, jv, tm = pair
    tokens = np.random.RandomState(0).randint(0, 512, (2, 24))
    want, _ = jm.apply(jv, jnp.asarray(tokens))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_paged_prefill_and_decode_match(pair):
    """Two rows with shuffled block tables: a 13-token prefill chunk of
    row 0 (pads past the prompt, as the engine's buckets do), a second
    chunk at start 13 (the kernel's prefix path), then decode steps for
    both rows with row 1 inactive on one step. Logits agree with JAX's
    paged cache path within 1e-4 at every step (f32), and so do the
    pools' written blocks."""
    jm, jv, tm = pair
    rng = np.random.RandomState(1)
    cfg = JaxGPT2Config(**TINY_GPT2_KW)
    d = cfg.hidden_size // cfg.num_heads
    tab = np.zeros((2, M), np.int32)
    tab[0] = rng.permutation(np.arange(1, N_BLOCKS))[:M]
    tab[1, :2] = [b for b in range(1, N_BLOCKS) if b not in tab[0]][:2]
    shape = (N_BLOCKS, cfg.num_heads, BS, d)
    jcache = [{"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
              for _ in range(cfg.num_layers)]
    tcache = [{"k": torch.zeros(shape), "v": torch.zeros(shape)}
              for _ in range(cfg.num_layers)]

    def run(tokens, row_tab, pos, active=None):
        nonlocal jcache
        jrows = [{**c, "tables": jnp.asarray(row_tab)} for c in jcache]
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
        want, states = jm.apply(
            jv, jnp.asarray(tokens), cache=jrows, pos=jpos,
            active=None if active is None else jnp.asarray(active))
        jcache = [{"k": states[f"h{i}"]["attn"]["cache"]["k"],
                   "v": states[f"h{i}"]["attn"]["cache"]["v"]}
                  for i in range(cfg.num_layers)]
        trows = [{**c, "tables": torch.from_numpy(row_tab)} for c in tcache]
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        with torch.no_grad():
            got = tm(torch.from_numpy(tokens), cache=trows, pos=tpos,
                     active=None if active is None
                     else torch.from_numpy(active))
        # Inactive rows are discarded by the engine: JAX's composed path
        # still attends their prefix, the kernel path attends nothing.
        rows = slice(None) if active is None else active
        np.testing.assert_allclose(got.numpy()[rows],
                                   np.asarray(want)[rows], atol=1e-4,
                                   rtol=0)
        return got

    prompt = rng.randint(0, 512, 21)
    chunk = np.zeros((1, 16), np.int64)
    chunk[0, :13] = prompt[:13]
    run(chunk, tab[:1], 0)
    run(prompt[None, 13:21], tab[:1], 13)
    run(prompt[None, :8], tab[1:], 0)
    pos = np.asarray([21, 8], np.int32)
    for step in range(3):
        active = np.asarray([True, step != 1])
        toks = rng.randint(0, 512, (2, 1))
        run(toks, tab, pos, active)
        pos = pos + active.astype(np.int32)
    for jc, tc in zip(jcache, tcache):
        np.testing.assert_allclose(tc["k"][1:].numpy(),
                                   np.asarray(jc["k"])[1:], atol=1e-5)
