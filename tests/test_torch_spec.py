"""Speculative decoding in the port against the JAX package (tiny preset,
f32 model, weights carried by ``params_from_jax``):

- the sampling pieces (``filtered_probs``, ``accept_mask``,
  ``residual_logits``, ``categorical_rows``) against JAX's on the same
  arrays: masks and tokens exact, probabilities within 1e-6; the
  rejection-sampling law by Monte Carlo;
- the verify-window write (float and int8 pools) against JAX's
  ``_apply_paged`` on the same q/k/v: pools and scales bitwise, the
  attention within 1e-5; the whole model's window within 1e-4;
- greedy tokens of the speculative engine equal to JAX's speculative
  engine and to the port's classic engine, on paged f32, paged int8 and
  dense pools, at horizons 1 and 2, for the identity draft, a 1-layer
  self-draft and an explicit draft model;
- what the engine and scheduler promise around it: EOS inside an
  accepted prefix, TTFT and TPOT credited per accepted token, the draft
  pool mirroring the slot lifecycle, the config's checks, a poisoned row
  retiring alone, sampled streams that do not change with the horizon
  and rejections that keep the carried logits finite."""

import dataclasses

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.nn.module import child_vars
from nezha_tpu.serve import Engine as JaxEngine
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu.serve.engine import SpeculativeConfig as JaxSpeculativeConfig
from nezha_tpu.serve.sampling import accept_mask as jax_accept_mask
from nezha_tpu.serve.sampling import categorical_rows as jax_categorical_rows
from nezha_tpu.serve.sampling import filtered_probs as jax_filtered_probs
from nezha_tpu.serve.sampling import residual_logits as jax_residual_logits
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.models.gpt2 import Attention
from nezha_tpu_torch.serve import (Engine, PagedSlotPool, Request,
                                   Scheduler, ServeConfig, SlotPool,
                                   SpeculativeConfig, accept_mask,
                                   categorical_rows, filtered_probs,
                                   residual_logits, self_draft)
from nezha_tpu_torch.serve.sampling import keyed_uniforms

SKW = dict(max_batch_size=3, max_len=48, max_prefill_len=8,
           prefill_buckets=(4, 8), k_max=16, queue_capacity=16,
           kv_block_size=4)
SCFG = ServeConfig(**SKW, cache_dtype=torch.float32)
SPEC = SpeculativeConfig(draft_k=2, draft_layers=1)
REQS = [dict(prompt=[5, 17, 3, 42], max_new_tokens=8, request_id="g0"),
        dict(prompt=[(3 * i + 2) % 512 for i in range(13)],
             max_new_tokens=6, request_id="g1"),
        dict(prompt=[11, 4, 9, 2, 8, 1], max_new_tokens=9,
             request_id="g2"),
        dict(prompt=[7, 7], max_new_tokens=7, temperature=0.9, top_k=10,
             seed=7, request_id="s0")]


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _lively(tree, rng):
    """Scaled-up weights: the small init repeats one token, which would
    let a poor draft agree with the target by accident."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _lively(val, rng)
        elif key == "scale":
            out[key] = jnp.asarray(1 + 0.2 * rng.randn(*val.shape),
                                   jnp.float32)
        elif key in ("bias", "b"):
            out[key] = jnp.asarray(0.1 * rng.randn(*val.shape), jnp.float32)
        else:
            out[key] = val * 8
    return out


def _pair(seed=0, **kw):
    cfg = dict(TINY_GPT2_KW, **kw)
    jm = JaxGPT2(JaxGPT2Config(**cfg))
    jv = jm.init(jax.random.PRNGKey(seed))
    jv = {"params": _lively(jv["params"], np.random.RandomState(seed)),
          "state": jv["state"]}
    tm = GPT2(GPT2Config(**cfg), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture
def pallas_load(monkeypatch):
    # jax 0.9.0 dropped pl.load, which the int8 prefill kernel's write
    # calls; a plain ref read does the same.
    monkeypatch.setattr(jax.experimental.pallas, "load",
                        lambda ref, idx: ref[idx], raising=False)


def _kernel_model():
    """JAX's model with the Pallas prefill and decode kernels (interpret
    mode): the port's int8 prefill attends the chunk's fresh K/V as that
    kernel does, where JAX's composed path attends the quantized write."""
    return JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW, prefill_impl="kernel",
                                 decode_impl="kernel"))


def _jax_cfg(cfg: ServeConfig, **kw):
    spec = cfg.speculative
    return JaxServeConfig(
        **SKW, cache_dtype=jnp.float32, kv_layout=cfg.kv_layout,
        kv_dtype=cfg.kv_dtype, decode_horizon=cfg.decode_horizon,
        speculative=None if spec is None else JaxSpeculativeConfig(
            draft_k=spec.draft_k, draft_layers=spec.draft_layers), **kw)


def _serve(sched, make, reqs):
    for r in reqs:
        sched.submit(make(**r))
    sched.run_until_idle(max_iters=400)
    assert not sched.has_work(), "scheduler did not drain"
    return {k: (v.tokens, v.finish_reason) for k, v in sched.results.items()}


def _port(model, cfg, reqs=REQS, draft=None):
    eng = Engine(model, cfg, draft_model=draft)
    out = _serve(Scheduler(eng), Request, reqs)
    eng.pool.leak_check()
    assert eng.pool.num_free == cfg.max_batch_size
    return eng, out


def _greedy(out):
    return {k: v for k, v in out.items() if k.startswith("g")}


# ------------------------------------------------------ sampling pieces
def _probs(rng, b, k, v, zero_frac=0.3):
    x = rng.rand(b, k, v).astype(np.float32)
    x[rng.rand(b, k, v) < zero_frac] = 0.0
    x[..., 0] += 0.01
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def test_accept_mask_and_residual_match_jax():
    rng = np.random.RandomState(0)
    b, k, v = 5, 3, 11
    p, q = _probs(rng, b, k, v), _probs(rng, b, k, v)
    q[4, 1, :] = np.nan                    # a poisoned draft distribution
    d = rng.randint(0, v, (b, k)).astype(np.int32)
    u = rng.rand(b, k).astype(np.float32)
    u[0, 0] = 0.0                          # the strict-inequality edge
    greedy = np.asarray([False, True, False, True, False])
    tmax = np.where(rng.rand(b, k) < 0.5, d, (d + 1) % v).astype(np.int32)
    want = np.asarray(jax_accept_mask(*map(jnp.asarray,
                                           (d, p, q, u, greedy, tmax))))
    got = accept_mask(*map(torch.from_numpy, (d, p, q, u, greedy, tmax)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    want_r = np.asarray(jax_residual_logits(jnp.asarray(p[:, 0]),
                                            jnp.asarray(q[:4, 0].repeat(
                                                2, 0)[:b])))
    got_r = residual_logits(torch.from_numpy(p[:, 0]),
                            torch.from_numpy(q[:4, 0].repeat(2, 0)[:b]))
    np.testing.assert_allclose(np.exp(got_r.numpy()), np.exp(want_r),
                               atol=1e-6, rtol=0)
    assert np.isfinite(got_r.numpy()).all()


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.7, 0, 1.0), (1.3, 5, 1.0), (0.9, 0, 0.6), (1.0, 8, 0.8)])
def test_filtered_probs_match_jax(temp, top_k, top_p):
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(4, 40)).astype(np.float32)
    t = np.full((4,), temp, np.float32)
    kk = np.full((4,), top_k, np.int32)
    pp = np.full((4,), top_p, np.float32)
    want = np.asarray(jax_filtered_probs(*map(jnp.asarray,
                                              (logits, t, kk, pp)), 16))
    got = filtered_probs(*map(torch.from_numpy, (logits, t, kk, pp)), 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if top_k:
        # Past a row's top k, both give exact zeros.
        outside = logits < np.sort(logits, axis=-1)[:, -top_k][:, None]
        assert (got.numpy()[outside] == 0).all() and (want[outside] == 0).all()


def test_categorical_rows_point_masses_match_jax():
    """Where the distribution leaves one token (a residual with one
    positive entry, a one-hot), both draw it, whatever the randomness;
    the port's draws are in range for any uniform in (0, 1)."""
    rng = np.random.RandomState(2)
    b, v = 6, 13
    hot = rng.randint(0, v, b)
    p = np.zeros((b, v), np.float32)
    p[np.arange(b), hot] = 1.0
    q = np.full((b, v), 1.0 / v, np.float32)
    q[np.arange(b), hot] = 0.0
    logits = np.asarray(jax_residual_logits(jnp.asarray(p), jnp.asarray(q)))
    want = np.asarray(jax_categorical_rows(
        jax.random.split(jax.random.PRNGKey(0), b), jnp.asarray(logits)))
    u = torch.tensor([1e-7, 0.25, 0.5, 0.75, 0.999999, 0.3])
    got = categorical_rows(u, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), hot)


def test_rejection_sampling_law_monte_carlo():
    """JAX ``test_spec.py``'s law on the port's pieces: d ~ q, accepted
    when u * q(d) < p(d), else drawn from ``residual_logits(p, q)``; the
    emitted marginal is p to Monte Carlo noise, and a token of zero
    target probability is never accepted, even at u = 0."""
    v, n = 8, 200_000
    g = torch.Generator().manual_seed(0)
    p = torch.softmax(torch.randn(v, generator=g) * 1.5, dim=0)
    q = torch.softmax(torch.randn(v, generator=g) * 1.5, dim=0)
    d = categorical_rows(torch.rand(n, generator=g),
                         torch.log(q).expand(n, v))
    acc = accept_mask(d[:, None], p.expand(n, 1, v), q.expand(n, 1, v),
                      torch.rand(n, 1, generator=g),
                      torch.zeros(n, dtype=torch.bool),
                      torch.zeros(n, 1, dtype=torch.int32))[:, 0]
    res = categorical_rows(torch.rand(n, generator=g),
                           residual_logits(p[None], q[None]).expand(n, v))
    emitted = torch.where(acc, d, res)
    emp = torch.bincount(emitted.long(), minlength=v).float() / n
    assert 0.5 * (emp - p).abs().sum().item() < 0.01
    assert 0.5 * (q - p).abs().sum().item() > 0.05
    p0, q0 = torch.tensor([[[0.0, 1.0]]]), torch.tensor([[[1.0, 0.0]]])
    acc0 = accept_mask(torch.tensor([[0]]), p0, q0, torch.tensor([[0.0]]),
                       torch.zeros(1, dtype=torch.bool),
                       torch.zeros(1, 1, dtype=torch.int32))
    assert not bool(acc0[0, 0])


def test_keyed_uniforms_are_a_function_of_their_keys():
    seeds = torch.tensor([0, 1, -3, 2 ** 40, 0])
    counts = torch.tensor([0, 0, 5, 9, 1])
    u = keyed_uniforms(seeds, counts, 3, 4)
    assert u.shape == (5, 4) and bool(((u > 0) & (u < 1)).all())
    np.testing.assert_array_equal(
        u[2:3].numpy(), keyed_uniforms(seeds[2:3], counts[2:3], 3, 4).numpy())
    assert not torch.equal(u[0], u[4])                 # count moves it
    assert not torch.equal(u, keyed_uniforms(seeds, counts, 4, 4))
    big = keyed_uniforms(torch.arange(50_000), torch.zeros(50_000,
                                                          dtype=torch.int64),
                         1, 2)
    assert abs(big.mean().item() - 0.5) < 0.01
    assert abs(big.std().item() - 12 ** -0.5) < 0.01


# ------------------------------------------------- the verify window
def _window_case(rng, quant: bool):
    """Pools of 12 blocks of 4, tables of 5 blocks (capacity 20), and a
    4-row window of s = 4: row 0 runs past capacity, row 1 past its bound
    frontier (an unbound entry is scratch), row 2 is not emitting, and
    row 3 crosses from one bound block into the next. -> the case and the
    blocks the window may change."""
    cfg = JaxGPT2Config(**TINY_GPT2_KW)
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    n_blocks, bs = 12, 4
    if quant:
        k = rng.randint(-127, 128, (n_blocks, h, bs, d)).astype(np.int8)
        v = rng.randint(-127, 128, (n_blocks, h, bs, d)).astype(np.int8)
        pools = {"k": k, "v": v,
                 "k_scale": rng.rand(n_blocks, h).astype(np.float32) / 50,
                 "v_scale": rng.rand(n_blocks, h).astype(np.float32) / 50}
    else:
        pools = {"k": rng.randn(n_blocks, h, bs, d).astype(np.float32),
                 "v": rng.randn(n_blocks, h, bs, d).astype(np.float32)}
    tab = np.asarray([[3, 9, 2, 5, 11], [2, 5, 8, 4, 0], [6, 10, 0, 0, 0],
                      [7, 1, 0, 0, 0]], np.int32)
    pos = np.asarray([18, 14, 3, 2], np.int32)
    active = np.asarray([True, True, False, True])
    s = 4
    qkv = [rng.randn(4, h, s, d).astype(np.float32) for _ in range(3)]
    return pools, tab, pos, active, qkv, {11, 4, 7, 1}


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_verify_window_write_bitwise_jax(models, quant):
    jm, jv, tm = models
    pools, tab, pos, active, (q, k, v), written = _window_case(
        np.random.RandomState(3), quant)
    jattn = jm.h[0].attn
    jvars = child_vars(child_vars(jv, "h0"), "attn")
    jcache = {**{n: jnp.asarray(x) for n, x in pools.items()},
              "tables": jnp.asarray(tab)}
    b, h, s, d = q.shape
    jout, states = jattn._apply_paged(
        jvars, jnp.zeros((b, s, h * d)), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), jcache, jnp.asarray(pos), False,
        jnp.asarray(active), {}, training=False)
    tcache = {**{n: torch.from_numpy(x.copy()) for n, x in pools.items()},
              "tables": torch.from_numpy(tab)}
    with torch.no_grad():
        out = Attention._verify_paged(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tcache, torch.from_numpy(pos), torch.from_numpy(active))
        got = tm.h[0].attn.proj(out.transpose(1, 2).reshape(b, s, h * d))
    for name in pools:
        want = np.asarray(states["cache"][name])
        # Block 0 is scratch: its content is unspecified.
        np.testing.assert_array_equal(tcache[name].numpy()[1:], want[1:])
        changed = (want != pools[name]).reshape(len(want), -1).any(-1)
        assert set(np.flatnonzero(changed[1:]) + 1) == written
    np.testing.assert_allclose(got[active].numpy(),
                               np.asarray(jout)[active], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_verify_window_through_the_model_matches_jax(models, kv_dtype,
                                                     pallas_load):
    """The whole model over a window of s = 3 at per-row positions after
    a prefill chunk, on paged pools: logits within 1e-4 of JAX's
    ``GPT2.apply`` (f32), or 2e-3 on int8 pools, whose JAX prefill runs
    under jit (one ulp of scale can move a value by one int8 step)."""
    jm, jv, tm = models
    if kv_dtype == "int8":
        jm = _kernel_model()
    cfg = tm.cfg
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    n_blocks, bs = 10, 4
    quant = kv_dtype == "int8"
    shape, sshape = (n_blocks, h, bs, d), (n_blocks, h)
    tab = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)

    def pools():
        if quant:
            return {"k": np.zeros(shape, np.int8),
                    "v": np.zeros(shape, np.int8),
                    "k_scale": np.zeros(sshape, np.float32),
                    "v_scale": np.zeros(sshape, np.float32)}
        return {"k": np.zeros(shape, np.float32),
                "v": np.zeros(shape, np.float32)}

    jcache = [{n: jnp.asarray(x) for n, x in pools().items()}
              for _ in range(cfg.num_layers)]
    tcache = [{n: torch.from_numpy(x) for n, x in pools().items()}
              for _ in range(cfg.num_layers)]
    rng = np.random.RandomState(4)

    def run(tokens, pos, active=None, tol=1e-4):
        nonlocal jcache
        jrows = [{**c, "tables": jnp.asarray(tab)} for c in jcache]
        want, states = jm.apply(
            jv, jnp.asarray(tokens), cache=jrows,
            pos=jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos,
            active=None if active is None else jnp.asarray(active))
        jcache = [{n: states[f"h{i}"]["attn"]["cache"][n] for n in c}
                  for i, c in enumerate(jcache)]
        trows = [{**c, "tables": torch.from_numpy(tab)} for c in tcache]
        with torch.no_grad():
            got = tm(torch.from_numpy(tokens), cache=trows,
                     pos=torch.from_numpy(pos)
                     if isinstance(pos, np.ndarray) else pos,
                     active=None if active is None
                     else torch.from_numpy(active))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=0)

    tol = 2e-3 if quant else 1e-4
    run(rng.randint(0, 512, (2, 8)), 0, tol=tol)
    run(rng.randint(0, 512, (2, 3)), np.asarray([8, 6], np.int32),
        np.asarray([True, True]), tol)
    run(rng.randint(0, 512, (2, 3)), np.asarray([10, 9], np.int32),
        np.asarray([True, False]), tol)


# ------------------------------------------------------- greedy parity
@pytest.mark.parametrize("layout,kv_dtype,horizon,draft_layers", [
    ("paged", "bf16", 1, None), ("paged", "bf16", 2, 1),
    ("paged", "int8", 1, 1), ("paged", "int8", 2, None),
    ("dense", "bf16", 1, 1), ("dense", "bf16", 2, None)])
def test_greedy_tokens_equal_classic(models, layout, kv_dtype, horizon,
                                     draft_layers):
    """Greedy rows of the speculative engine are the classic engine's
    tokens (and finish reasons), chunked prompts included, on every
    layout and horizon, with the identity draft and a 1-layer one."""
    _, _, tm = models
    base = dataclasses.replace(SCFG, kv_layout=layout, kv_dtype=kv_dtype,
                               decode_horizon=horizon)
    _, classic = _port(tm, base)
    eng, spec = _port(tm, dataclasses.replace(
        base, speculative=SpeculativeConfig(draft_k=2,
                                            draft_layers=draft_layers)))
    assert _greedy(spec) == _greedy(classic)
    assert eng.spec_verifies > 0 and eng.spec_accepted > 0
    if draft_layers is not None:           # a shallow draft gets rejected
        assert eng.spec_accepted < eng.spec_draft_tokens
    eng.draft_pool.leak_check()


@pytest.mark.parametrize("layout,kv_dtype,horizon", [
    ("paged", "bf16", 2), ("paged", "int8", 1), ("dense", "bf16", 1)])
def test_greedy_tokens_equal_jax_speculative_engine(models, layout,
                                                    kv_dtype, horizon,
                                                    pallas_load):
    """The port's speculative engine against JAX's on the same weights
    and requests: greedy rows identical (the sampled row draws from other
    random numbers in the two packages). JAX's int8 engine runs its
    prefill and decode kernels, as the port's int8 paths mirror them."""
    jm, jv, tm = models
    cfg = dataclasses.replace(SCFG, kv_layout=layout, kv_dtype=kv_dtype,
                              decode_horizon=horizon, speculative=SPEC)
    kw = (dict(prefill_impl="kernel", decode_impl="kernel")
          if kv_dtype == "int8" else {})
    jeng = JaxEngine(jm, jv, _jax_cfg(cfg, **kw))
    want = _serve(JaxScheduler(jeng), JaxRequest, REQS)
    eng, got = _port(tm, cfg)
    assert _greedy(got) == _greedy(want)
    assert eng.spec_accepted > 0 and jeng.spec_accepted > 0


def test_explicit_draft_model_matches_jax(models):
    """A draft of its own (2 layers, other weights) instead of a
    self-draft: greedy tokens equal JAX's engine with the same draft and
    the port's classic engine."""
    jm, jv, tm = models
    djm, djv, dtm = _pair(seed=1, num_layers=2)
    cfg = dataclasses.replace(SCFG, speculative=SpeculativeConfig(
        draft_k=3))
    reqs = [r for r in REQS if r["request_id"].startswith("g")]
    jeng = JaxEngine(jm, jv, _jax_cfg(cfg), draft_model=djm,
                     draft_variables=djv)
    want = _serve(JaxScheduler(jeng), JaxRequest, reqs)
    eng, got = _port(tm, cfg, reqs, draft=dtm)
    assert got == want
    assert got == _port(tm, SCFG, reqs)[1]
    assert eng.draft_model is dtm and eng.spec_verifies > 0
    assert eng.spec_accepted < eng.spec_draft_tokens


# ------------------------------------------- completion and accounting
def test_eos_inside_accepted_prefix_freezes_row(models):
    """JAX ``test_spec.py``'s EOS case: with the identity draft (accept
    rate ~1) an EOS inside the first window cuts emission at the EOS; the
    position stops there and the rest of the block is pad."""
    _, _, tm = models
    cfg = dataclasses.replace(SCFG, speculative=SpeculativeConfig(
        draft_k=5))
    kw = dict(prompt=[5, 17, 3, 42], max_new_tokens=6, temperature=0.9,
              top_k=10, seed=7)
    _, probe = _port(tm, cfg, [dict(kw, request_id="p")])
    seq = probe["p"][0]
    stop = next(i for i in range(1, len(seq)) if seq[i] not in seq[:i])
    eos, ref = seq[stop], seq[:stop + 1]
    assert 1 <= stop < 5
    eng = Engine(tm, cfg)
    eng.prefill(0, kw["prompt"], seed=7, temperature=0.9, top_k=10,
                eos_id=eos, max_new_tokens=6)
    active = np.zeros((cfg.max_batch_size,), bool)
    active[0] = True
    tok, emitted = eng.step(active)
    assert tok.shape == (cfg.max_batch_size, 6)
    assert emitted[0] == stop + 1
    assert tok[0, :stop + 1].tolist() == ref
    assert (tok[0, stop + 1:] == cfg.pad_id).all()
    assert (emitted[1:] == 0).all()
    assert int(eng.positions[0]) == len(kw["prompt"]) + stop + 1
    _, out = _port(tm, cfg, [dict(kw, eos_id=eos, request_id="e")])
    assert out["e"] == (ref, "eos")


def test_ttft_and_tpot_credited_per_accepted_token(models):
    """One dispatch emitting all 8 tokens (identity draft, k = 7): one
    TPOT sample per emitted token, the first token credited inside the
    dispatch, and a ceiling of horizon * (k + 1) tokens a dispatch."""
    _, _, tm = models
    eng = Engine(tm, dataclasses.replace(
        SCFG, max_batch_size=1, speculative=SpeculativeConfig(draft_k=7)))
    sched = Scheduler(eng)
    rid = sched.submit(Request(prompt=[5, 17, 3], max_new_tokens=8))
    sched.run_until_idle(max_iters=20)
    assert eng.step_calls == 1
    assert len(sched.tpot_s) == 8
    assert len(set(sched.tpot_s)) == 1            # the dispatch over 8
    res = sched.results[rid]
    assert len(res.tokens) == 8 and res.ttft_s < res.latency_s
    assert eng.tokens_per_dispatch == 8
    assert (eng.spec_verifies, eng.spec_accepted) == (1, 7)


@pytest.mark.parametrize("dense", [False, True], ids=["paged", "dense"])
def test_draft_pool_mirrors_slot_lifecycle(models, dense):
    _, _, tm = models
    draft = self_draft(tm, 1)
    if dense:
        pool = SlotPool(tm.cfg, 3, 48, torch.float32, device="cpu")
        mirror = SlotPool(draft.cfg, 3, 48, torch.float32, device="cpu")
        free = lambda p: p._free                                # noqa: E731
    else:
        pool = PagedSlotPool(tm.cfg, 3, 48, torch.float32, block_size=4,
                             device="cpu")
        mirror = PagedSlotPool(draft.cfg, 3, 48, torch.float32,
                               block_size=4, prefix_cache=False,
                               eviction="none", device="cpu")
        free = lambda p: p._free_slots                          # noqa: E731
    pool.mirror = mirror
    s = pool.alloc()
    assert s is not None and s not in free(mirror)
    if not dense:
        mirror.prepare_write(s, 0, 9)                 # the draft's blocks
        assert mirror.blocks_used == 3
    pool.free(s)
    assert sorted(free(mirror)) == sorted(free(pool))
    assert dense or mirror.blocks_used == 0
    pool.leak_check()
    s = pool.alloc()
    with pytest.raises(ValueError):
        mirror.claim(s)
    mirror.free(s)
    with pytest.raises(AssertionError, match="draft pool slot drift"):
        pool.leak_check()
    mirror.claim(s)
    pool.free(s)
    pool.leak_check()


def test_speculative_config_validation(models):
    _, _, tm = models
    with pytest.raises(ValueError, match="draft_k"):
        ServeConfig(speculative=SpeculativeConfig(draft_k=0))
    with pytest.raises(ValueError, match="draft_layers"):
        ServeConfig(speculative=SpeculativeConfig(draft_layers=0))
    cfg = ServeConfig(speculative={"draft_k": 2})
    assert isinstance(cfg.speculative, SpeculativeConfig)
    with pytest.raises(ValueError, match="draft_layers"):
        self_draft(tm, tm.cfg.num_layers + 1)
    with pytest.raises(ValueError, match="speculative"):
        Engine(tm, SCFG, draft_model=tm)
    other = GPT2(GPT2Config(**{**TINY_GPT2_KW, "vocab_size": 96}),
                 device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        Engine(tm, dataclasses.replace(SCFG, speculative=SPEC),
               draft_model=other)
    short = GPT2(GPT2Config(**{**TINY_GPT2_KW, "max_positions": 32}),
                 device="cpu")
    with pytest.raises(ValueError, match="max_positions"):
        Engine(tm, dataclasses.replace(SCFG, speculative=SPEC),
               draft_model=short)
    # The early-exit self-draft: the first N blocks, the target's tensors.
    draft = self_draft(tm, 1)
    assert draft.cfg.num_layers == 1 and len(draft.h) == 1
    assert len(tm.h) == tm.cfg.num_layers == 4
    assert draft.wte.embedding is tm.wte.embedding
    assert draft.h[0].attn.qkv.w is tm.h[0].attn.qkv.w


def test_non_finite_verify_row_retires_only_its_request(models):
    """A row whose carried logits go NaN (poisoned here directly) is
    frozen by the next window's tripwire and retired with ERROR alone;
    its neighbours finish, and neither pool leaks."""
    _, _, tm = models
    eng = Engine(tm, dataclasses.replace(SCFG, speculative=SPEC))
    sched = Scheduler(eng)
    rids = [sched.submit(Request(prompt=[9 + i, 2, 5], max_new_tokens=8,
                                 request_id=f"v{i}")) for i in range(3)]
    sched.step()
    with sched._lock:
        victim_slot = next(s for s, live in sched._live.items()
                           if live.request_id == "v1")
    eng.last_logits[victim_slot, 3] = float("nan")
    sched.run_until_idle(max_iters=100)
    reasons = {r: sched.results[r].finish_reason for r in rids}
    assert reasons == {"v0": "length", "v1": "error", "v2": "length"}
    assert sched.results["v1"].error == "non-finite logits"
    assert eng.pool.num_free == SCFG.max_batch_size
    eng.pool.leak_check()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_sampled_streams_do_not_change_with_the_horizon(models, layout):
    _, _, tm = models
    outs = []
    for h in (1, 3):
        cfg = dataclasses.replace(SCFG, kv_layout=layout, decode_horizon=h,
                                  speculative=SPEC)
        outs.append(_port(tm, cfg)[1])
    assert outs[0] == outs[1]
    assert len(outs[0]["s0"][0]) == 7


def test_sampled_rejections_keep_carried_logits_finite(models):
    """A shallow draft on a bf16 pool rejects; the residual it carries
    stays finite (its floor is a normal fp32 number), so the sampled row
    finishes by length, never as non-finite."""
    _, _, tm = models
    eng = Engine(tm, dataclasses.replace(SCFG, cache_dtype=torch.bfloat16,
                                         speculative=SPEC))
    sched = Scheduler(eng)
    rid = sched.submit(Request(prompt=[7, 7, 9], max_new_tokens=10,
                               temperature=0.8, top_k=40, seed=7))
    sched.run_until_idle(max_iters=50)
    res = sched.results[rid]
    assert res.finish_reason == "length", res.error
    assert len(res.tokens) == 10
    assert eng.spec_accepted < eng.spec_verifies * SPEC.draft_k
    assert bool(torch.isfinite(eng.last_logits).all())
