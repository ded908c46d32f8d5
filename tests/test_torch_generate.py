"""KV-cache generation in the port against the JAX package on the CPU: the
dense flash-decode kernel's plain version against the Pallas kernel in
interpret mode, GPT-2's dense-cache forward against ``GPT2.apply(...,
cache=...)``, greedy ``generate`` tokens against
``nezha_tpu.models.generate.generate`` (tiny preset, f32 model over the
default bf16 cache), the EOS/pad and ``max_positions`` rules, the sampling
law, and the CLI against ``nezha-generate``.

Weights: the JAX init of the tiny preset with every matrix scaled by 8
and random LayerNorm scales and biases, so greedy continuations vary
from step to step (the small init repeats one token) and a wrong
attention or norm changes them."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.cli.generate import build_parser as jax_build_parser
from nezha_tpu.cli.generate import run as jax_run
from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.generate import generate as jax_generate
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.ops.pallas.decode_attention import \
    flash_decode_attention as jax_flash_decode
from nezha_tpu_torch.cli import generate as cli_generate
from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.models import (GPT2, GPT2Config, generate, init_cache,
                                    params_from_jax)
from nezha_tpu_torch.models.generate import _sample
from nezha_tpu_torch.ops.cuda import flash_decode_attention

H, D, L = 2, 16, 600
# Every length class the dense kernel treats differently (the plain
# version folds the TPU kernel's blocks: 600 -> 200-key blocks):
# inactive, one position, a block's end and either side of it, a length
# inside the last block, the whole cache, and one clamped above L.
LENGTHS = (0, 1, 199, 200, 201, 517, L, L + 50)
ROOT = Path(__file__).resolve().parents[1]


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _lively(tree, rng):
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


def _pair(**kw):
    """(JAX model, its variables, the port's model on the same weights)."""
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW, **kw))
    jv = jm.init(jax.random.PRNGKey(0))
    jv = {"params": _lively(jv["params"], np.random.RandomState(0)),
          "state": jv["state"]}
    tm = GPT2(GPT2Config(**TINY_GPT2_KW, **kw), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


# ------------------------------------------------------ the decode kernel
@pytest.mark.parametrize("q_dtype,cache_dtype", [
    ("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16")])
def test_dense_decode_matches_pallas_kernel(q_dtype, cache_dtype):
    """Both fold the same 200-key blocks in order and round q and p to
    the cache dtype at the same places, so they agree to fp32 rounding of
    the sums (atol 1e-5) plus, for a bf16 output, one bf16 rounding of
    each side (2^-7 of |out|); the zero-length row is exact zero."""
    rng = np.random.RandomState(0)
    b = len(LENGTHS)
    q = rng.randn(b, H, 1, D).astype(np.float32)
    k, v = (rng.randn(b, H, L, D).astype(np.float32) for _ in range(2))
    lengths = np.asarray(LENGTHS, np.int32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    want = jax_flash_decode(
        jnp.asarray(q, jdt[q_dtype]), jnp.asarray(k, jdt[cache_dtype]),
        jnp.asarray(v, jdt[cache_dtype]), jnp.asarray(lengths),
        interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = flash_decode_attention(
        torch.from_numpy(q).to(tdt[q_dtype]),
        torch.from_numpy(k).to(tdt[cache_dtype]),
        torch.from_numpy(v).to(tdt[cache_dtype]), torch.from_numpy(lengths))
    assert got.dtype == tdt[q_dtype]
    got = got.float().numpy()
    tol = 1e-5 + (2 ** -7 * np.abs(want) if q_dtype == "bf16" else 0)
    assert np.all(np.abs(got - want) <= tol)
    assert np.all(got[0] == 0.0)


def test_dense_decode_rejects_bad_shapes():
    q = torch.zeros(2, H, 1, D)
    k = torch.zeros(2, H, 8, D)
    with pytest.raises(ValueError, match="lengths"):
        flash_decode_attention(q, k, k, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        flash_decode_attention(q, k[:1], k[:1],
                               torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="q must be"):
        flash_decode_attention(q.expand(-1, -1, 2, -1), k, k,
                               torch.zeros(2, dtype=torch.int32))


# ------------------------------------------------- the dense-cache forward
@pytest.mark.parametrize("attn_impl,decode_impl", [("flash", "kernel"),
                                                   ("xla", "xla")])
def test_dense_cache_forward_matches_jax(attn_impl, decode_impl):
    """A pos-0 prefill, a uniform-pos decode step, a per-row step with
    one row inactive, and a per-row step whose position is clamped to the
    last cache slot: logits within 1e-4 of JAX's (f32 model and cache)
    at every step, and so are the caches the writes leave."""
    jm, jv, tm = _pair(attn_impl=attn_impl, decode_impl=decode_impl)
    cap, b = 12, 2
    cfg = tm.cfg
    shape = (b, cfg.num_heads, cap, cfg.hidden_size // cfg.num_heads)
    jcache = [{"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
              for _ in range(cfg.num_layers)]
    tcache = init_cache(tm, b, cap, torch.float32)
    rng = np.random.RandomState(1)

    def step(tokens, pos, prefill=False, active=None):
        nonlocal jcache
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
        want, states = jm.apply(
            jv, jnp.asarray(tokens), cache=jcache, pos=jpos,
            prefill=prefill,
            active=None if active is None else jnp.asarray(active))
        jcache = [states[f"h{i}"]["attn"]["cache"]
                  for i in range(cfg.num_layers)]
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        with torch.no_grad():
            got = tm(torch.from_numpy(tokens), cache=tcache, pos=tpos,
                     prefill=prefill,
                     active=None if active is None
                     else torch.from_numpy(active))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
        for jc, tc in zip(jcache, tcache):
            np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                       atol=1e-5, rtol=0)

    step(rng.randint(0, 512, (b, 8)), 0, prefill=True)
    step(rng.randint(0, 512, (b, 1)), 8)
    step(rng.randint(0, 512, (b, 1)), np.asarray([9, 5], np.int32),
         active=np.asarray([True, False]))
    step(rng.randint(0, 512, (b, 1)), np.asarray([cap + 2, 6], np.int32))


def test_dense_cache_refuses_speculative_windows():
    tm = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    cache = init_cache(tm, 2, 16, torch.float32)
    with pytest.raises(NotPortedError, match="speculative"):
        with torch.no_grad():
            tm(torch.zeros(2, 3, dtype=torch.long), cache=cache,
               pos=torch.tensor([4, 5]))


# --------------------------------------------------------------- generate
@pytest.mark.parametrize("kw", [dict(decode_impl="kernel", ln_impl="pallas"),
                                dict(decode_impl="xla", ln_impl="xla")],
                         ids=["kernels", "composed"])
def test_greedy_tokens_identical_to_jax(kw, monkeypatch):
    """Greedy tokens equal to JAX's generate, bit for bit, over the
    default bf16 cache: with the decode and LayerNorm kernels (JAX's in
    interpret mode; the pos-0 prefill through flash attention on both
    sides) and with the composed paths."""
    monkeypatch.setenv("NEZHA_LN_INTERPRET", "1")
    attn = "flash" if kw["decode_impl"] == "kernel" else "xla"
    jm, jv, tm = _pair(attn_impl=attn, **kw)
    prompt = np.random.RandomState(2).randint(0, 512, (2, 8))
    want = np.asarray(jax_generate(jm, jv, jnp.asarray(prompt), 6))
    got = generate(tm, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[:, 8:].ravel().tolist())) > 4   # not one token


def test_eos_rows_pad_and_others_unchanged():
    """As tests/test_generate.py pins for JAX: a row that emits eos_id
    keeps decoding but every later token is the pad (eos itself by
    default, or pad_id); the other row is identical to the no-eos run."""
    _, _, tm = _pair()
    prompt = torch.tensor([[5, 17, 3, 42], [7, 7, 23, 1]])

    def run(**extra):
        gen = torch.Generator().manual_seed(5)
        return generate(tm, prompt, 10, temperature=0.8, top_k=20,
                        generator=gen, cache_dtype=torch.float32,
                        **extra)[:, 4:]

    base = run()
    row = base[0].tolist()
    stop = next(i for i in range(1, len(row)) if row[i] not in row[:i])
    eos = row[stop]
    out = run(eos_id=eos)
    assert out[0, :stop + 1].tolist() == row[:stop + 1]
    assert all(t == eos for t in out[0, stop:].tolist())
    assert torch.equal(out[1], base[1])
    out2 = run(eos_id=eos, pad_id=0)
    assert out2[0, stop] == eos
    assert all(t == 0 for t in out2[0, stop + 1:].tolist())


def test_max_positions_refused():
    tm = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    with pytest.raises(ValueError, match="max_positions"):
        generate(tm, torch.zeros(1, 90, dtype=torch.long), 7)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate(tm, torch.zeros(1, 4, dtype=torch.long), 0)
    assert generate(tm, torch.zeros(1, 90, dtype=torch.long),
                    6).shape == (1, 96)


# --------------------------------------------------------------- sampling
def test_top_k_one_and_top_p_zero_are_greedy():
    _, _, tm = _pair()
    prompt = torch.tensor([[5, 17, 3, 42, 9]])
    greedy = generate(tm, prompt, 8)
    for kw in (dict(top_k=1), dict(top_p=0.0), dict(top_k=0)):
        gen = torch.Generator().manual_seed(3)
        assert torch.equal(generate(tm, prompt, 8, temperature=0.9,
                                    generator=gen, **kw), greedy), kw


def _filtered_law(logits, temperature, top_k, top_p):
    """The filtered softmax JAX's _sample draws from, in float64: top-k
    (ties at the k-th value kept), then the smallest descending prefix of
    mass >= top_p (the top token always)."""
    z = logits.astype(np.float64) / temperature
    if top_k is not None:
        z = np.where(z < np.sort(z)[::-1][top_k - 1], -np.inf, z)
    p = np.exp(z - z.max())
    p /= p.sum()
    if top_p is not None:
        order = np.argsort(-p, kind="stable")
        excl = np.cumsum(p[order]) - p[order]
        keep = np.zeros_like(p, bool)
        keep[order[(excl < top_p) | (np.arange(len(p)) == 0)]] = True
        p = np.where(keep, p, 0.0)
        p /= p.sum()
    return p


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 8, None), (1.3, None, 0.8), (0.9, 10, 0.9)])
def test_sampling_law(temperature, top_k, top_p):
    """200k draws of _sample over one row of 16 logits: every token lies
    in the filtered support, and the empirical law is within total
    variation 0.01 of the filtered softmax (Monte Carlo noise is ~0.003
    at this n, as tests/test_spec.py pins its rejection law). JAX's
    _sample keeps the same support."""
    from nezha_tpu.models.generate import _sample as jax_sample

    n, v = 200_000, 16
    logits = (np.random.RandomState(4).randn(v) * 2).astype(np.float32)
    law = _filtered_law(logits, temperature, top_k, top_p)
    gen = torch.Generator().manual_seed(0)
    toks = _sample(torch.from_numpy(logits).expand(n, v), gen, temperature,
                   top_k, top_p).numpy()
    support = set(np.flatnonzero(law).tolist())
    assert set(toks.tolist()) <= support
    emp = np.bincount(toks, minlength=v) / n
    assert 0.5 * np.abs(emp - law).sum() < 0.01
    jtoks = np.asarray(jax_sample(jnp.broadcast_to(jnp.asarray(logits),
                                                   (20_000, v)),
                                  jax.random.PRNGKey(0), temperature,
                                  top_k, top_p))
    assert set(jtoks.tolist()) <= support
    if top_k is not None or top_p is not None:
        assert len(support) < v      # the filter removed something


# -------------------------------------------------------------------- CLI
def _lively_cli_pair(seed):
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW))
    jv = jm.init(jax.random.PRNGKey(seed))
    jv = {"params": _lively(jv["params"], np.random.RandomState(seed)),
          "state": jv["state"]}
    tm = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


def test_cli_greedy_matches_jax_cli(monkeypatch, capsys):
    """Both CLIs in greedy mode on the same weights (each CLI's seeded
    random init replaced by the same JAX weights): identical JSON."""
    jm, jv, tm = _lively_cli_pair(0)
    monkeypatch.setattr("nezha_tpu.cli.common.load_gpt2_for_inference",
                        lambda args: (jm, jv))
    monkeypatch.setattr(cli_generate, "gpt2_for_preset",
                        lambda *a, **k: tm)
    argv = ["--random-init", "--model-preset", "tiny", "--prompt-tokens",
            "5,17,3,42,9", "--max-new-tokens", "8", "--temperature", "0",
            "--eos-id", "-1"]
    want = jax_run(jax_build_parser().parse_args(argv + ["--platform",
                                                         "cpu"]))
    got = cli_generate.run(cli_generate.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert got == want
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == got


@pytest.mark.parametrize("flag", [["--ckpt-dir", "runs/x"],
                                  ["--hf-dir", "hf/x"],
                                  ["--random-init", "--tokenizer", "tok"]])
def test_cli_refuses_unported_sources(flag):
    args = cli_generate.build_parser().parse_args(
        flag + ["--prompt-tokens", "1,2", "--device", "cpu"])
    with pytest.raises(NotPortedError, match=flag[-2]):
        cli_generate.run(args)


def test_cli_end_to_end_on_cpu():
    """The module as a program: a sampled byte-level text prompt with
    two samples, and the refusal's exit."""
    cmd = [sys.executable, "-m", "nezha_tpu_torch.cli.generate",
           "--random-init", "--model-preset", "tiny", "--device", "cpu"]
    proc = subprocess.run(
        cmd + ["--prompt", "hi there", "--max-new-tokens", "5",
               "--temperature", "0.8", "--top-k", "40", "--top-p", "0.95",
               "--num-samples", "2", "--seed", "3"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["prompt_len"] == 8 and out["num_samples"] == 2
    assert all(len(s["tokens"]) == 5 and "text" in s
               for s in out["samples"])
    proc = subprocess.run(cmd[:3] + ["--ckpt-dir", "x", "--prompt-tokens",
                                     "1"], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode != 0 and "not ported" in proc.stderr
