"""The ``NEZHA_NO_*`` environment switches in the port against the JAX
package, on the CPU at the tiny preset. Calls of the kernel wrappers the
model reaches are counted (``paged_decode_attention`` carries B7 and B8,
``flash_decode_attention`` B6, ``paged_prefill_attention`` B9 and B10):

- ``NEZHA_NO_DECODE_KERNEL`` sends every decode step (paged f32, paged
  int8, dense) down the composed path, even over ``decode_impl=
  "kernel"``; the greedy tokens equal JAX's engine under the same
  variable and the port's own ``decode_impl="xla"`` engine's; generate
  too;
- ``NEZHA_NO_PREFILL_KERNEL`` does the same for paged prefill chunks
  over ``prefill_impl="kernel"``; ``serve.prefill.kernel_active`` reads
  0 and one warning names the variable;
- under a mesh ``NEZHA_NO_NESTED_KERNELS`` sends decode and prefill to
  the composed attention on every shard, each kernel switch its own
  path, with JAX's sharded engine's tokens; ``NEZHA_NO_SEQ_PREFILL`` turns
  ``prefill_mode="sequence"`` back into the replicated prefill, with
  JAX's sharded engine's tokens under the same variable."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nezha_tpu.cli.train import TINY_GPT2_KW
from nezha_tpu.models.gpt2 import GPT2 as JaxGPT2
from nezha_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from nezha_tpu.serve import Engine as JaxEngine
from nezha_tpu.serve import Request as JaxRequest
from nezha_tpu.serve import Scheduler as JaxScheduler
from nezha_tpu.serve import ServeConfig as JaxServeConfig
from nezha_tpu_torch import obs
from nezha_tpu_torch.models import GPT2, GPT2Config, params_from_jax
from nezha_tpu_torch.models import gpt2 as gpt2_mod
from nezha_tpu_torch.models.generate import generate
from nezha_tpu_torch.serve import (Engine, Request, Scheduler, ServeConfig,
                                   ShardedEngine)
from test_torch_sharded import KW, jax_tokens, make_pair, run_waves

SERVE_KW = dict(max_batch_size=3, max_len=96, max_prefill_len=16,
                kv_block_size=8, k_max=16)
WRAPPERS = ("paged_decode_attention", "flash_decode_attention",
            "paged_prefill_attention")


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxGPT2(JaxGPT2Config(**TINY_GPT2_KW))
    jv = jm.init(jax.random.PRNGKey(0))
    tm = GPT2(GPT2Config(**TINY_GPT2_KW), device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(jv["params"])), strict=True)
    return jm, jv, tm


@pytest.fixture
def calls(monkeypatch):
    """Counts of the kernel wrappers' calls from the model."""
    counts = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        inner = getattr(gpt2_mod, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            counts[_name] += 1
            return _inner(*a, **kw)

        monkeypatch.setattr(gpt2_mod, name, spy)
    return counts


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("NEZHA_NO_DECODE_KERNEL", "NEZHA_NO_PREFILL_KERNEL",
                "NEZHA_NO_NESTED_KERNELS", "NEZHA_NO_SEQ_PREFILL"):
        monkeypatch.delenv(var, raising=False)
    yield
    obs.disable()


def _waves():
    rng = np.random.RandomState(4)
    prefix = rng.randint(0, 512, 24).tolist()
    return [[("short", rng.randint(0, 512, 5).tolist(), 8),
             ("chunked", rng.randint(0, 512, 40).tolist(), 8)],
            [("donor", prefix + rng.randint(0, 512, 5).tolist(), 6)],
            [("hit", prefix + rng.randint(0, 512, 7).tolist(), 6)]]


def _serve(sched, make_request):
    for wave in _waves():
        for rid, prompt, n in wave:
            sched.submit(make_request(prompt=prompt, max_new_tokens=n,
                                      request_id=rid))
        sched.run_until_idle(max_iters=200)
        assert not sched.has_work()
    return {rid: r.tokens for rid, r in sched.results.items()}


def _jax_tokens(jm, jv, **kw):
    return _serve(JaxScheduler(JaxEngine(jm, jv, JaxServeConfig(
        **SERVE_KW, cache_dtype=jnp.float32, **kw))), JaxRequest)


def _port(tm, **kw):
    return Engine(tm, ServeConfig(**SERVE_KW, cache_dtype=torch.float32,
                                  **kw))


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def warnings_seen():
    handler = _Records()
    logger = logging.getLogger("nezha_tpu_torch")
    logger.addHandler(handler)
    yield handler.messages
    logger.removeHandler(handler)


@pytest.mark.parametrize("layout,kv_dtype", [
    ("paged", "bf16"), ("paged", "int8"), ("dense", "bf16")])
def test_decode_switch_takes_the_composed_path(models, calls, monkeypatch,
                                               warnings_seen, layout,
                                               kv_dtype):
    jm, jv, tm = models
    kw = dict(kv_layout=layout, kv_dtype=kv_dtype)
    kernel = _serve(Scheduler(_port(tm, **kw)), Request)
    assert calls["paged_decode_attention" if layout == "paged"
                 else "flash_decode_attention"] > 0
    xla = _serve(Scheduler(_port(tm, decode_impl="xla", **kw)), Request)
    monkeypatch.setenv("NEZHA_NO_DECODE_KERNEL", "1")
    for k in calls:
        calls[k] = 0
    got = _serve(Scheduler(_port(tm, decode_impl="kernel", **kw)), Request)
    assert calls["paged_decode_attention"] == 0
    assert calls["flash_decode_attention"] == 0
    if layout == "paged":
        assert calls["paged_prefill_attention"] > 0
    assert got == xla
    assert got == _jax_tokens(jm, jv, decode_impl="kernel", **kw)
    assert kernel.keys() == got.keys()
    assert sum("NEZHA_NO_DECODE_KERNEL" in m for m in warnings_seen) == 1


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_switch_takes_the_composed_path(models, calls, monkeypatch,
                                                warnings_seen, kv_dtype):
    jm, jv, tm = models
    xla = _serve(Scheduler(_port(tm, prefill_impl="xla",
                                 kv_dtype=kv_dtype)), Request)
    assert calls["paged_prefill_attention"] == 0
    monkeypatch.setenv("NEZHA_NO_PREFILL_KERNEL", "1")
    obs.REGISTRY.reset()
    obs.enable()
    eng = _port(tm, prefill_impl="kernel", kv_dtype=kv_dtype)
    assert not eng.prefill_kernel_active
    assert obs.gauge("serve.prefill.kernel_active").value == 0.0
    got = _serve(Scheduler(eng), Request)
    assert calls["paged_prefill_attention"] == 0
    assert calls["paged_decode_attention"] > 0
    assert got == xla
    assert got == _jax_tokens(jm, jv, prefill_impl="kernel",
                              kv_dtype=kv_dtype)
    assert sum("NEZHA_NO_PREFILL_KERNEL" in m for m in warnings_seen) == 1


def test_switches_read_at_resolution(models, monkeypatch):
    """The resolvers read the environment each time, and the switch beats
    a config's "kernel"."""
    _, _, tm = models
    cfg = dataclasses.replace(tm.cfg, decode_impl="kernel",
                              prefill_impl="kernel")
    assert gpt2_mod.decode_kernel_ok(cfg) and gpt2_mod.prefill_kernel_ok(cfg)
    monkeypatch.setenv("NEZHA_NO_DECODE_KERNEL", "1")
    assert not gpt2_mod.decode_kernel_ok(cfg)
    assert gpt2_mod.prefill_kernel_ok(cfg)
    monkeypatch.setenv("NEZHA_NO_PREFILL_KERNEL", "1")
    assert not gpt2_mod.prefill_kernel_ok(cfg)
    monkeypatch.delenv("NEZHA_NO_DECODE_KERNEL")
    monkeypatch.delenv("NEZHA_NO_PREFILL_KERNEL")
    assert gpt2_mod.decode_kernel_ok(cfg) and gpt2_mod.prefill_kernel_ok(cfg)


def test_generate_decode_switch(models, calls, monkeypatch):
    _, _, tm = models
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, 512, (2, 9)))
    want = generate(gpt2_mod.with_overrides(tm, decode_impl="xla"),
                    prompt, max_new_tokens=6, temperature=0.0)
    assert calls["flash_decode_attention"] == 0
    monkeypatch.setenv("NEZHA_NO_DECODE_KERNEL", "1")
    got = generate(tm, prompt, max_new_tokens=6, temperature=0.0)
    assert calls["flash_decode_attention"] == 0
    assert torch.equal(got, want)
    monkeypatch.delenv("NEZHA_NO_DECODE_KERNEL")
    generate(tm, prompt, max_new_tokens=6, temperature=0.0)
    assert calls["flash_decode_attention"] > 0


# ------------------------------------------------------------- the mesh
@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.mark.parametrize("var", ["NEZHA_NO_NESTED_KERNELS",
                                 "NEZHA_NO_DECODE_KERNEL",
                                 "NEZHA_NO_PREFILL_KERNEL"])
def test_kernel_switches_refused_under_a_mesh(pair, monkeypatch, calls,
                                              var):
    """Under a mesh no switch is refused any more: each sends its paths
    to the composed attention on every shard (``NEZHA_NO_NESTED_KERNELS``
    both decode and prefill, as JAX's nested kernels turn off; the kernel
    switches their own path), ``serve.prefill.kernel_active`` reads 0
    where prefill is composed, and the greedy tokens are JAX's sharded
    engine's under the same variable."""
    jm, jv, tm = pair
    monkeypatch.setenv(var, "1")
    obs.REGISTRY.reset()
    obs.enable()
    eng = ShardedEngine(tm, ServeConfig(**KW, cache_dtype=torch.float32),
                        mesh_devices=2)
    got = run_waves(eng, Request, Scheduler)
    decode_off = var != "NEZHA_NO_PREFILL_KERNEL"
    prefill_off = var != "NEZHA_NO_DECODE_KERNEL"
    assert (calls["paged_decode_attention"] == 0) == decode_off
    assert (calls["paged_prefill_attention"] == 0) == prefill_off
    assert eng.prefill_kernel_active is not prefill_off
    assert obs.gauge("serve.prefill.kernel_active").value == (
        0.0 if prefill_off else 1.0)
    obs.disable()
    assert got == jax_tokens(jm, jv, 2)
    eng.pool.leak_check()


def test_seq_prefill_switch_serves_replicated(pair, monkeypatch,
                                              warnings_seen):
    jm, jv, tm = pair
    monkeypatch.setenv("NEZHA_NO_SEQ_PREFILL", "1")
    obs.REGISTRY.reset()
    obs.enable()
    eng = ShardedEngine(tm, ServeConfig(**KW, cache_dtype=torch.float32,
                                        prefill_mode="sequence"),
                        mesh_devices=2)
    assert not eng._seq_active and eng.cfg.prefill_mode == "replicated"
    assert obs.gauge("serve.prefill.seq_shards").value == 0.0
    got = run_waves(eng, Request, Scheduler)
    obs.disable()
    assert got == jax_tokens(jm, jv, 2, prefill_mode="sequence")
    assert sum("NEZHA_NO_SEQ_PREFILL" in m for m in warnings_seen) == 1
