"""The graph IR's ``flash_attention`` node on the card: on CUDA tensors
it launches the flash kernels (B1 forward; the delta pre-pass, B2 dQ and
B3 dK/dV in the backward), once each a node, and their results lie
within the kernel tests' bounds of the plain versions on the same card
(the forward within ``fold_error_bound``, the gradients within
``flash_bwd_error_bound``); ``impl="xla"`` launches none. Also a GPT-2
graph step on the card: 2 x 2 layers, exact launches. Every test here
needs a CUDA card: it is marked ``gpu`` and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_graph_gpu.py
"""

import numpy as np
import pytest
import torch

from nezha_tpu_torch.graph import Graph, to_callable
from nezha_tpu_torch.ops.cuda import flash_block_bwd_plain
from nezha_tpu_torch.ops.cuda import flash_block_fwd_plain
from nezha_tpu_torch.ops.cuda.common import fold_error_bound
from nezha_tpu_torch.ops.cuda.flash_attention import (LAUNCHES,
                                                      flash_bwd_error_bound)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _node(impl, causal, shape):
    g = Graph(f"attn_{impl}")
    q, k, v = (g.placeholder(shape, name=n) for n in "qkv")
    g.output(g.flash_attention(q, k, v, causal=causal, impl=impl))
    return to_callable(g)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_flash_node_launches_the_kernels(cuda_device, impl, causal, dtype):
    shape = (2, 4, 256, 64)
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(cuda_device, dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(LAUNCHES)
    out = _node(impl, causal, shape)(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert {n: LAUNCHES[n] - before[n] for n in LAUNCHES} == {
        "flash_fwd": 1, "flash_bwd_delta": 1, "flash_bwd_dq": 1,
        "flash_bwd_dkv": 1}
    want, lse = flash_block_fwd_plain(q, k, v, causal)
    abs_v = flash_block_fwd_plain(q, k, v.abs(), causal)[0]
    bound = fold_error_bound(want, abs_v, dtype == torch.bfloat16)
    assert torch.all((out.float() - want.float()).abs() <= bound)
    args = (q, k, v, want, lse, do, causal)
    for got, w, bd in zip(grads, flash_block_bwd_plain(*args),
                          flash_bwd_error_bound(*args)):
        assert torch.all((got.float() - w.float()).abs() <= bd)


def test_xla_node_launches_no_kernel(cuda_device):
    shape = (1, 2, 128, 64)
    q, k, v = (torch.randn(shape, device=cuda_device, requires_grad=True)
               for _ in range(3))
    before = dict(LAUNCHES)
    out = _node("xla", True, shape)(q, k, v)
    out.sum().backward()
    torch.cuda.synchronize()
    assert LAUNCHES == before


def test_gpt2_graph_step_on_the_card(cuda_device):
    """A two-layer GPT-2 graph program (bf16 policy) on the card: B1-B3
    and the pre-pass once a layer a step, a finite loss, the executor's
    one build."""
    from nezha_tpu_torch.graph import programs
    from nezha_tpu_torch.models import GPT2, GPT2Config
    from nezha_tpu_torch.tensor import bf16_policy

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = GPT2(GPT2Config(vocab_size=512, max_positions=128, num_layers=2,
                            num_heads=4, hidden_size=256), bf16_policy(),
                 generator=gen)
    step = programs.make_gpt2_graph_train_step(
        model, lambda t: 1e-3, compute_dtype="bfloat16")
    state = programs.init_graph_gpt2_state(model)
    rng = np.random.RandomState(0)
    before = dict(LAUNCHES)
    for _ in range(2):
        b = programs.lm_shard_fn()({"tokens": rng.randint(0, 512, (2, 129))})
        state, m = step(state, b)
        assert np.isfinite(float(m["loss"]))
    assert {n: LAUNCHES[n] - before[n] for n in LAUNCHES} == {
        n: 4 for n in LAUNCHES}
    assert step.executor.stats() == {"entries": 1, "hits": 1, "misses": 1}
