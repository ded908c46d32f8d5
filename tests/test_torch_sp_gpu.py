"""Sequence parallelism's kernels on the card: the flash ring (B1 a hop
forward; the delta pre-pass, B2 and B3 a hop backward) and Ulysses with
the flash kernels, each against the composed version on the same card,
with exact launches, on a mesh of one card repeated. Every test here
needs a CUDA card: it is marked ``gpu`` and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_sp_gpu.py
"""

import numpy as np
import pytest
import torch

from nezha_tpu_torch import optim
from nezha_tpu_torch.models import GPT2, GPT2Config
from nezha_tpu_torch.ops.cuda.flash_attention import LAUNCHES
from nezha_tpu_torch.parallel import (make_sp_mesh, make_sp_train_step,
                                      ring_attention, ulysses_attention)

pytestmark = pytest.mark.gpu

SP = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _zero():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _run(fn, dtype, device, causal, h=4):
    """Output and q/k/v gradients of a weighted sum through ``fn`` over
    SP shards on the card, and the launches of that forward and
    backward."""
    g = torch.Generator().manual_seed(0)
    ts = [torch.randn(2, h, 256, 64, generator=g).to(device, dtype)
          .requires_grad_() for _ in range(3)]
    w = torch.randn(2, h, 256, 64, generator=g).to(device)
    split = [list(t.chunk(SP, dim=2)) for t in ts]
    _zero()
    out = torch.cat(fn(*split, causal=causal), dim=2)
    (out.float() * w).sum().backward()
    torch.cuda.synchronize()
    return [out.detach().float()] + [t.grad.float() for t in ts], \
        dict(LAUNCHES)


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 2e-5),
                                              (torch.bfloat16, 0.1, 0.1)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_matches_composed_with_exact_launches(cuda_device, dtype,
                                                         rtol, atol, causal):
    """Causal: shard r runs r + 1 hops (10 at sp=4); full: 16."""
    got, n = _run(lambda *a, causal: ring_attention(*a, causal=causal),
                  dtype, cuda_device, causal)
    want, n0 = _run(lambda *a, causal: ring_attention(*a, causal=causal,
                                                      use_flash=False),
                    dtype, cuda_device, causal)
    hops = SP * (SP + 1) // 2 if causal else SP * SP
    assert n == {k: hops for k in LAUNCHES}
    assert n0 == {k: 0 for k in LAUNCHES}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_ulysses_flash_matches_composed_with_exact_launches(cuda_device):
    got, n = _run(lambda *a, causal: ulysses_attention(*a, causal=causal),
                  torch.float32, cuda_device, True, h=8)
    want, n0 = _run(lambda *a, causal: ulysses_attention(
        *a, causal=causal, use_flash=False), torch.float32, cuda_device,
        True, h=8)
    assert n == {k: SP for k in LAUNCHES} and n0 == {k: 0 for k in LAUNCHES}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_sp_step_on_card_matches_cpu(cuda_device):
    """A tiny fp32 GPT-2's ring sp step on the card (dp=1, sp=2, the card
    repeated) against the same step on the CPU: the loss within 1e-4,
    every gradient within 1e-3 of its norm; B1 and the backward's three
    3 a layer."""
    kw = dict(vocab_size=128, max_positions=64, num_layers=2, num_heads=4,
              hidden_size=64, attn_impl="ring")
    tokens = np.random.RandomState(0).randint(0, 128, (4, 65))
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        model = GPT2(GPT2Config(**kw), device="cpu")
        model.to(dev)
        step = make_sp_train_step(model, optim.sgd(0.1), make_sp_mesh(
            {"dp": 1, "sp": 2}, [dev] * 2, device_type=dev.type))
        _zero()
        loss, grads = step.loss_and_grads({"tokens": tokens})
        res.append((loss.item(), {k: v.cpu() for k, v in grads.items()},
                    dict(LAUNCHES)))
    (l1, g1, n1), (l0, g0, _) = res
    assert n1 == {k: 3 * 2 for k in LAUNCHES}
    assert abs(l1 - l0) <= 1e-4
    for k in g0:
        assert (g1[k] - g0[k]).norm() <= 1e-3 * g0[k].norm() + 1e-8, k
