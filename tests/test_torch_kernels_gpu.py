"""The port's CUDA kernels on the card, against their plain versions, and
the engine on the card against the same engine on the CPU. Every test
here needs a CUDA card: it is marked ``gpu`` and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from nezha_tpu_torch.cli.common import gpt2_for_preset
from nezha_tpu_torch.ops.cuda import (paged_decode_attention,
                                      paged_decode_attention_plain,
                                      paged_prefill_attention,
                                      paged_prefill_attention_plain)
from nezha_tpu_torch.ops.cuda.common import fold_error_bound
from nezha_tpu_torch.serve import Engine, Request, Scheduler, ServeConfig

BS, M, H, D = 8, 12, 2, 64
DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
          (torch.float32, torch.float32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_within_bound(got, want, want_abs_v, p_bf16):
    """|kernel - plain| within fold_error_bound: fp32 rounding (1e-5),
    plus 2^-7 of the weighted |v| where p is rounded to bf16, plus 2^-7
    of |out| where the output is bf16."""
    bound = fold_error_bound(want, want_abs_v, p_bf16)
    err = (got.float() - want.float()).abs()
    assert torch.all(err <= bound), (
        f"max |kernel - plain| / bound {(err / bound).max().item():.3f}")


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", DTYPES)
def test_decode_kernel_matches_plain(cuda_device, q_dtype, pool_dtype):
    rng = np.random.RandomState(0)
    lengths = np.asarray([0, 1, BS - 1, BS, BS + 1, 33, M * BS], np.int32)
    b, n = len(lengths), 1 + len(lengths) * M
    q = rng.randn(b, H, 1, D).astype(np.float32)
    kp, vp = (rng.randn(n, H, BS, D).astype(np.float32) for _ in range(2))
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    dev = cuda_device
    args = (torch.from_numpy(q).to(dev, q_dtype),
            torch.from_numpy(kp).to(dev, pool_dtype),
            torch.from_numpy(vp).to(dev, pool_dtype),
            torch.from_numpy(lengths).to(dev), torch.from_numpy(tab).to(dev))
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_plain(*args)
    abs_v = paged_decode_attention_plain(*args[:2], args[2].abs(), *args[3:])
    _assert_within_bound(got, want, abs_v, pool_dtype == torch.bfloat16)
    assert torch.all(got[0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", DTYPES)
@pytest.mark.parametrize("s", [16, 40])
def test_prefill_kernel_matches_plain(cuda_device, q_dtype, pool_dtype, s):
    rng = np.random.RandomState(1)
    starts = np.asarray([0, 5, 16, M * BS - s], np.int32)
    b, n = len(starts), 1 + len(starts) * M
    q, kc, vc = (rng.randn(b, H, s, D).astype(np.float32) for _ in range(3))
    kp, vp = (rng.randn(n, H, BS, D).astype(np.float32) for _ in range(2))
    tab = (1 + rng.permutation(b * M)).reshape(b, M).astype(np.int32)
    dev = cuda_device
    args = (torch.from_numpy(q).to(dev, q_dtype),
            torch.from_numpy(kc).to(dev, q_dtype),
            torch.from_numpy(vc).to(dev, q_dtype),
            torch.from_numpy(kp).to(dev, pool_dtype),
            torch.from_numpy(vp).to(dev, pool_dtype),
            torch.from_numpy(tab).to(dev), torch.from_numpy(starts).to(dev))
    before = paged_prefill_attention.launches
    got = paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == before + 1
    want = paged_prefill_attention_plain(*args)
    abs_v = paged_prefill_attention_plain(args[0], args[1], args[2].abs(),
                                          args[3], args[4].abs(), *args[5:])
    _assert_within_bound(got, want, abs_v, torch.bfloat16 in (q_dtype,
                                                             pool_dtype))


@pytest.mark.gpu
def test_engine_on_card_matches_cpu(cuda_device):
    """The tiny preset in f32 with f32 pools serves the same greedy tokens
    on the card (CUDA kernels) as on the CPU (plain versions), through
    chunked prefill and a prefix-cache hit."""
    rng = np.random.RandomState(2)
    prefix = rng.randint(0, 512, 24).tolist()
    prompts = [rng.randint(0, 512, 5).tolist(),
               rng.randint(0, 512, 40).tolist(),
               prefix + [7, 8, 9], prefix + [1]]
    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu")
    results = []
    for device in ("cpu", cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu").to(device)
        model.load_state_dict(cpu_model.state_dict())
        sched = Scheduler(Engine(model, ServeConfig(
            max_batch_size=2, max_len=96, max_prefill_len=16,
            kv_block_size=8, cache_dtype=torch.float32)))
        for i, p in enumerate(prompts):
            sched.submit(Request(prompt=p, max_new_tokens=8,
                                 request_id=str(i)))
        sched.run_until_idle(max_iters=200)
        sched.engine.pool.leak_check()
        results.append({k: r.tokens for k, r in sched.results.items()})
    assert results[0] == results[1]
