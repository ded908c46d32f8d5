"""The port's CUDA kernels on the card, against their plain versions; the
engine, generate and a training step on the card against the same on the
CPU.
Every test here needs a CUDA card: it is marked ``gpu`` and skips
without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from nezha_tpu_torch.cli.common import gpt2_for_preset
from nezha_tpu_torch.models import generate
from nezha_tpu_torch.models.gpt2 import lm_loss
from nezha_tpu_torch.ops.cuda import (flash_block_bwd, flash_block_bwd_plain,
                                      flash_block_fwd, flash_block_fwd_plain,
                                      flash_decode_attention,
                                      flash_decode_attention_plain,
                                      layer_norm_bwd, layer_norm_bwd_plain,
                                      layer_norm_fwd, layer_norm_fwd_plain,
                                      paged_decode_attention,
                                      paged_decode_attention_plain,
                                      paged_prefill_attention,
                                      paged_prefill_attention_plain)
from nezha_tpu_torch.ops.cuda.common import fold_error_bound
from nezha_tpu_torch.ops.cuda.flash_attention import (LAUNCHES,
                                                      flash_bwd_error_bound)
from nezha_tpu_torch.ops.cuda.layer_norm import LAUNCHES as LN_LAUNCHES
from nezha_tpu_torch.ops.cuda.layer_norm import layer_norm_error_bound
from nezha_tpu_torch.optim import adamw
from nezha_tpu_torch.serve import Engine, Request, Scheduler, ServeConfig
from nezha_tpu_torch.train import make_train_step

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


# (S_q, S_k, D, causal, kv_lengths): a causal row cut mid-tile, a
# rectangular full case with a D that is 8 mod 16 (the padded last mma
# step), and D=128 with a zero-length row and a length past S.
FLASH_CASES = [(100, 100, 64, True, None), (100, 70, 40, False, None),
               (130, 130, 128, True, [0, 77, 500])]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_q,s_k,d,causal,lengths", FLASH_CASES)
def test_flash_kernels_match_plain(cuda_device, dtype, s_q, s_k, d, causal,
                                   lengths):
    """Forward out within fold_error_bound and lse within 1e-4 (fp32 sums
    in another order), dq/dk/dv within flash_bwd_error_bound, padded keys'
    dk/dv exactly zero, and the backward bitwise repeatable."""
    rng = np.random.RandomState(s_q + d)
    b = 3 if lengths else 2
    q, do = (torch.from_numpy(rng.randn(b, 2, s_q, d).astype(np.float32))
             .to(cuda_device, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, 2, s_k, d).astype(np.float32))
            .to(cuda_device, dtype) for _ in range(2))
    lens = (None if lengths is None
            else torch.tensor(lengths, dtype=torch.int32, device=cuda_device))
    before = dict(LAUNCHES)
    out, lse = flash_block_fwd(q, k, v, causal, kv_lengths=lens)
    torch.cuda.synchronize()
    want, want_lse = flash_block_fwd_plain(q, k, v, causal, kv_lengths=lens)
    abs_v = flash_block_fwd_plain(q, k, v.abs(), causal, kv_lengths=lens)[0]
    _assert_within_bound(out, want, abs_v, dtype == torch.bfloat16)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    args = (q, k, v, want, want_lse, do, causal)
    grads = flash_block_bwd(*args, kv_lengths=lens)
    torch.cuda.synchronize()
    plain = flash_block_bwd_plain(*args, kv_lengths=lens)
    bounds = flash_bwd_error_bound(*args, kv_lengths=lens)
    for name, got, w, bd in zip(("dq", "dk", "dv"), grads, plain, bounds):
        err = (got.float() - w.float()).abs()
        assert torch.all(err <= bd), (
            f"{name}: max |kernel - plain| / bound "
            f"{(err / bd).max().item():.3f}")
    for i, n in enumerate(lengths or []):
        n = max(1, min(n, s_k))
        assert torch.all(grads[1][i, :, n:] == 0)
        assert torch.all(grads[2][i, :, n:] == 0)
    again = flash_block_bwd(*args, kv_lengths=lens)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        "flash_fwd": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda_device):
    """One tiny-preset (f32) AdamW step on the card (flash kernels) and on
    the CPU (plain versions), same weights and batch: loss within 1e-5,
    every gradient within 1e-6 + 1e-4 of its tensor's largest magnitude,
    weights after the step within 2 * lr (an update flips where a
    gradient element sits near Adam's eps) and within 1e-3 * lr where the
    CPU gradient exceeds 100 * eps."""
    lr = 6e-4
    tokens = np.random.RandomState(3).randint(0, 512, (2, 33)).astype(
        np.int32)
    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu")
    results = []
    for device in ("cpu", cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu").to(device)
        model.load_state_dict(cpu_model.state_dict())
        step = make_train_step(model, adamw(lr, weight_decay=0.1), lm_loss)
        before = LAUNCHES["flash_fwd"]
        loss, grads = step.loss_and_grads({"tokens": tokens})
        step({"tokens": tokens})
        if device != "cpu":
            assert LAUNCHES["flash_fwd"] - before == 2 * 4   # 2 x 4 layers
        results.append((loss.item(), {k: g.cpu() for k, g in grads.items()},
                        {k: p.detach().cpu() for k, p in
                         step.params.items()}))
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = results
    assert abs(l_cpu - l_gpu) <= 1e-5
    for name, g in g_cpu.items():
        tol = 1e-6 + 1e-4 * g.abs().max().item()
        assert (g_gpu[name] - g).abs().max().item() <= tol, name
        diff = (p_gpu[name] - p_cpu[name]).abs()
        assert diff.max().item() <= 2 * lr, name
        clear = g.abs() > 100 * 1e-8
        if clear.any():
            assert diff[clear].max().item() <= 1e-3 * lr, name


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,cache_dtype", DTYPES)
def test_dense_decode_kernel_matches_plain(cuda_device, q_dtype,
                                           cache_dtype):
    """The dense flash-decode kernel within fold_error_bound of its plain
    version, over lengths that end inside a 32-key tile, on one, at the
    cache's end and past it; the zero-length row exact zero; two launches
    bitwise equal."""
    rng = np.random.RandomState(4)
    cap = 300
    lengths = np.asarray([0, 1, 31, 32, 33, 257, cap, cap + 9], np.int32)
    b = len(lengths)
    q = rng.randn(b, H, 1, D).astype(np.float32)
    k, v = (rng.randn(b, H, cap, D).astype(np.float32) for _ in range(2))
    dev = cuda_device
    args = (torch.from_numpy(q).to(dev, q_dtype),
            torch.from_numpy(k).to(dev, cache_dtype),
            torch.from_numpy(v).to(dev, cache_dtype),
            torch.from_numpy(lengths).to(dev))
    before = flash_decode_attention.launches
    got = flash_decode_attention(*args)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    assert got.dtype == q_dtype
    want = flash_decode_attention_plain(*args)
    abs_v = flash_decode_attention_plain(*args[:2], args[2].abs(), args[3])
    _assert_within_bound(got, want, abs_v, cache_dtype == torch.bfloat16)
    assert torch.all(got[0] == 0)
    assert torch.equal(flash_decode_attention(*args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(37, 768), (300, 64), (8, 1024)])
def test_layer_norm_kernels_match_plain(cuda_device, dtype, rows, d):
    """Forward y and backward dx, dscale, dbias (the partials summed)
    within layer_norm_error_bound of the plain versions; the backward
    bitwise repeatable; one launch of each kernel."""
    rng = np.random.RandomState(rows + d)
    x = rng.randn(rows, d) * 2 + rng.randn(rows, 1)
    x, dy = (torch.from_numpy(a.astype(np.float32)).to(cuda_device, dtype)
             for a in (x, rng.randn(rows, d)))
    scale, bias = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                   for a in (1 + 0.3 * rng.randn(d), 0.2 * rng.randn(d)))
    before = dict(LN_LAUNCHES)
    y = layer_norm_fwd(x, scale, bias, 1e-5)
    grads = layer_norm_bwd(x, scale, dy, 1e-5)
    torch.cuda.synchronize()
    assert {k: LN_LAUNCHES[k] - before[k] for k in LN_LAUNCHES} == {
        "layer_norm_fwd": 1, "layer_norm_bwd": 1}
    err = (y.float() - layer_norm_fwd_plain(x, scale, bias, 1e-5).float())
    bound = layer_norm_error_bound(x, scale, bias, 1e-5)
    assert torch.all(err.abs() <= bound), (err.abs() / bound).max().item()
    plain = layer_norm_bwd_plain(x, scale, dy, 1e-5)
    got = (grads[0].float(), grads[1].sum(0), grads[2].sum(0))
    want = (plain[0].float(), plain[1].sum(0), plain[2].sum(0))
    bounds = layer_norm_error_bound(x, scale, bias, 1e-5, dy=dy)
    for name, g, w, bd in zip(("dx", "dscale", "dbias"), got, want, bounds):
        assert torch.all((g - w).abs() <= bd), (
            f"{name}: max |kernel - plain| / bound "
            f"{((g - w).abs() / bd).max().item():.3f}")
    again = layer_norm_bwd(x, scale, dy, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.gpu
def test_generate_on_card_matches_cpu(cuda_device):
    """The tiny preset (f32) with ln_impl="pallas" and an f32 cache
    generates the same greedy tokens on the card (flash, flash-decode and
    LayerNorm kernels) as on the CPU (plain versions), and the card's run
    launches the decode kernel once per layer per decode step and the
    LayerNorm forward 9 times per forward (2 per block + ln_f)."""
    prompt = torch.from_numpy(
        np.random.RandomState(5).randint(0, 512, (2, 8)))
    cpu_model = gpt2_for_preset("tiny", seed=0, device="cpu",
                                ln_impl="pallas")
    results = []
    for device in ("cpu", cuda_device):
        model = gpt2_for_preset("tiny", seed=0, device="cpu",
                                ln_impl="pallas").to(device)
        model.load_state_dict(cpu_model.state_dict())
        dec, ln = flash_decode_attention.launches, dict(LN_LAUNCHES)
        out = generate(model, prompt, 12, cache_dtype=torch.float32)
        if device != "cpu":
            assert flash_decode_attention.launches - dec == 11 * 4
            assert LN_LAUNCHES["layer_norm_fwd"] - ln["layer_norm_fwd"] \
                == 12 * 9
        results.append(out.cpu())
    assert torch.equal(results[0], results[1])
