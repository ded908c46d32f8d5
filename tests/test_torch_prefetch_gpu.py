"""The prefetcher's pinned side-stream copy on the card. Every test here
needs a CUDA card: it is marked ``gpu`` and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_prefetch_gpu.py
"""

import json
import threading

import numpy as np
import pytest
import torch

from nezha_tpu_torch.runtime import Prefetcher
from nezha_tpu_torch.runtime.prefetch import _pinned
from nezha_tpu_torch.train import batch_to_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _batches(n, seed=0):
    r = np.random.RandomState(seed)
    return [{"image": r.rand(8, 32, 32, 3).astype(np.float32),
             "label": r.randint(0, 1000, 8).astype(np.int32),
             "tokens": r.randint(0, 60000, (8, 65)).astype(np.uint16)}
            for _ in range(n)]


def _read_all(pf, timeout=60.0):
    out = []
    t = threading.Thread(target=lambda: out.extend(pf), daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive()
    return out


def test_staged_batches_equal_batch_to_device(cuda_device):
    src = _batches(6)
    pf = Prefetcher(iter(src), depth=2, device=cuda_device)
    assert pf._stream != torch.cuda.current_stream(cuda_device)
    got = _read_all(pf)
    pf.close()
    assert len(got) == len(src)
    for g, b in zip(got, src):
        want = batch_to_device(b, cuda_device)
        assert g.keys() == want.keys()
        for k, w in want.items():
            assert g[k].device == w.device and g[k].dtype == w.dtype, k
            assert torch.equal(g[k], w), k


def test_host_copies_are_pinned(cuda_device):
    b = _batches(1)[0]
    for k, x in b.items():
        h = _pinned(x)
        assert h.is_pinned(), k
        assert h.dtype == (torch.float32 if k == "image" else torch.int64)
        np.testing.assert_array_equal(h.numpy(), x)


def _streams(trace: dict):
    """(streams of the host-to-device copies, streams of the kernels)."""
    copies, kernels = set(), set()
    for e in trace.get("traceEvents", []):
        name, stream = e.get("name", ""), e.get("args", {}).get("stream")
        if stream is None:
            continue
        if "Memcpy HtoD" in name:
            copies.add(stream)
        elif e.get("cat") == "kernel":
            kernels.add(stream)
    return copies, kernels


def test_copies_run_on_the_side_stream(cuda_device, tmp_path):
    """Under the profiler, every host-to-device copy of the batches runs
    on a stream where the consumer's kernels do not."""
    src = _batches(4, seed=1)
    w = torch.randn(3, 3, device=cuda_device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pf = Prefetcher(iter(src), depth=2, device=cuda_device)
        for b in _read_all(pf):
            (b["image"].reshape(-1, 3) @ w).sum().item()
        pf.close()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    copies, kernels = _streams(json.loads(path.read_text()))
    assert copies and kernels
    assert not copies & kernels


def test_source_error_reaches_the_consumer(cuda_device):
    def broken():
        yield _batches(1)[0]
        raise RuntimeError("source broke")

    pf = Prefetcher(broken(), depth=1, device=cuda_device)
    assert next(pf)["image"].is_cuda
    with pytest.raises(RuntimeError, match="source broke"):
        next(pf)
    pf.close()
