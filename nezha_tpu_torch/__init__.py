"""nezha_tpu_torch — the PyTorch/CUDA port of ``nezha_tpu`` for NVIDIA Hopper.

The module layout mirrors ``nezha_tpu`` so every counterpart is found at
the same path (``nezha_tpu.serve.engine`` -> ``nezha_tpu_torch.serve.
engine``). The port imports ``torch`` and never ``jax``; the JAX package
stays the reference its tests hold it against.

What runs today is the serving slice: GPT-2 through the paged-KV
``serve.Engine`` and ``serve.Scheduler``, with the paged prefill and
decode attention on hand-written CUDA kernels (``ops/cuda``, sources in
``csrc/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on CPU tensors each kernel wrapper takes its plain
PyTorch version.

Importing this package imports nothing heavy: subpackages load on use.
"""
