"""nezha_tpu_torch — the PyTorch/CUDA port of ``nezha_tpu`` for NVIDIA Hopper.

The module layout mirrors ``nezha_tpu`` so every counterpart is found at
the same path (``nezha_tpu.serve.engine`` -> ``nezha_tpu_torch.serve.
engine``). The port imports ``torch`` and never ``jax``; the JAX package
stays the reference its tests hold it against.

What runs today:

- serving: GPT-2 through the paged-KV ``serve.Engine`` and
  ``serve.Scheduler``, with the paged prefill and decode attention on
  hand-written CUDA kernels;
- training: GPT-2 through ``train.make_train_step`` / ``train.Trainer``
  and ``python -m nezha_tpu_torch.cli.train --config gpt2_124m`` (AdamW,
  the fused-head loss, synthetic token batches), with attention on the
  hand-written CUDA flash forward and backward kernels, and with
  ``ln_impl="pallas"`` every LayerNorm on the fused LayerNorm kernels;
- generation: GPT-2 through ``models.generate`` and ``python -m
  nezha_tpu_torch.cli.generate`` (a KV-cache prefill, then one dense
  flash-decode kernel launch per layer per token).

Kernels live in ``ops/cuda`` (sources in ``csrc/``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on CPU tensors each
kernel wrapper takes its plain PyTorch version. What the port refuses
raises ``errors.NotPortedError``.

Importing this package imports nothing heavy: subpackages load on use.
"""
