"""nezha_tpu_torch — the PyTorch/CUDA port of ``nezha_tpu`` for NVIDIA Hopper.

The module layout mirrors ``nezha_tpu`` so every counterpart is found at
the same path (``nezha_tpu.serve.engine`` -> ``nezha_tpu_torch.serve.
engine``). The port imports ``torch`` and never ``jax``; the JAX package
stays the reference its tests hold it against.

What runs today:

- serving: GPT-2 through the paged-KV ``serve.Engine`` and
  ``serve.Scheduler``, with the paged prefill and decode attention on
  hand-written CUDA kernels; tensor-sharded over a one-process mesh
  through ``serve.ShardedEngine`` (``parallel.make_mesh``), with
  sequence-sharded prefill (ulysses, or ring on the q-offset prefill
  kernel), speculative decoding, the block wire and the int8 host tier
  under the mesh;
- training: GPT-2 through ``train.make_train_step`` / ``train.Trainer``
  and ``python -m nezha_tpu_torch.cli.train --config gpt2_124m`` (AdamW,
  the fused-head loss, synthetic token batches), with attention on the
  hand-written CUDA flash forward and backward kernels, and with
  ``ln_impl="pallas"`` every LayerNorm on the fused LayerNorm kernels;
  ResNet-50 (``--config resnet50_imagenet``: the s2d stem, BatchNorm
  running statistics in the model's buffers, momentum, synthetic image
  batches; convolutions on cuDNN, as no TPU kernel stands behind them)
  and the MNIST MLP (``--config mlp_mnist``), with ``train.evaluate``'s
  top-1 accuracy;
- generation: GPT-2 through ``models.generate`` and ``python -m
  nezha_tpu_torch.cli.generate`` (a KV-cache prefill, then one dense
  flash-decode kernel launch per layer per token);
- data and checkpoints: ``cli.pack_text`` with the GPT-2 BPE and BERT
  WordPiece tokenizers (``data.tokenizer``, learned by
  ``data.bpe_train``), the native C++ loaders behind the train CLI's
  ``--data-dir`` (``data.native``), and checkpoints in the JAX package's
  npz format (``train.checkpoint``), which generate and serve load with
  ``--ckpt-dir`` and ``--tokenizer``;
- multi-process training: one process per device, joined through the
  native coordinator (``dist``) into a ``torch.distributed`` group (nccl
  on the card, gloo on the CPU); data parallelism
  (``parallel.data_parallel``) and ZeRO-1 (``parallel.zero1``), the int8
  gradient wire (``parallel.quantized``) and per-shard checkpoints in the
  JAX package's layout (``train.sharded_checkpoint``), which generate and
  serve also load; tensor parallelism in one process over a
  ``dp x tp`` mesh (``parallel.gspmd``);
- the train CLI's single-card flags: batches staged onto the card by
  ``runtime.Prefetcher`` (pinned memory, a side stream), gradient
  accumulation and LARS, LAMB and Adafactor (``optim``), the JSONL
  metrics sink and the ``torch.profiler`` trace window (``obs``), and
  the card's memory metrics (``tensor.memory``).

Kernels live in ``ops/cuda`` (sources in ``csrc/``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on CPU tensors each
kernel wrapper takes its plain PyTorch version. What the port refuses
raises ``errors.NotPortedError``.

Importing this package imports nothing heavy: subpackages load on use.
"""
