"""Tensor-sharded serving over a one-process mesh (counterpart of
``nezha_tpu/serve/sharded``): :class:`ShardedEngine` with its head-sharded
pool, the parameter placement, a training checkpoint streamed onto the
mesh and sequence-sharded prefill."""

from nezha_tpu_torch.serve.sharded.engine import ShardedEngine
from nezha_tpu_torch.serve.sharded.model import ShardedGPT2
from nezha_tpu_torch.serve.sharded.pool import ShardedPagedSlotPool
from nezha_tpu_torch.serve.sharded.reshard import (GPT2_TP_RULES,
                                                   ReshardError, Split,
                                                   place_variables,
                                                   reshard_checkpoint,
                                                   save_serve_checkpoint,
                                                   serve_tp_rules,
                                                   verify_roundtrip)
from nezha_tpu_torch.serve.sharded.seq_prefill import seq_prefill_attention

__all__ = ["GPT2_TP_RULES", "ReshardError", "ShardedEngine", "ShardedGPT2",
           "ShardedPagedSlotPool", "Split", "place_variables",
           "reshard_checkpoint", "save_serve_checkpoint",
           "seq_prefill_attention", "serve_tp_rules", "verify_roundtrip"]
