from nezha_tpu_torch.serve.engine import (Engine, NotPortedError,
                                          ServeConfig, SpeculativeConfig,
                                          default_prefill_buckets,
                                          self_draft)
from nezha_tpu_torch.serve import migrate
from nezha_tpu_torch.serve.migrate import MigrationError
from nezha_tpu_torch.serve.sampling import (accept_mask, categorical_rows,
                                            filter_logits, filtered_probs,
                                            finite_rows, residual_logits,
                                            sample_tokens, split_and_sample)
from nezha_tpu_torch.serve.scheduler import (PRIORITIES, FinishReason,
                                             QueueFull, Request,
                                             RequestResult, Scheduler,
                                             TenantOverLimit)
from nezha_tpu_torch.serve.sharded import (ShardedEngine,
                                           ShardedPagedSlotPool)
from nezha_tpu_torch.serve.slots import (KVBlocksExhausted, PagedSlotPool,
                                         PrefixTrie, SlotPool)

__all__ = ["Engine", "FinishReason", "KVBlocksExhausted", "MigrationError",
           "NotPortedError",
           "PRIORITIES", "PagedSlotPool", "PrefixTrie", "QueueFull",
           "Request", "RequestResult", "Scheduler", "ServeConfig",
           "ShardedEngine", "ShardedPagedSlotPool", "SlotPool",
           "SpeculativeConfig", "TenantOverLimit", "accept_mask",
           "categorical_rows", "default_prefill_buckets", "filter_logits",
           "filtered_probs", "finite_rows", "migrate", "residual_logits",
           "sample_tokens", "self_draft", "split_and_sample"]
