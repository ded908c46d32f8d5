from nezha_tpu_torch.serve.engine import (Engine, NotPortedError,
                                          ServeConfig,
                                          default_prefill_buckets)
from nezha_tpu_torch.serve.sampling import (filter_logits, finite_rows,
                                            sample_tokens, split_and_sample)
from nezha_tpu_torch.serve.scheduler import (FinishReason, QueueFull,
                                             Request, RequestResult,
                                             Scheduler)
from nezha_tpu_torch.serve.sharded import (ShardedEngine,
                                           ShardedPagedSlotPool)
from nezha_tpu_torch.serve.slots import (KVBlocksExhausted, PagedSlotPool,
                                         PrefixTrie)

__all__ = ["Engine", "FinishReason", "KVBlocksExhausted", "NotPortedError",
           "PagedSlotPool", "PrefixTrie", "QueueFull", "Request",
           "RequestResult", "Scheduler", "ServeConfig", "ShardedEngine",
           "ShardedPagedSlotPool",
           "default_prefill_buckets", "filter_logits", "finite_rows",
           "sample_tokens", "split_and_sample"]
