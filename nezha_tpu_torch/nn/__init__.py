from nezha_tpu_torch.nn import initializers
from nezha_tpu_torch.nn.layers import (BatchNorm, Conv2d, Dropout, Embedding,
                                       LayerNorm, Linear, avg_pool,
                                       global_avg_pool, max_pool,
                                       resolve_device)

__all__ = ["BatchNorm", "Conv2d", "Dropout", "Embedding", "LayerNorm",
           "Linear", "avg_pool", "global_avg_pool", "initializers",
           "max_pool", "resolve_device"]
