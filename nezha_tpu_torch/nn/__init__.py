from nezha_tpu_torch.nn import initializers
from nezha_tpu_torch.nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                                       resolve_device)

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "initializers",
           "resolve_device"]
