from nezha_tpu_torch.nn import initializers
from nezha_tpu_torch.nn.layers import Embedding, LayerNorm, Linear

__all__ = ["Embedding", "LayerNorm", "Linear", "initializers"]
