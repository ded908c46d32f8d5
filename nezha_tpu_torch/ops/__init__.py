from nezha_tpu_torch.ops.activations import gelu, relu
from nezha_tpu_torch.ops.attention import (NEG_BIG, causal_mask,
                                           dot_product_attention,
                                           make_attention_mask)

__all__ = ["NEG_BIG", "causal_mask", "dot_product_attention", "gelu",
           "make_attention_mask", "relu"]
