from nezha_tpu_torch.models.bert import Bert, BertConfig, bert_base, mlm_loss
from nezha_tpu_torch.models.convert import (bert_from_jax, bert_to_jax,
                                           params_from_jax, params_to_jax,
                                           resnet_from_jax, resnet_to_jax)
from nezha_tpu_torch.models.generate import generate, init_cache
from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_124m, lm_loss
from nezha_tpu_torch.models.mlp import MLP
from nezha_tpu_torch.models.resnet import ResNet, resnet50, wide_resnet101

__all__ = ["Bert", "BertConfig", "GPT2", "GPT2Config", "MLP", "ResNet",
           "bert_base", "bert_from_jax", "bert_to_jax", "generate",
           "gpt2_124m", "init_cache", "lm_loss", "mlm_loss",
           "params_from_jax", "params_to_jax", "resnet50",
           "resnet_from_jax", "resnet_to_jax", "wide_resnet101"]
