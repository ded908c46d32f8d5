from nezha_tpu_torch.models.convert import params_from_jax, params_to_jax
from nezha_tpu_torch.models.generate import generate, init_cache
from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_124m, lm_loss

__all__ = ["GPT2", "GPT2Config", "generate", "gpt2_124m", "init_cache",
           "lm_loss", "params_from_jax", "params_to_jax"]
