from nezha_tpu_torch.models.convert import params_from_jax, params_to_jax
from nezha_tpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_124m

__all__ = ["GPT2", "GPT2Config", "gpt2_124m", "params_from_jax",
           "params_to_jax"]
