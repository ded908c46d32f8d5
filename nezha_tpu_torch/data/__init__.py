from nezha_tpu_torch.data.synthetic import synthetic_token_batches

__all__ = ["synthetic_token_batches"]
