from nezha_tpu_torch.optim.optimizers import (Optimizer, adam, adamw,
                                              apply_updates_,
                                              clip_by_global_norm,
                                              global_norm, matrix_decay_mask,
                                              momentum, sgd,
                                              with_grad_clipping)
from nezha_tpu_torch.optim.schedules import (constant_schedule,
                                             cosine_decay_schedule,
                                             linear_warmup_schedule,
                                             warmup_cosine_schedule)

__all__ = ["Optimizer", "adam", "adamw", "apply_updates_",
           "clip_by_global_norm", "constant_schedule",
           "cosine_decay_schedule", "global_norm", "linear_warmup_schedule",
           "matrix_decay_mask", "momentum", "sgd", "warmup_cosine_schedule",
           "with_grad_clipping"]
