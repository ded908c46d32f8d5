from nezha_tpu_torch.train.eval import (accuracy, evaluate, lm_token_stats,
                                        make_eval_step, mlm_token_stats)
from nezha_tpu_torch.train.loop import (TrainStep, Trainer, batch_to_device,
                                        make_train_step)

__all__ = ["TrainStep", "Trainer", "accuracy", "batch_to_device",
           "evaluate", "lm_token_stats", "make_eval_step", "make_train_step",
           "mlm_token_stats"]
