from nezha_tpu_torch.train.eval import accuracy, evaluate, make_eval_step
from nezha_tpu_torch.train.loop import (TrainStep, Trainer, batch_to_device,
                                        make_train_step)

__all__ = ["TrainStep", "Trainer", "accuracy", "batch_to_device",
           "evaluate", "make_eval_step", "make_train_step"]
