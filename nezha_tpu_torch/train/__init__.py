from nezha_tpu_torch.train.loop import TrainStep, Trainer, make_train_step

__all__ = ["TrainStep", "Trainer", "make_train_step"]
