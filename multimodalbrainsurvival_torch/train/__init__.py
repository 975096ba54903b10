"""Train and eval loop, optimizers, checkpoints and model adapters of the
port."""

from multimodalbrainsurvival_torch.train.loop import (
    TrainingPreempted,
    TrainSettings,
    evaluate,
    train_model,
)

__all__ = ["TrainSettings", "TrainingPreempted", "evaluate", "train_model"]
