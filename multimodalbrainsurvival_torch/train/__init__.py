"""Eval loop and model adapters of the port."""

from multimodalbrainsurvival_torch.train.loop import TrainSettings, evaluate

__all__ = ["TrainSettings", "evaluate"]
