"""Spreeze core of the port: the trainer and the shared-memory transfer."""
from repro_torch.core.pipeline import (Draws, SpreezeConfig, SpreezeTrainer,
                                       TrainHistory)
from repro_torch.core.transfer import SharedTransfer

__all__ = ["Draws", "SpreezeConfig", "SpreezeTrainer", "TrainHistory",
           "SharedTransfer"]
