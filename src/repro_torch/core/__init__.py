"""Spreeze core of the port: the trainer, the transfer paths and the host
runtime."""
from repro_torch.core.pipeline import (Draws, SpreezeConfig, SpreezeTrainer,
                                       TrainHistory)
from repro_torch.core.transfer import (QueueTransfer, SharedTransfer,
                                       make_transfer)

__all__ = ["Draws", "SpreezeConfig", "SpreezeTrainer", "TrainHistory",
           "QueueTransfer", "SharedTransfer", "make_transfer"]
