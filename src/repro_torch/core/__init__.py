"""Spreeze core of the port: the trainer, the transfer paths, the host
runtime, fault injection and adaptation."""
from repro_torch.core import faults
from repro_torch.core.adaptation import (auto_tune, tune_batch_size,
                                         tune_num_envs,
                                         tune_rounds_per_dispatch)
from repro_torch.core.faults import FaultPlan, FiniteGuardError, Preempted
from repro_torch.core.pipeline import (Draws, SpreezeConfig, SpreezeTrainer,
                                       TrainHistory)
from repro_torch.core.transfer import (QueueTransfer, SharedTransfer,
                                       make_transfer)

__all__ = ["Draws", "SpreezeConfig", "SpreezeTrainer", "TrainHistory",
           "auto_tune", "tune_batch_size", "tune_num_envs",
           "tune_rounds_per_dispatch", "QueueTransfer", "SharedTransfer",
           "make_transfer", "faults", "FaultPlan", "FiniteGuardError",
           "Preempted"]
