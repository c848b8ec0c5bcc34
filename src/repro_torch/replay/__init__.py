"""Replay: the device-resident ring buffer, prioritized replay and the
n-step transform."""
from repro_torch.replay.buffer import (ReplayState, add_batch, init_replay,
                                       sample, specs_for_env, trainer_specs,
                                       uniform_indices)
from repro_torch.replay.prioritized import (PrioritizedState,
                                            init_prioritized)

__all__ = ["PrioritizedState", "ReplayState", "add_batch",
           "init_prioritized", "init_replay", "sample", "specs_for_env",
           "trainer_specs", "uniform_indices"]
