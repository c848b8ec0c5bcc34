"""Replay: the device-resident ring buffer and the n-step transform."""
from repro_torch.replay.buffer import (ReplayState, add_batch, init_replay,
                                       sample, specs_for_env, trainer_specs,
                                       uniform_indices)

__all__ = ["ReplayState", "add_batch", "init_replay", "sample",
           "specs_for_env", "trainer_specs", "uniform_indices"]
