"""The port's counterparts of the reference's ``examples/``: run them with
``python -m repro_torch.examples.quickstart`` and ``python -m
repro_torch.examples.train_sac_pendulum``."""
