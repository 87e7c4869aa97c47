"""The MIBF training step: losses, schedules and optimizers, metrics, and the
``Trainer`` with its resolved preset ``MIBF_HAM_TRAIN``."""
