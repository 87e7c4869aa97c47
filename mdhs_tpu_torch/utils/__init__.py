"""Run directory, logging and metric records of a training run."""
