"""Diagnostics that split a kernel's time by stage on the card.

- ``attention_ablate``: the fused attention core's five ablated builds
  (``ops/attention_ablate.py``), each timed over a chain of calls.
- ``trace``: torch.profiler's kernel records of a run, with a capture window
  that holds all of it.
"""
