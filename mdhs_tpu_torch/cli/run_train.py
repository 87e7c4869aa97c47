"""Training CLI.

Counterpart of ``mdhs_tpu/cli/run_train.py``, on the card (``--device cuda``,
the default) or the CPU (``--device cpu``):

    python3 -m mdhs_tpu_torch.cli.run_train --config CFG.json [--family baseline|mibf|connext] [--set key=value ...]

The run directory (``{output.log_dir}/{output.run_name}_{timestamp}``) gets
``training.log``, ``config.json``, ``metrics.jsonl``, the top-3 checkpoints
by validation accuracy with their ``checkpoints.json`` and ``last.pt``;
``run_predict --model_path`` reads any of them. ``--set
training.resume_from=<run>/last.pt`` goes on from where that run stopped (a
``last.pt`` of another configuration gives its weights only). The family
defaults to ``baseline``, as in JAX. What the port does not train yet raises
before anything is built (``train/trainer.py::check_trainable``), and so does
a multi-process launch (``WORLD_SIZE`` > 1 in the environment, which the JAX
CLI hands to ``initialize_multihost``: ROADMAP Queue 1 item 12). ``main``
returns the trainer.
"""

from __future__ import annotations

import argparse
import os

from ..device import add_device_argument
from .common import build_trainer


def main(argv=None, family: str = "baseline"):
    p = argparse.ArgumentParser(description="Train a multimodal diagnosis model")
    p.add_argument("--config", type=str, required=True, help="config path (JSON, or YAML where yaml imports)")
    p.add_argument("--family", type=str, default=family, choices=["baseline", "mibf", "connext"])
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override key=value (repeatable)")
    add_device_argument(p)
    args = p.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(f"WORLD_SIZE={os.environ['WORLD_SIZE']}: multi-process training is not ported "
                                  "yet: ROADMAP Queue 1 item 12")
    trainer = build_trainer(args.config, family=args.family, overrides=args.overrides, device=args.device)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
