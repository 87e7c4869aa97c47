"""Run directory, python logging and the metric writer of a training run.

Counterpart of ``mdhs_tpu/utils/logging.py``: ``setup_run_dir`` makes
``{log_dir}/{run_name}_{YYYYmmdd_HHMMSS}``, ``setup_logging`` sends the root
logger to ``training.log`` in it (and the console), and ``MetricWriter``
appends one JSON record ``{"tag", "value", "step"}`` a scalar to
``metrics.jsonl``, with TensorBoard beside it only where
``torch.utils.tensorboard`` imports (a machine may lack its ``tensorboard``
package: the JSONL file is then the whole record).
"""

from __future__ import annotations

import json
import logging
import os
from datetime import datetime


def setup_run_dir(log_dir: str, run_name: str) -> str:
    out = os.path.join(log_dir, f"{run_name}_{datetime.now().strftime('%Y%m%d_%H%M%S')}")
    os.makedirs(out, exist_ok=True)
    return out


def setup_logging(output_dir: str) -> None:
    """The root logger at INFO into ``output_dir/training.log`` (mode "w") and the
    console; the handlers it had are removed, a file handler's file closed."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    for h in logger.handlers[:]:
        logger.removeHandler(h)
        if isinstance(h, logging.FileHandler):
            h.close()
    fh = logging.FileHandler(os.path.join(output_dir, "training.log"), mode="w")
    fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    ch = logging.StreamHandler()
    ch.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(fh)
    logger.addHandler(ch)


class MetricWriter:
    """JSONL scalar log, and TensorBoard where it imports."""

    def __init__(self, output_dir: str, tensorboard: bool = True):
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(output_dir, "tensorboard"))
            except Exception:  # noqa: BLE001 - no tensorboard package: the JSONL file alone
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._f.closed:  # a report after fit reopens the file
            self._f = open(self.path, "a")
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
