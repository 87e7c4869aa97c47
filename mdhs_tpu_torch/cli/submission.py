"""The submission CSV the prediction and serving CLIs write.

Counterpart of ``mdhs_tpu/cli/common.py::write_submission``; it imports no
model code, so ``run_serve`` can write one from an artifact alone.
"""

from __future__ import annotations

import csv
import os


def write_submission(path: str, image_ids, predictions) -> None:
    """The submission CSV, ``image_id,predicted_label``."""
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_id", "predicted_label"])
        for i, p in zip(image_ids, predictions):
            w.writerow([i, int(p)])
