"""Accuracy of the training and validation steps, on the device.

Counterpart of the masked step accuracy of ``mdhs_tpu/train/trainer.py:683-688``
and the hit count of its validation step (:788-790). The macro P/R/F1 and
AUROC report (``mdhs_tpu/train/metrics.py::classification_report``) is not
ported yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional

import torch


def correct_count(logits: torch.Tensor, labels: torch.Tensor,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of rows whose argmax is the label, over the rows the mask keeps."""
    hits = (logits.argmax(dim=-1) == labels).float()
    return hits.sum() if sample_mask is None else (hits * sample_mask).sum()


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of the kept rows whose argmax is the label (a 0-d tensor)."""
    hits = (logits.argmax(dim=-1) == labels).float()
    if sample_mask is None:
        return hits.mean()
    return (hits * sample_mask).sum() / torch.clamp(sample_mask.sum(), min=1.0)
