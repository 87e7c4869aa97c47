"""Classification metrics, on the device of their inputs.

Counterpart of the masked step accuracy of ``mdhs_tpu/train/trainer.py:683-688``,
the hit count of its validation step (:788-790), and of
``mdhs_tpu/train/metrics.py``: the confusion matrix, per-class and macro
precision / recall / F1, micro and macro accuracy, and the macro
one-vs-rest AUROC by the rank-sum statistic with average ranks for ties,
all in float32 as there; ``classification_report`` gathers them for the
eval CLIs.
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


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) float32; rows = true, columns = predicted."""
    idx = (labels.long() * num_classes + preds.long()).reshape(-1)
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes).float()


def per_class_metrics(cm: torch.Tensor) -> dict:
    """Per-class vectors: accuracy (recall), precision, recall, f1; a class
    absent from the labels or the predictions gets 0 (torchmetrics' default)."""
    tp = torch.diag(cm)
    support, predicted = cm.sum(dim=1), cm.sum(dim=0)
    zero = torch.zeros_like(tp)
    precision = torch.where(predicted > 0, tp / torch.clamp(predicted, min=1.0), zero)
    recall = torch.where(support > 0, tp / torch.clamp(support, min=1.0), zero)
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall / torch.clamp(precision + recall, min=1e-12), zero)
    return {"accuracy": recall, "precision": precision, "recall": recall, "f1": f1}


def macro_metrics(cm: torch.Tensor) -> dict:
    """``accuracy`` is micro (correct / total); ``accuracy_macro`` the mean
    per-class recall (torchmetrics' multiclass Accuracy, the reference's
    logged val_Accuracy)."""
    per = per_class_metrics(cm)
    return {"accuracy": torch.diag(cm).sum() / torch.clamp(cm.sum(), min=1.0),
            "accuracy_macro": per["recall"].mean(), "precision_macro": per["precision"].mean(),
            "recall_macro": per["recall"].mean(), "f1_macro": per["f1"].mean()}


def auroc_ovr_macro(probs: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Macro one-vs-rest AUROC: AUC_c = (R_pos - n_pos (n_pos + 1) / 2) / (n_pos n_neg),
    R_pos the sum of the positives' 1-based ranks, tied scores taking the mean
    rank of their run; 0.5 for a class with no positive or no negative."""
    probs = probs.float()
    n = probs.shape[0]
    base = torch.arange(1, n + 1, dtype=torch.float32, device=probs.device)
    aucs = []
    for c in range(num_classes):
        scores = probs[:, c]
        pos = (labels == c).float()
        n_pos = pos.sum()
        n_neg = n - n_pos
        s, order = torch.sort(scores, stable=True)
        is_start = torch.ones(n, dtype=torch.bool, device=probs.device)
        is_start[1:] = s[1:] != s[:-1]
        run_id = torch.cumsum(is_start.long(), dim=0) - 1
        run_sum = torch.zeros(n, device=probs.device).index_add_(0, run_id, base)
        run_cnt = torch.zeros(n, device=probs.device).index_add_(0, run_id, torch.ones_like(base))
        ranks = (run_sum / torch.clamp(run_cnt, min=1.0))[run_id]
        inv = torch.zeros_like(ranks).index_copy_(0, order, ranks)
        r_pos = (inv * pos).sum()
        auc = (r_pos - n_pos * (n_pos + 1) / 2) / torch.clamp(n_pos * n_neg, min=1.0)
        aucs.append(torch.where((n_pos > 0) & (n_neg > 0), auc, torch.full_like(auc, 0.5)))
    return torch.stack(aucs).mean()


def classification_report(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> dict:
    """The eval CLIs' metric dict: the macro metrics, AUROC, per-class metrics and the confusion matrix."""
    logits = logits.float()
    preds = logits.argmax(dim=-1)
    probs = torch.softmax(logits, dim=-1)
    cm = confusion_matrix(preds, labels, num_classes)
    out = dict(macro_metrics(cm))
    out["auroc_macro"] = auroc_ovr_macro(probs, labels, num_classes)
    out["per_class"] = per_class_metrics(cm)
    out["confusion_matrix"] = cm
    return out
