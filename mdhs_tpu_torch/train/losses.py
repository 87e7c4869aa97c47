"""Losses of the training step, computed in float32.

Counterpart of ``mdhs_tpu/train/losses.py:28-176``: ``cross_entropy`` with
torch ``CrossEntropyLoss`` semantics (label smoothing, class weights with the
weighted-mean normalisation; the mean, or ``reduction="none"`` per row) plus
a 0/1 ``sample_mask`` that drops the padded tail rows of a short last batch;
``masked_mean``; the baseline family's ``focal_loss`` and ``supcon_loss``
and the ``LOSSES`` dispatch by ``training.loss.type``; ``kl_divergence``;
``mp_loss`` (MIBF's MP-Loss: 0.3 CE_image + 0.6 CE_text + 1.1 mean(exp(symKL)
CE_joint)); ``mibf_loss`` in its three modes; ``compute_class_weights``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def compute_class_weights(labels, num_classes: int) -> np.ndarray:
    """total / (count * num_classes), counts clamped to >= 1."""
    counts = np.zeros(num_classes, dtype=np.float64)
    for label in np.asarray(labels):
        if 0 <= int(label) < num_classes:
            counts[int(label)] += 1
    total = max(counts.sum(), 1.0)
    return (total / (np.maximum(counts, 1.0) * num_classes)).astype(np.float32)


def masked_mean(per_sample: torch.Tensor, sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the rows where sample_mask == 1."""
    if sample_mask is None:
        return per_sample.mean()
    m = sample_mask.float()
    return (per_sample * m).sum() / torch.clamp(m.sum(), min=1.0)


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    label_smoothing: float = 0.0,
    class_weights: Optional[torch.Tensor] = None,
    sample_mask: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """The mean loss; with class weights normalised by the sum of the kept
    rows' weights, as torch's CrossEntropyLoss(weight=...). ``reduction="none"``:
    each row's loss (times its class weight and its mask)."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    targets = F.one_hot(labels.long(), num_classes).float()
    if label_smoothing > 0:
        targets = targets * (1.0 - label_smoothing) + label_smoothing / num_classes
    per_sample = -(targets * logp).sum(dim=-1)
    if reduction not in ("mean", "none"):
        raise ValueError(f"reduction={reduction!r}: expected 'mean' or 'none'")
    if class_weights is not None:
        w = class_weights.float()[labels.long()]
        if sample_mask is not None:
            w = w * sample_mask.float()
        if reduction == "none":
            return per_sample * w
        return (per_sample * w).sum() / torch.clamp(w.sum(), min=1e-8)
    if reduction == "none":
        return per_sample if sample_mask is None else per_sample * sample_mask.float()
    return masked_mean(per_sample, sample_mask)


def ce_loss(logits, labels, *, label_smoothing: float = 0.02, class_weights=None, sample_mask=None,
            **_) -> torch.Tensor:
    """``training.loss.type: ce``: cross-entropy with label smoothing (0.02 by default)."""
    return cross_entropy(logits, labels, label_smoothing=label_smoothing, class_weights=class_weights,
                         sample_mask=sample_mask)


def focal_loss(logits, labels, *, gamma: float = 2.0, class_weights=None, sample_mask=None, **_) -> torch.Tensor:
    """``training.loss.type: focal``: the mean over the kept rows of (1 - pt)^gamma
    CE, with pt = exp(-CE) of the class-weighted, unsmoothed CE (``losses.py:102-108``)."""
    ce = cross_entropy(logits, labels, class_weights=class_weights, reduction="none")
    pt = torch.exp(-ce)
    return masked_mean(((1.0 - pt) ** gamma) * ce, sample_mask)


LOSSES = {"ce": ce_loss, "focal": focal_loss}


def supcon_loss(features: torch.Tensor, labels: torch.Tensor, temperature: float = 0.07,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Supervised contrastive loss (``losses.py:111-137``): cosine logits over
    ``temperature``, less their row max (no gradient through it); each row's
    mean log-probability of its same-label rows against all other rows.
    ``sample_mask`` removes padded rows from the positives and the denominator."""
    f = features.float()
    f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-12)
    logits = f @ f.T / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    labels = labels.reshape(-1, 1)
    n = logits.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=logits.device)
    valid = torch.ones(n, device=logits.device) if sample_mask is None else sample_mask.float()
    pair_valid = valid[:, None] * valid[None, :]
    mask = (labels == labels.T).float() * (1.0 - eye) * pair_valid
    exp_logits = torch.exp(logits) * (1.0 - eye) * pair_valid
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True) + 1e-8)
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / (mask.sum(dim=1) + 1e-8)
    return -(mean_log_prob_pos * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def kl_divergence(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """sum p (log p - log q), with p and q clamped to [eps, 1]."""
    p = torch.clamp(p.float(), eps, 1.0)
    q = torch.clamp(q.float(), eps, 1.0)
    return torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1)


def mp_loss(outputs: dict, labels: torch.Tensor, sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MIBF MP-Loss: 0.3 CE_img + 0.6 CE_txt + 1.1 mean(exp(symKL) * CE_joint)."""
    image_logits = outputs["image"].float()
    text_logits = outputs["text"].float()
    joint_logits = outputs["image_text"].float()
    p_img = torch.softmax(image_logits, dim=-1)
    p_txt = torch.softmax(text_logits, dim=-1)
    kl = 0.5 * (kl_divergence(p_img, p_txt) + kl_divergence(p_txt, p_img))
    kl = torch.clamp(torch.nan_to_num(kl, nan=0.0, posinf=10.0, neginf=0.0), 0.0, 10.0)
    image_loss = cross_entropy(image_logits, labels, sample_mask=sample_mask)
    text_loss = cross_entropy(text_logits, labels, sample_mask=sample_mask)
    joint_loss = cross_entropy(joint_logits, labels, sample_mask=sample_mask)  # a scalar, as the reference's
    weighted_joint = masked_mean(torch.exp(kl) * joint_loss, sample_mask)
    return 0.3 * image_loss + 0.6 * text_loss + 1.1 * weighted_joint


def mibf_loss(outputs: dict, labels: torch.Tensor, loss_class: str = "KL_loss",
              sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Loss-mode dispatch: "textimage_loss", "text_image_textimage_loss", else MP-Loss."""
    if loss_class == "textimage_loss":
        return cross_entropy(outputs["image_text"], labels, sample_mask=sample_mask)
    if loss_class == "text_image_textimage_loss":
        return (
            cross_entropy(outputs["image"], labels, sample_mask=sample_mask)
            + cross_entropy(outputs["text"], labels, sample_mask=sample_mask)
            + cross_entropy(outputs["image_text"], labels, sample_mask=sample_mask)
        )
    return mp_loss(outputs, labels, sample_mask=sample_mask)
