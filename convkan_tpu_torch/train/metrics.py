"""On-device classification metrics, port of ``cross_entropy_loss``,
``confusion_matrix`` and ``accuracy_from_cm`` of
``convkan_tpu/train/metrics.py``."""

from __future__ import annotations

import torch


def confusion_matrix(preds, targets, num_classes: int, weights=None):
    """(N,) int preds/targets -> (C, C) counts [true, pred]; ``weights``
    (e.g. a padded batch's mask) weight each sample's contribution."""
    idx = targets.long() * num_classes + preds.long()
    cm = torch.bincount(idx, weights=weights,
                        minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def accuracy_from_cm(cm):
    return torch.diagonal(cm).sum() / torch.clamp(cm.sum(), min=1)


def cross_entropy_loss(logits, targets, label_smoothing: float = 0.0):
    """Mean CE over the batch (torch nn.CrossEntropyLoss parity), with
    torch's label smoothing: (1-ls) * NLL(target) + ls * mean_c(-log p_c)."""
    logp = logits - logits.max(dim=-1, keepdim=True).values
    logp = logp - torch.log(torch.exp(logp).sum(dim=-1, keepdim=True))
    nll = -logp.gather(-1, targets.long()[:, None])[:, 0]
    if label_smoothing:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll.mean()
