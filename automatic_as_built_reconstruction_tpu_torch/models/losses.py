"""Detection losses: pure functions and thin class wrappers, in torch.

The port of the JAX package's ``models/losses.py``: the sigmoid focal loss
(:20), the weighted smooth-L1 (:44), the weighted softmax cross entropy of
the direction head (:64) and ``prepare_loss_weights`` (:77), formula for
formula.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _sigmoid_cross_entropy_with_logits(logits, labels):
    """Numerically stable elementwise sigmoid CE."""
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


@dataclasses.dataclass
class SigmoidFocalClassificationLoss:
    """Focal loss (RetinaNet): FL = alpha_t * (1 - p_t)^gamma * CE."""

    gamma: float = 2.0
    alpha: Optional[float] = 0.25

    def __call__(self, prediction_tensor, target_tensor, weights):
        """[.., A, C] logits and one-hot targets; weights [.., A]."""
        per_entry_ce = _sigmoid_cross_entropy_with_logits(
            prediction_tensor, target_tensor)
        p = torch.sigmoid(prediction_tensor)
        p_t = target_tensor * p + (1 - target_tensor) * (1 - p)
        modulating = (torch.pow(1.0 - p_t, self.gamma) if self.gamma
                      else 1.0)
        if self.alpha is not None:
            alpha_w = (target_tensor * self.alpha
                       + (1 - target_tensor) * (1 - self.alpha))
        else:
            alpha_w = 1.0
        loss = modulating * alpha_w * per_entry_ce
        return loss * weights[..., None]


@dataclasses.dataclass
class WeightedSmoothL1LocalizationLoss:
    """Huber loss with transition at 1/sigma^2; optional per-dim codewise
    weights."""

    sigma: float = 3.0
    code_weights: Optional[Tuple[float, ...]] = None

    def __call__(self, prediction_tensor, target_tensor, weights):
        """[.., A, code] preds/targets; weights [.., A]."""
        diff = prediction_tensor - target_tensor
        if self.code_weights is not None:
            diff = diff * torch.as_tensor(self.code_weights, dtype=diff.dtype,
                                          device=diff.device)
        abs_diff = torch.abs(diff)
        s2 = self.sigma**2
        lt = abs_diff < (1.0 / s2)
        loss = torch.where(lt, 0.5 * s2 * diff**2, abs_diff - 0.5 / s2)
        return loss * weights[..., None]


@dataclasses.dataclass
class WeightedSoftmaxClassificationLoss:
    """Softmax CE for the direction classifier head."""

    logit_scale: float = 1.0

    def __call__(self, prediction_tensor, target_tensor, weights):
        """[.., A, C] logits, [.., A, C] one-hot, weights [.., A]."""
        logits = prediction_tensor / self.logit_scale
        log_probs = torch.log_softmax(logits, dim=-1)
        ce = -torch.sum(target_tensor * log_probs, dim=-1)
        return ce * weights


def prepare_loss_weights(labels, pos_cls_weight: float = 1.0,
                         neg_cls_weight: float = 1.0,
                         loss_norm_type: str = "NormByNumPositives",
                         dtype=torch.float32):
    """Per-anchor cls/reg weights from labels [B, A] -> (cls_weights,
    reg_weights, cared)."""
    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    cls_weights = (negatives.to(dtype) * neg_cls_weight
                   + positives.to(dtype) * pos_cls_weight)
    reg_weights = positives.to(dtype)
    if loss_norm_type == "NormByNumPositives":
        pos_norm = torch.clamp_min(
            positives.sum(dim=1, keepdim=True).to(dtype), 1.0)
        reg_weights = reg_weights / pos_norm
        cls_weights = cls_weights / pos_norm
    elif loss_norm_type == "NormByNumExamples":
        num_examples = torch.clamp_min(
            cared.sum(dim=1, keepdim=True).to(dtype), 1.0)
        cls_weights = cls_weights / num_examples
        pos_norm = torch.clamp_min(
            positives.sum(dim=1, keepdim=True).to(dtype), 1.0)
        reg_weights = reg_weights / pos_norm
    elif loss_norm_type == "NormByNumPosNeg":
        pos_neg = torch.stack([positives.to(dtype), negatives.to(dtype)],
                              dim=-1)
        normalizer = pos_neg.sum(1, keepdim=True)  # [B, 1, 2]
        cls_normalizer = (pos_neg * normalizer).sum(-1)
        cls_normalizer = torch.clamp_min(cls_normalizer, 1.0)
        normalizer = torch.clamp_min(normalizer, 1.0)
        reg_weights = reg_weights / normalizer[:, 0:1, 0]
        cls_weights = cls_weights / cls_normalizer
    elif loss_norm_type == "DontNorm":
        pass
    else:
        raise ValueError(f"unknown loss_norm_type {loss_norm_type}")
    return cls_weights, reg_weights, cared
