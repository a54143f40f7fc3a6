"""LM loss: softmax cross-entropy in float32 with a z-loss.

The port of ``repro.train.loss``: the same expressions and metric keys.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            z_loss_weight: float = 1e-4) -> Tuple[torch.Tensor, dict]:
    """logits (B,S,V); targets (B,S) int; mask (B,S) or None.

    Returns (scalar loss, metrics): the masked mean nll, the mean z-loss
    logz², the accuracy of the argmax and the mask's sum (``tokens``),
    floored at 1, which is each mean's denominator."""
    logits = logits.float()
    targets = targets.long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - tgt
    zl = logz.square()
    if mask is None:
        mask = torch.ones(targets.shape, device=logits.device)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss_nll = (nll * mask).sum() / denom
    loss_z = (zl * mask).sum() / denom
    loss = loss_nll + z_loss_weight * loss_z
    acc = ((torch.argmax(logits, -1) == targets) * mask).sum() / denom
    return loss, {"nll": loss_nll, "z_loss": loss_z, "accuracy": acc,
                  "tokens": denom}
