"""Loss functions with reference (torch) parity semantics (port of
``embracenet_tpu/ops/losses.py``).

The reference rebuilds a class-weighted ``nn.CrossEntropyLoss`` per batch
with Inverse-Number-of-Samples weights normalised over the two classes
(`BIOINF_tesi/models/utils/utils.py:121-140`,
`models/utils/training_models.py:107-108`).  Torch's weighted CE divides by
the sum of the weights of the realised targets, not the batch size; a
padding mask extends it so a padded batch gives the ragged batch's value.
"""

from __future__ import annotations

import torch


def ins_weights(target, mask=None):
    """Normalised inverse-number-of-samples weights ``(w_pos, w_neg)``
    (`models/utils/utils.py:121-140`)."""
    target = torch.as_tensor(target).float()
    mask = torch.ones_like(target) if mask is None else torch.as_tensor(mask).float()
    pos = (target * mask).sum()
    neg = ((1.0 - target) * mask).sum()
    zero = torch.zeros_like(pos)
    pos_inv = torch.where(pos > 0, 1.0 / torch.clamp(pos, min=1.0), zero)
    neg_inv = torch.where(neg > 0, 1.0 / torch.clamp(neg, min=1.0), zero)
    denom = torch.clamp(pos_inv + neg_inv, min=1e-30)
    return pos_inv / denom, neg_inv / denom


def weighted_cross_entropy(logits, target, mask=None, class_weights=None):
    """``sum_i w[y_i] * nll_i / sum_i w[y_i]`` over unmasked rows (torch
    ``CrossEntropyLoss(weight=...)``, ``reduction='mean'``); per-batch INS
    weights when ``class_weights`` is None, else ``(w_neg, w_pos)``."""
    target = torch.as_tensor(target).long()
    mask = (torch.ones(target.shape, device=target.device) if mask is None
            else torch.as_tensor(mask).float())
    if class_weights is None:
        w_pos, w_neg = ins_weights(target, mask)
    else:
        w_neg, w_pos = class_weights  # torch order: weight=[w_neg, w_pos]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    w = torch.where(target == 1, w_pos, w_neg) * mask
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-30)
