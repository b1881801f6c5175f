"""Loss functions with reference (torch) parity semantics (port of
``embracenet_tpu/ops/losses.py``).

The reference rebuilds a class-weighted ``nn.CrossEntropyLoss`` per batch
with Inverse-Number-of-Samples weights normalised over the two classes
(`BIOINF_tesi/models/utils/utils.py:121-140`,
`models/utils/training_models.py:107-108`).  Torch's weighted CE divides by
the sum of the weights of the realised targets, not the batch size; a
padding mask extends it so a padded batch gives the ragged batch's value.
For a ``shard`` of a data-sharded batch (``parallel.mesh.BatchShard``) the
class counts and the normaliser are sums over the data axis, so each
shard's loss is its share of the whole batch's and the shards' losses sum
to it.  A population's losses come at once: ``[T, B]`` rows give ``[T]``
losses, each over its trial's rows (autograd differentiates their sum, so
each trial's gradient is its own).
"""

from __future__ import annotations

import torch


def ins_weights(target, mask=None, shard=None):
    """Normalised inverse-number-of-samples weights ``(w_pos, w_neg)``
    (`models/utils/utils.py:121-140`), of the whole batch for a ``shard``."""
    target = torch.as_tensor(target).float()
    mask = torch.ones_like(target) if mask is None else torch.as_tensor(mask).float()
    pos = (target * mask).sum(-1)
    neg = ((1.0 - target) * mask).sum(-1)
    if shard is not None:
        pos, neg = shard.sum(pos, neg)
    zero = torch.zeros_like(pos)
    pos_inv = torch.where(pos > 0, 1.0 / torch.clamp(pos, min=1.0), zero)
    neg_inv = torch.where(neg > 0, 1.0 / torch.clamp(neg, min=1.0), zero)
    denom = torch.clamp(pos_inv + neg_inv, min=1e-30)
    return pos_inv / denom, neg_inv / denom


def weighted_cross_entropy(logits, target, mask=None, class_weights=None,
                           shard=None):
    """``sum_i w[y_i] * nll_i / sum_i w[y_i]`` over unmasked rows (torch
    ``CrossEntropyLoss(weight=...)``, ``reduction='mean'``); per-batch INS
    weights when ``class_weights`` is None, else ``(w_neg, w_pos)``.  Over
    the last row axis: ``[T, B]`` targets give one loss per trial."""
    target = torch.as_tensor(target).long()
    mask = (torch.ones(target.shape, device=target.device) if mask is None
            else torch.as_tensor(mask).float())
    if class_weights is None:
        w_pos, w_neg = ins_weights(target, mask, shard)
    else:
        w_neg, w_pos = class_weights  # torch order: weight=[w_neg, w_pos]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    w = torch.where(target == 1, w_pos[..., None], w_neg[..., None]) * mask
    total = w.sum(-1) if shard is None else shard.sum(w.sum(-1))
    return (w * nll).sum(-1) / torch.clamp(total, min=1e-30)
