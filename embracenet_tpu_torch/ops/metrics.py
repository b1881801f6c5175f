"""Classification metrics as masked torch ops (port of
``embracenet_tpu/ops/metrics.py``).

The reference computes AUPRC as ``average_precision_score(target,
argmax(output))`` (`BIOINF_tesi/models/utils/utils.py:80-86`): average
precision of the *hard* argmax prediction.  With binary scores AP collapses
to ``P1 * R1 + prevalence * (1 - R1)`` (0 when there are no positives, the
reference's NaN -> 0).  :func:`auprc_prob` is the probability-based
variant.  Every metric takes an optional row ``mask``.
"""

from __future__ import annotations

import torch


def _f32(x):
    return torch.as_tensor(x).float()


def _mask(mask, like):
    return torch.ones_like(like) if mask is None else _f32(mask)


def _counts(pred, target, mask):
    pred, target = _f32(pred), _f32(target)
    mask = _mask(mask, target)
    tp = (pred * target * mask).sum()
    fp = (pred * (1.0 - target) * mask).sum()
    fn = ((1.0 - pred) * target * mask).sum()
    tn = ((1.0 - pred) * (1.0 - target) * mask).sum()
    return tp, fp, fn, tn


def _safe_div(num, den, cond):
    return torch.where(cond, num / torch.clamp(den, min=1.0), torch.zeros_like(num))


def auprc_argmax(logits, target, mask=None):
    """Reference-parity AUPRC on argmax predictions."""
    return auprc_from_binary_pred(torch.argmax(_f32(logits), dim=-1), target, mask)


def auprc_from_binary_pred(pred, target, mask=None):
    tp, fp, fn, tn = _counts(pred, target, mask)
    n_pos = tp + fn
    n_tot = tp + fp + fn + tn
    prevalence = _safe_div(n_pos, n_tot, n_tot > 0)
    p1 = _safe_div(tp, tp + fp, tp + fp > 0)
    r1 = _safe_div(tp, n_pos, n_pos > 0)
    ap = p1 * r1 + prevalence * (1.0 - r1)
    return torch.where(n_pos > 0, ap, torch.zeros_like(ap))


def auprc_prob(scores, target, mask=None):
    """Average precision from continuous scores (sklearn's step form: one
    point per distinct score)."""
    scores, target = _f32(scores), _f32(target)
    mask = _mask(mask, target)
    neg_inf = torch.finfo(torch.float32).min
    s = torch.where(mask > 0, scores, torch.full_like(scores, neg_inf))
    order = torch.argsort(-s, stable=True)
    t_sorted = (target * mask)[order]
    m_sorted = mask[order]
    tp_cum = torch.cumsum(t_sorted, 0)
    pp_cum = torch.cumsum(m_sorted, 0)
    n_pos = (target * mask).sum()
    precision = tp_cum / torch.clamp(pp_cum, min=1.0)
    recall = tp_cum / torch.clamp(n_pos, min=1.0)
    s_sorted = s[order]
    next_s = torch.cat([s_sorted[1:], torch.full((1,), neg_inf, device=s.device)])
    is_boundary = (s_sorted != next_s) & (m_sorted > 0)
    r_at_bounds = torch.where(is_boundary, recall, torch.zeros_like(recall))
    r_prev_bound = torch.cat([torch.zeros(1, device=s.device),
                              torch.cummax(r_at_bounds, 0).values[:-1]])
    contrib = torch.where(is_boundary, precision * (recall - r_prev_bound),
                          torch.zeros_like(recall))
    ap = contrib.sum()
    return torch.where(n_pos > 0, ap, torch.zeros_like(ap))


def auroc(scores, target, mask=None):
    """Area under the ROC curve: P(score_pos > score_neg) with 0.5 credit
    for ties (tie-averaged ranks), as sklearn's ``roc_auc_score``."""
    scores, target = _f32(scores), _f32(target)
    mask = _mask(mask, target)
    neg_inf = torch.finfo(torch.float32).min
    s = torch.where(mask > 0, scores, torch.full_like(scores, neg_inf))
    n = s.shape[0]
    order = torch.argsort(s, stable=True)
    s_sorted = s[order]
    pos = torch.arange(n, dtype=torch.float32, device=s.device)
    nan = torch.full((1,), float("nan"), device=s.device)
    is_run_start = s_sorted != torch.cat([nan, s_sorted[:-1]])
    run_first = torch.cummax(torch.where(is_run_start, pos, torch.full_like(pos, -1.0)),
                             0).values
    is_run_end = s_sorted != torch.cat([s_sorted[1:], nan])
    neg_pos = torch.where(is_run_end, -pos, torch.full_like(pos, -float("inf")))
    run_last = -torch.cummax(neg_pos.flip(0), 0).values.flip(0)
    avg_rank_sorted = (run_first + run_last) / 2.0 + 1.0
    ranks = torch.zeros_like(s)
    ranks[order] = avg_rank_sorted
    n_pos = (target * mask).sum()
    n_neg = ((1.0 - target) * mask).sum()
    denom = torch.clamp(n_pos * n_neg, min=1.0)
    auc = ((ranks * target * mask).sum() - n_pos * (n_pos + 1) / 2) / denom
    # masked rows take the lowest ranks, shifting every real rank up by
    # n_masked; correct the positive rank sum for it
    auc = auc - (1.0 - mask).sum() * n_pos / denom
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.zeros_like(auc))


def f1_precision_recall(logits, target, mask=None):
    """Macro precision/recall/F1 with ``zero_division=0``
    (`models/utils/utils.py:89-94`) -> tensor ``[precision, recall, f1]``."""
    pred = torch.argmax(_f32(logits), dim=-1)
    tp, fp, fn, tn = _counts(pred, target, mask)

    def _prf(tp_, fp_, fn_):
        prec = _safe_div(tp_, tp_ + fp_, tp_ + fp_ > 0)
        rec = _safe_div(tp_, tp_ + fn_, tp_ + fn_ > 0)
        f1 = torch.where(prec + rec > 0,
                         2 * prec * rec / torch.clamp(prec + rec, min=1e-30),
                         torch.zeros_like(prec))
        return prec, rec, f1

    p1, r1, f1_1 = _prf(tp, fp, fn)
    p0, r0, f1_0 = _prf(tn, fn, fp)
    return torch.stack([(p0 + p1) / 2, (r0 + r1) / 2, (f1_0 + f1_1) / 2])


def accuracy(logits, target, mask=None):
    """`models/utils/utils.py:71-77` parity."""
    pred = torch.argmax(_f32(logits), dim=-1)
    correct = (pred == torch.as_tensor(target)).float()
    if mask is None:
        return correct.mean()
    mask = _f32(mask)
    return (correct * mask).sum() / torch.clamp(mask.sum(), min=1.0)
