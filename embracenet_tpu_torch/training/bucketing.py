"""Population bucketing: split a trial population into width/depth groups
(port of ``embracenet_tpu/training/bucketing.py``).

The masked-supernet engine makes every trial of a population pay the
population's maximal FLOPs.  With width slicing (models/*.py ``*_max``
statics) a population costs its own per-layer maxima instead of the global
menu maxima, but one monster trial still taxes the whole group.  Splitting
the population into a few groups (each trained as its own fit, its supernet
sized to the group max) cuts FLOPs; the planner splits only when the
projected saving clears ``min_gain``, keeping the groups few.

Cost model: forward MACs/sample of the bucket's supernet (convs dominate).
Kernel choice is a *centered* weight mask (models/layers.py
kernel_tap_mask), so a bucket pays its own per-layer max kernel taps —
the planner is kernel-aware and groups small-kernel trials together.
"""

from __future__ import annotations

from itertools import combinations

from embracenet_tpu_torch.config import (
    CNN_HEAD_FC,
    CNN_IN_CHANNELS,
    CNN_MAX_KERNEL,
    FFNN_MAX_LAYERS,
)
from embracenet_tpu_torch.ops.convmath import CNN_LENGTHS


def _cnn_flops(statics) -> float:
    depth = statics["cnn_max_depth"]
    mc = statics["cnn_max_channels"]
    mk = statics.get("cnn_max_kernels",
                     (CNN_MAX_KERNEL,) * len(mc))
    total = 0.0
    for i in range(depth):
        c_in = CNN_IN_CHANNELS if i == 0 else mc[i - 1]
        l_in = 256 if i == 0 else CNN_LENGTHS[i - 1]
        total += l_in * c_in * mc[i] * mk[i]
    return total


def _flat_bucket(statics) -> int:
    depth = statics["cnn_max_depth"]
    mc = statics["cnn_max_channels"]
    return max(mc[i] * CNN_LENGTHS[i] for i in range(depth))


def _ffnn_flops(statics, in_features) -> float:
    w = statics["ffnn_max_width"]
    # the FFNN supernet computes all 4 layers (depth is pass-through select)
    return in_features * w + (FFNN_MAX_LAYERS - 1) * w * w


def flops_of_statics(model: str, statics: dict, in_features: int = 256) -> float:
    """Forward MACs/sample of a bucket's supernet (ranking cost model)."""
    if model == "FFNN":
        return _ffnn_flops(statics, in_features) + statics["ffnn_max_width"] * 2
    if model == "CNN":
        f1, f2 = CNN_HEAD_FC
        return (_cnn_flops(statics) + _flat_bucket(statics) * f1
                + f1 * f2 + f2 * 2)
    if model == "EmbraceNetMultimodal":
        eb, pb = statics["embrace_max"], statics["post_max"]
        return (_ffnn_flops(statics, in_features) + _cnn_flops(statics)
                + statics["ffnn_max_width"] * eb + _flat_bucket(statics) * eb
                + eb * pb + pb * pb + (eb + pb) * 2)
    if model == "ConcatNetMultimodal":
        pb = statics["post_max"]
        return (_ffnn_flops(statics, in_features) + _cnn_flops(statics)
                + (statics["ffnn_max_width"] + _flat_bucket(statics)) * pb
                + 2 * pb * pb + pb * 2)
    raise ValueError(f"no cost model for {model}")


def plan_buckets(spec, model: str, hp_list: list, max_groups: int = 3,
                 min_gain: float = 0.15, in_features: int = 256
                 ) -> list[list[int]]:
    """Partition trial indices into <= max_groups cost groups.

    Sorts trials by individual supernet cost, then searches contiguous
    splits exhaustively (populations are small) for the partition minimizing
    sum(|group| * flops(statics(group))).  Returns [range(n)] unless the
    best split saves at least ``min_gain`` of the single-group cost.
    """
    n = len(hp_list)
    if n <= 1 or spec.statics is None:
        return [list(range(n))]

    def group_cost(idxs):
        st = spec.statics([hp_list[i] for i in idxs])
        return len(idxs) * flops_of_statics(model, st, in_features)

    order = sorted(range(n), key=lambda i: flops_of_statics(
        model, spec.statics([hp_list[i]]), in_features))
    base = group_cost(order)
    best_cost, best_groups = base, [order]
    for k in range(2, min(max_groups, n) + 1):
        for cuts in combinations(range(1, n), k - 1):
            bounds = (0,) + cuts + (n,)
            groups = [order[bounds[j]:bounds[j + 1]] for j in range(k)]
            cost = sum(group_cost(g) for g in groups)
            if cost < best_cost:
                best_cost, best_groups = cost, groups
    if base - best_cost < min_gain * base:
        return [order]
    return best_groups
