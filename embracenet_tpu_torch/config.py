"""Typed configuration and the hyperparameter search space *as data*.

The port's own copy of ``embracenet_tpu/config.py`` (the port imports
nothing from the JAX package); tests hold the two equal.

The reference embeds its search space imperatively in model constructors via
``trial.suggest_*`` calls (`BIOINF_tesi/models/FF_net.py:18-46`,
`models/CNN_net.py:26-57`, `models/EmbraceNetMultimodal.py:124-157`,
`models/ConcatNetMultimodal.py:42-60`, optimizer/lr/wd at
`models/utils/training_models.py:269-271`).  Declaring the identical menus as
data makes trials vmappable and the space serialisable/persistable.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# ---------------------------------------------------------------------------
# Search-space menus (exact reference values)
# ---------------------------------------------------------------------------

FFNN_MAX_LAYERS = 4
FFNN_WIDTH_MENUS: tuple[tuple[int, ...], ...] = (
    (32, 64, 128, 256),   # n_units_l0
    (16, 32, 64, 128),    # n_units_l1
    (4, 16, 32, 64),      # n_units_l2
    (4, 16, 32),          # n_units_l3
)
FFNN_DROPOUT_MENUS: tuple[tuple[float, ...], ...] = (
    (0.0, 0.2, 0.3, 0.4),  # l0  (i < 2)
    (0.0, 0.2, 0.3, 0.4),  # l1
    (0.0, 0.4, 0.5),       # l2  (i >= 2)
    (0.0, 0.4, 0.5),       # l3
)
FFNN_MAX_WIDTH = max(max(m) for m in FFNN_WIDTH_MENUS)  # 256

CNN_MAX_LAYERS = 4
CNN_CHANNEL_MENUS: tuple[tuple[int, ...], ...] = (
    (16, 32, 64),          # out_channels_l0
    (32, 64, 96),          # out_channels_l1
    (64, 96, 128, 256),    # out_channels_l2
    (128, 256, 512),       # out_channels_l3
)
CNN_KERNEL_MENU: tuple[int, ...] = (5, 11, 15)
CNN_MAX_KERNEL = max(CNN_KERNEL_MENU)
CNN_DROPOUT_MENUS: tuple[tuple[float, ...], ...] = (
    (0.0, 0.2, 0.3, 0.4),  # l0  (i < 1)
    (0.0, 0.4, 0.5),       # l1  (i >= 1)
    (0.0, 0.4, 0.5),       # l2
    (0.0, 0.4, 0.5),       # l3
)
CNN_MAX_CHANNELS = tuple(max(m) for m in CNN_CHANNEL_MENUS)  # (64, 96, 256, 512)
CNN_IN_CHANNELS = 4
CNN_HEAD_FC = (1000, 64)   # fixed FC sizes in headful CNN (CNN_net.py:72-74)

EMBRACE_SIZE_MENU: tuple[int, ...] = (512, 768, 1024)
EMBRACE_MAX_SIZE = max(EMBRACE_SIZE_MENU)
EMBRACE_MAX_POST_LAYERS = 2         # suggest_int("n_post_layers", 0, 2)
EMBRACE_POST_WIDTH_MENUS: tuple[tuple[int, ...], ...] = (
    (32, 64, 128, 256, 512),        # EMBRACENET_n_units_l0
    (16, 32, 64, 128, 256),         # EMBRACENET_n_units_l1
)
EMBRACE_POST_DROPOUT_MENU: tuple[float, ...] = (0.0, 0.2, 0.3, 0.5)

CONCAT_MAX_POST_LAYERS = 3          # suggest_int("CONCATNET_n_post_layers", 1, 3)
CONCAT_POST_WIDTH_MENUS: tuple[tuple[int, ...], ...] = (
    (512, 768, 1024),               # CONCATNET_n_units_l0
    (32, 64, 128, 256, 512),        # CONCATNET_n_units_l1
    (16, 32, 64, 128, 256),         # CONCATNET_n_units_l2
)
CONCAT_POST_DROPOUT_MENU: tuple[float, ...] = (0.0, 0.2, 0.3, 0.5)

CNN_LSTM_MAX_LAYERS = 2             # CNN_LSTM_net.py:25 (1-2 conv blocks)
CNN_LSTM_HIDDEN_MENU: tuple[int, ...] = (32, 64, 128)
CNN_LSTM_MAX_LSTM_LAYERS = 2

OPTIMIZER_MENU: tuple[str, ...] = ("Nadam", "Adam", "RMSprop")
LR_RANGE = (1e-5, 1e-1)             # loguniform
WEIGHT_DECAY_RANGE = (1e-4, 1e-1)   # loguniform

MODALITY_DROPOUT_P = 0.5            # EmbraceNetMultimodal.py:178-182


# ---------------------------------------------------------------------------
# Experiment configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (defaults = reference defaults)."""
    num_epochs: int = 100
    patience: int = 4               # EarlyStopping patience (utils.py:23-67)
    delta: float = 0.0
    batch_size: int = 100           # train; test uses 2x (Kfold_CV:477)
    rebalance_threshold: float = 0.1
    auprc_on_probabilities: bool = False  # False = reference argmax quirk
    compute_dtype: str = "float32"  # "bfloat16" for matrix-unit speed
    seed: int = 789                 # Kfold_CV random_state default
    epoch_chunk: int = 10           # epochs per device call (dispatch batching)
    fused_embrace: bool | None = None  # run EmbraceNet docking + stochastic
    #                                 embracement as one fused kernel
    #                                 (ops/embrace.py); same distribution,
    #                                 different RNG stream.  Only False
    #                                 turns it off (the unfused path); the
    #                                 default stays None, as in the JAX
    #                                 config, whose automatic rule was tuned
    #                                 on its own hardware and is not
    #                                 carried over: here None is on, as in
    #                                 serving
    width_buckets: bool = False     # slice supernet weights to the
    #                                 population's per-layer width maxima
    #                                 (exact; big FLOP cut when trials are
    #                                 narrow) at the cost of one compiled
    #                                 program per distinct width signature —
    #                                 see modelspec statics / models/cnn.py
    pipeline_chunks: bool = False   # dispatch epoch chunk k+1 before
    #                                 fetching chunk k's metrics: the device
    #                                 pipeline never drains at chunk
    #                                 boundaries.  Host early-exit/pruning bookkeeping
    #                                 lags one chunk, so at most one chunk
    #                                 of frozen-trial compute is wasted when
    #                                 every trial early-stops; numerics are
    #                                 identical (device-side ES gates
    #                                 training either way)
    optim_dtype: str = "float32"    # "bfloat16": store the optimizer moments
    #                                 (m, v) bf16 — halves their HBM bytes;
    #                                 update math stays f32 (ops/optim.py)
    param_dtype: str = "float32"    # "bfloat16": live params stored bf16
    #                                 (fwd/bwd stream 2 B/param) with an f32
    #                                 master copy in the optimizer state as
    #                                 the source of truth; FitResult.params
    #                                 returns the f32 master
    eval_reshuffle: bool = False    # strict parity: reference's test loader
    #                                 reshuffles EVERY epoch (DataLoader
    #                                 shuffle=True, training_models.py:477);
    #                                 default keeps one static eval order
    #                                 (only batch-mean metric aggregation is
    #                                 composition-sensitive)


@dataclasses.dataclass(frozen=True)
class CVConfig:
    n_folds: int = 3
    n_trials: int = 3               # Param_Search n_trials (Kfold_CV:502)
    sampler: str = "TPE"            # 'TPE' | 'random' | 'BO'
    type_augm_genfeatures: str = "smote"   # 'smote' | 'double'
    augmentation: bool = False      # multimodal augmentation path
    fuse_folds: bool | None = None  # train ALL folds' HPO populations (and
    #                                 all retrains) as single fused vmapped
    #                                 programs over fold-concatenated data:
    #                                 2 device programs per CV instead of
    #                                 2*n_folds, and a 3x wider trial axis
    #                                 for the mesh to shard.  Per-trial RNG
    #                                 is pinned to the sequential streams.
    #                                 None = auto: on under a mesh (the wide
    #                                 trial axis is what the mesh shards),
    #                                 off single-device.  Explicit False always wins —
    #                                 the sequential per-fold path remains
    #                                 reachable for debugging under a mesh


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh: trials x data-parallel shards."""
    trial_axis: int = 1
    data_axis: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    cell_line: str = "K562"
    task: str = "active_P_vs_inactive_P"
    model: str = "FFNN"             # FFNN|CNN|EmbraceNetMultimodal|ConcatNetMultimodal
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    cv: CVConfig = dataclasses.field(default_factory=CVConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def menu_index(menu: Sequence, value) -> int:
    return list(menu).index(value)
