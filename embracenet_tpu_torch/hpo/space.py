"""Search spaces as data + flat-params <-> supernet-hyperparam conversion.

The port's own copy of ``embracenet_tpu/hpo/space.py``; tests hold the two
equal.

Flat parameter names mirror the reference's Optuna studies exactly
(the reference's ``BIOINF_optuna_tuning.db``): ``n_layers``, ``n_units_l{i}``,
``dropout_l{i}``, ``out_channels_l{i}``, ``kernel_size_l{i}``, ``optimizer``,
``lr``, ``weight_decay``; multimodal variants carry ``FFNN_``/``CNN_``
prefixes plus ``EMBRACENET_embracement_size``, ``n_post_layers``,
``EMBRACENET_n_units_l{i}``, ``EMBRACENET_dropout_l{i}``,
``selection_probabilities_FFNN`` and ``CONCATNET_*``
(`models/*.py` suggest_* calls).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from embracenet_tpu_torch import config as C

ADAM, NADAM, RMSPROP = 0, 1, 2
#: optimizer name -> id (the JAX package's ``ops/optim.py`` numbering)
OPTIMIZER_IDS = {"Adam": ADAM, "Nadam": NADAM, "RMSprop": RMSPROP}


@dataclasses.dataclass(frozen=True)
class Categorical:
    choices: tuple

    def sample(self, rng: np.random.Generator):
        return self.choices[int(rng.integers(len(self.choices)))]


@dataclasses.dataclass(frozen=True)
class IntUniform:
    low: int
    high: int  # inclusive (optuna suggest_int semantics)

    def sample(self, rng: np.random.Generator):
        return int(rng.integers(self.low, self.high + 1))


@dataclasses.dataclass(frozen=True)
class LogUniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator):
        return float(math.exp(rng.uniform(math.log(self.low), math.log(self.high))))


@dataclasses.dataclass(frozen=True)
class FloatUniform:
    low: float
    high: float

    def sample(self, rng: np.random.Generator):
        return float(rng.uniform(self.low, self.high))


def _ffnn_space(prefix: str = "") -> dict[str, Any]:
    s: dict[str, Any] = {f"{prefix}n_layers": IntUniform(1, C.FFNN_MAX_LAYERS)}
    for i in range(C.FFNN_MAX_LAYERS):
        s[f"{prefix}n_units_l{i}"] = Categorical(C.FFNN_WIDTH_MENUS[i])
        s[f"{prefix}dropout_l{i}"] = Categorical(C.FFNN_DROPOUT_MENUS[i])
    return s


def _cnn_space(prefix: str = "") -> dict[str, Any]:
    s: dict[str, Any] = {f"{prefix}n_layers": IntUniform(1, C.CNN_MAX_LAYERS)}
    for i in range(C.CNN_MAX_LAYERS):
        s[f"{prefix}out_channels_l{i}"] = Categorical(C.CNN_CHANNEL_MENUS[i])
        s[f"{prefix}kernel_size_l{i}"] = Categorical(C.CNN_KERNEL_MENU)
        s[f"{prefix}dropout_l{i}"] = Categorical(C.CNN_DROPOUT_MENUS[i])
    return s


def _optimizer_space() -> dict[str, Any]:
    return {
        "optimizer": Categorical(C.OPTIMIZER_MENU),
        "lr": LogUniform(*C.LR_RANGE),
        "weight_decay": LogUniform(*C.WEIGHT_DECAY_RANGE),
    }


def _cnn_lstm_space() -> dict[str, Any]:
    """CNN_LSTM_net.py:25-72: 1-2 conv blocks + tuned LSTM."""
    s: dict[str, Any] = {"n_layers": IntUniform(1, C.CNN_LSTM_MAX_LAYERS)}
    for i in range(C.CNN_LSTM_MAX_LAYERS):
        s[f"out_channels_l{i}"] = Categorical(C.CNN_CHANNEL_MENUS[i])
        s[f"kernel_size_l{i}"] = Categorical(C.CNN_KERNEL_MENU)
        s[f"dropout_l{i}"] = Categorical(C.CNN_DROPOUT_MENUS[i])
    s["LSTM_hidden_layer_size"] = Categorical(C.CNN_LSTM_HIDDEN_MENU)
    s["LSTM_n_layers"] = IntUniform(1, C.CNN_LSTM_MAX_LSTM_LAYERS)
    return s


def model_space(model: str) -> dict[str, Any]:
    """Full search space (architecture + optimizer) for a model family."""
    if model == "FFNN":
        return {**_ffnn_space(), **_optimizer_space()}
    if model == "CNN":
        return {**_cnn_space(), **_optimizer_space()}
    if model == "CNN_LSTM":
        return {**_cnn_lstm_space(), **_optimizer_space()}
    if model == "EmbraceNetMultimodal":
        s = {**_ffnn_space("FFNN_"), **_cnn_space("CNN_")}
        s["EMBRACENET_embracement_size"] = Categorical(C.EMBRACE_SIZE_MENU)
        s["n_post_layers"] = IntUniform(0, C.EMBRACE_MAX_POST_LAYERS)
        for i in range(C.EMBRACE_MAX_POST_LAYERS):
            s[f"EMBRACENET_n_units_l{i}"] = Categorical(C.EMBRACE_POST_WIDTH_MENUS[i])
            s[f"EMBRACENET_dropout_l{i}"] = Categorical(C.EMBRACE_POST_DROPOUT_MENU)
        s["selection_probabilities_FFNN"] = FloatUniform(0.0, 1.0)
        return {**s, **_optimizer_space()}
    if model == "ConcatNetMultimodal":
        s = {**_ffnn_space("FFNN_"), **_cnn_space("CNN_")}
        s["CONCATNET_n_post_layers"] = IntUniform(1, C.CONCAT_MAX_POST_LAYERS)
        for i in range(C.CONCAT_MAX_POST_LAYERS):
            s[f"CONCATNET_n_units_l{i}"] = Categorical(C.CONCAT_POST_WIDTH_MENUS[i])
            s[f"CONCATNET_dropout_l{i}"] = Categorical(C.CONCAT_POST_DROPOUT_MENU)
        return {**s, **_optimizer_space()}
    raise ValueError(f"unknown model family: {model}")


# ---------------------------------------------------------------------------
# flat params -> supernet hyperparameter pytrees (numpy; stack for vmap)
# ---------------------------------------------------------------------------

def _ffnn_hp(params: dict, prefix: str = "") -> dict:
    return {
        "n_layers": np.int32(params[f"{prefix}n_layers"]),
        "widths": np.asarray(
            [params.get(f"{prefix}n_units_l{i}", C.FFNN_WIDTH_MENUS[i][0])
             for i in range(C.FFNN_MAX_LAYERS)], np.int32),
        "dropout": np.asarray(
            [params.get(f"{prefix}dropout_l{i}", 0.0)
             for i in range(C.FFNN_MAX_LAYERS)], np.float32),
    }


def _cnn_hp(params: dict, prefix: str = "") -> dict:
    return {
        "n_layers": np.int32(params[f"{prefix}n_layers"]),
        "channels": np.asarray(
            [params.get(f"{prefix}out_channels_l{i}", C.CNN_CHANNEL_MENUS[i][0])
             for i in range(C.CNN_MAX_LAYERS)], np.int32),
        "kernels": np.asarray(
            [params.get(f"{prefix}kernel_size_l{i}", C.CNN_KERNEL_MENU[0])
             for i in range(C.CNN_MAX_LAYERS)], np.int32),
        "dropout": np.asarray(
            [params.get(f"{prefix}dropout_l{i}", 0.0)
             for i in range(C.CNN_MAX_LAYERS)], np.float32),
    }


def optimizer_hp(params: dict) -> dict:
    return {
        "optimizer": np.int32(OPTIMIZER_IDS[params["optimizer"]]),
        "lr": np.float32(params["lr"]),
        "weight_decay": np.float32(params["weight_decay"]),
    }


def params_to_hp(model: str, params: dict) -> dict:
    """Convert flat (reference-named) params to the supernet hp pytree."""
    if model == "FFNN":
        return _ffnn_hp(params)
    if model == "CNN":
        return _cnn_hp(params)
    if model == "CNN_LSTM":
        return {
            "n_layers": np.int32(params["n_layers"]),
            "channels": np.asarray(
                [params.get(f"out_channels_l{i}", C.CNN_CHANNEL_MENUS[i][0])
                 for i in range(C.CNN_LSTM_MAX_LAYERS)], np.int32),
            "kernels": np.asarray(
                [params.get(f"kernel_size_l{i}", C.CNN_KERNEL_MENU[0])
                 for i in range(C.CNN_LSTM_MAX_LAYERS)], np.int32),
            "dropout": np.asarray(
                [params.get(f"dropout_l{i}", 0.0)
                 for i in range(C.CNN_LSTM_MAX_LAYERS)], np.float32),
            "lstm_hidden": np.int32(params["LSTM_hidden_layer_size"]),
            "lstm_layers": np.int32(params["LSTM_n_layers"]),
        }
    if model == "EmbraceNetMultimodal":
        return {
            "ffnn": _ffnn_hp(params, "FFNN_"),
            "cnn": _cnn_hp(params, "CNN_"),
            "embrace_size": np.int32(params["EMBRACENET_embracement_size"]),
            "n_post": np.int32(params["n_post_layers"]),
            "post_widths": np.asarray(
                [params.get(f"EMBRACENET_n_units_l{i}",
                            C.EMBRACE_POST_WIDTH_MENUS[i][0])
                 for i in range(C.EMBRACE_MAX_POST_LAYERS)], np.int32),
            "post_dropout": np.asarray(
                [params.get(f"EMBRACENET_dropout_l{i}", 0.0)
                 for i in range(C.EMBRACE_MAX_POST_LAYERS)], np.float32),
            "p_ffnn": np.float32(params["selection_probabilities_FFNN"]),
        }
    if model == "ConcatNetMultimodal":
        return {
            "ffnn": _ffnn_hp(params, "FFNN_"),
            "cnn": _cnn_hp(params, "CNN_"),
            "n_post": np.int32(params["CONCATNET_n_post_layers"]),
            "post_widths": np.asarray(
                [params.get(f"CONCATNET_n_units_l{i}",
                            C.CONCAT_POST_WIDTH_MENUS[i][0])
                 for i in range(C.CONCAT_MAX_POST_LAYERS)], np.int32),
            "post_dropout": np.asarray(
                [params.get(f"CONCATNET_dropout_l{i}", 0.0)
                 for i in range(C.CONCAT_MAX_POST_LAYERS)], np.float32),
        }
    raise ValueError(f"unknown model family: {model}")


def sample_params(model: str, rng: np.random.Generator) -> dict:
    """Random draw of a full flat param dict (RandomSampler equivalent)."""
    return {name: dist.sample(rng) for name, dist in model_space(model).items()}
