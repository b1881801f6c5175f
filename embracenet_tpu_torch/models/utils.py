"""Small model utilities (parity with `BIOINF_tesi/models/utils/utils.py`):
the port's own copy of ``embracenet_tpu/models/utils.py``.

Most of the reference's helpers live elsewhere here (metrics in ops/metrics,
EarlyStopping + weight_reset in training/engine, conv arithmetic in
ops/convmath; select_augmented_models is in the JAX package's
visual/report, not ported yet); this module keeps
the remaining odds and ends.
"""

from __future__ import annotations

import re

import numpy as np


def selection_probabilities(results: dict, cell_line: str, task: str,
                            batch_size: int) -> np.ndarray:
    """EmbraceNet selection probabilities from the two unimodal nets'
    average CV AUPRCs (`models/utils/utils.py:206-226`; defined but unused
    in the reference's final flow — the tuned scalar is used instead).

    -> [batch_size, 2] array of (FFNN, CNN) probabilities."""
    auprc_ffnn = results[cell_line][task]["FFNN"]["average_CV_AUPRC"]
    auprc_cnn = results[cell_line][task]["CNN"]["average_CV_AUPRC"]
    prob = np.asarray([auprc_ffnn, auprc_cnn], np.float32)
    return np.tile(prob, (batch_size, 1))


def get_single_model_params(params: dict) -> tuple[dict, dict]:
    """Split a multimodal checkpoint's params into per-branch dicts
    (`models/utils/utils.py:360-374` splits a merged dict by FFNN_/CNN_
    prefix; here branch params are already nested sub-pytrees)."""
    return params["ffnn"], params["cnn"]


def drop_last_layers(params: dict, network_type: str) -> dict:
    """Strip head params for branch transfer
    (`models/utils/utils.py:230-249`; referenced but commented out in the
    reference's EmbraceNet reload path)."""
    head_keys = {"w_head", "b_head", "w_fc1", "b_fc1", "w_fc2", "b_fc2"}
    if network_type not in ("FFNN", "CNN"):
        raise ValueError("network_type must be 'FFNN' or 'CNN'")
    return {k: v for k, v in params.items() if k not in head_keys}


_PARAM_LINE = re.compile(r"^\s*(\w+):\s*(.+?)\s*$")


def parse_printed_params(text: str) -> dict:
    """Parse an Optuna-style printed "Params:" block back into a dict
    (`visual/visual.py:408-453` ``parse_as_dict`` — used by the reference to
    repair checkpoints whose params were only captured in notebook output).
    Values are int/float/str coerced."""
    out = {}
    in_block = False
    for line in text.splitlines():
        if line.strip().startswith("Params:"):
            in_block = True
            continue
        if not in_block:
            continue
        m = _PARAM_LINE.match(line)
        if not m:
            break
        key, raw = m.groups()
        for cast in (int, float):
            try:
                out[key] = cast(raw)
                break
            except ValueError:
                continue
        else:
            out[key] = raw
    return out
