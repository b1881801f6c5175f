"""Serving entry points (port of ``predict`` / ``evaluate`` from
``embracenet_tpu/api.py``).

  >>> import embracenet_tpu_torch as et
  >>> probs = et.predict("models/K562_EmbraceNetMultimodal_..._test_", data)
  >>> metrics = et.evaluate("models/...", data)

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from embracenet_tpu_torch.models.reload import load_model
from embracenet_tpu_torch.training.results import baseline_auprc


def predict(checkpoint_path: str, data: dict,
            in_features_ffnn: int | None = None, device=None,
            fused_embrace: bool = True) -> np.ndarray:
    """Class probabilities [N, 2] from a saved checkpoint (the reference's
    ``*_NoTrain`` reload flow, softmax output)."""
    return load_model(checkpoint_path, in_features_ffnn, device=device,
                      fused_embrace=fused_embrace)(data)


def evaluate(checkpoint_path: str, data: dict,
             in_features_ffnn: int | None = None,
             auprc_on_probabilities: bool = False, device=None,
             fused_embrace: bool = True) -> dict:
    """AUPRC / AUROC / F1 / precision / recall / accuracy of a checkpoint."""
    from embracenet_tpu_torch.ops import metrics as M

    probs = predict(checkpoint_path, data, in_features_ffnn, device=device,
                    fused_embrace=fused_embrace)
    y = torch.as_tensor(np.asarray(data["y"]))
    probs_t = torch.from_numpy(probs)
    logits = torch.log(torch.clamp(probs_t, min=1e-30))
    if auprc_on_probabilities:
        auprc = float(M.auprc_prob(probs_t[:, 1], y))
    else:
        auprc = float(M.auprc_argmax(logits, y))
    prf = M.f1_precision_recall(logits, y)
    return {
        "AUPRC": auprc,
        "AUROC": float(M.auroc(probs_t[:, 1], y)),
        "precision": float(prf[0]),
        "recall": float(prf[1]),
        "F1": float(prf[2]),
        "accuracy": float(M.accuracy(logits, y)),
        "baseline_AUPRC": baseline_auprc(np.asarray(data["y"])),
    }
