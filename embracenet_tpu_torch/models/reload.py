"""Rebuild trained models from checkpoints for serving (port of
``embracenet_tpu/models/reload.py``, the reference's ``*_NoTrain`` classes).

The checkpoint's ``meta["model_params"]`` carries the flat hyperparameters;
:class:`ReloadedModel` applies the matching supernet in eval mode and
returns class probabilities (or raw logits).

The model lives on one explicit device (the card by default) and runs as
a population of one trial (``spec.apply_trials``; its hyperparameters are
stacked on the device once, so a request copies nothing but its data).
A request is the span ``reload.request``, with ``reload.copy_in``, one
``reload.microbatch`` a micro-batch and ``reload.copy_out`` inside it; the
counters ``reload.rows_real`` and ``reload.rows_run`` add its rows and the
rows it computes, padding included (``utils.profiling``).  For
EmbraceNetMultimodal, ``fused_embrace=True`` (the default) runs docking +
embracement in the fused CUDA kernel; ``fused_embrace=False`` keeps the
unfused path, the JAX package's serving default.

Stated divergence: eval mode still draws the stochastic embracement.  The
JAX package draws it with the fixed key ``PRNGKey(0)`` for every
micro-batch; here every micro-batch uses the same ``seed`` (0 by default)
for the Philox draw of the fused kernel or the ``torch.Generator`` of the
unfused path — same distribution, different RNG stream.  Predictions agree
with the JAX package exactly only where the draw cannot matter
(``selection_probabilities_FFNN`` 0 or 1).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from embracenet_tpu_torch import resolve_device
from embracenet_tpu_torch.convert import tree_map, tree_to_torch
from embracenet_tpu_torch.hpo import space as space_mod
from embracenet_tpu_torch.models.layers import Trials, stack_hps
from embracenet_tpu_torch.training.checkpoint import (_LIST_MARK, load_checkpoint,
                                                     restore_lists)
from embracenet_tpu_torch.training.modelspec import get_spec
from embracenet_tpu_torch.utils.profiling import annotate, count, spanned

_SEP = "__"  # buffer names may not contain "."


def _flat_items(tree, prefix=""):
    items = (tree.items() if isinstance(tree, dict)
             else ((f"{_LIST_MARK}{i}", v) for i, v in enumerate(tree)))
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from _flat_items(v, f"{prefix}{k}{_SEP}")
        else:
            yield f"{prefix}{k}", v


class ReloadedModel(nn.Module):
    #: inference micro-batch: bounds activation memory and keeps one shape
    #: for any dataset size (rows are padded up to a multiple of it)
    BATCH = 4096

    def __init__(self, model: str, params, bn_state, flat_params: dict,
                 in_features_ffnn: int | None = None, device=None,
                 compute_dtype=None, fused_embrace: bool = True, seed: int = 0):
        super().__init__()
        self.model = model
        self.device = resolve_device(device)
        self.spec = get_spec(model, in_features_ffnn=in_features_ffnn)
        self.flat_params = flat_params
        self.hp = space_mod.params_to_hp(model, flat_params)
        self.statics = self.spec.statics([self.hp]) if self.spec.statics else {}
        if model == "EmbraceNetMultimodal":
            self.statics["fused_embrace"] = bool(fused_embrace)
        self.compute_dtype = compute_dtype
        self.seed = int(seed)
        self.trials = Trials([self.hp], stack_hps([self.hp], self.device))
        # params and BN state as buffers ("params__ffnn__w0", ...), so
        # state_dict / .to() see them; the nested trees are rebuilt on use
        for group, tree in (("params", params), ("bn_state", bn_state or {})):
            for name, t in _flat_items(tree_to_torch(tree, self.device)):
                self.register_buffer(f"{group}{_SEP}{name}", t)

    def _tree(self, group: str) -> dict:
        out: dict = {}
        prefix = f"{group}{_SEP}"
        for name, t in self.named_buffers():
            if not name.startswith(prefix):
                continue
            parts = name[len(prefix):].split(_SEP)
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
        return restore_lists(out)

    @property
    def params(self) -> dict:
        return self._tree("params")

    @property
    def bn_state(self) -> dict:
        return self._tree("bn_state")

    def _device_data(self, data: dict, n_pad: int) -> dict:
        out = {}
        for key, dtype in (("ffnn", np.float32), ("cnn", np.uint8)):
            if key in self.spec.inputs:
                a = np.asarray(data[key], dtype)
                a = np.pad(a, [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
                out[key] = torch.from_numpy(a).to(self.device)
        return out

    @spanned("reload.request")
    @torch.inference_mode()
    def forward(self, data: dict, logits: bool = False) -> np.ndarray:
        """-> class probabilities [N, 2] (or raw logits), micro-batched; the
        dataset is copied to the device once and sliced there."""
        with annotate("reload.copy_in"):
            key = "ffnn" if "ffnn" in self.spec.inputs else "cnn"
            n = len(np.asarray(data[key]))
            n_pad = -(-max(n, 1) // self.BATCH) * self.BATCH
            dev = self._device_data(data, n_pad)
        count("reload.rows_real", n)
        count("reload.rows_run", n_pad)
        # a population of one: the trial axis is a view
        params, bn_state = (tree_map(lambda a: a[None], t)
                            for t in (self.params, self.bn_state))
        chunks = []
        for lo in range(0, n_pad, self.BATCH):
            with annotate("reload.microbatch"):
                inputs = {k: v[lo:lo + self.BATCH] for k, v in dev.items()}
                out, _ = self.spec.apply_trials(params, bn_state, self.trials,
                                                inputs, False, None,
                                                self.compute_dtype,
                                                self.statics, seed=self.seed)
                chunks.append(out[0])
        with annotate("reload.copy_out"):
            raw = torch.cat(chunks)[:n].float()
            if not logits:
                raw = torch.softmax(raw, dim=-1)
            return raw.cpu().numpy()

    def predict_proba_positive(self, data: dict) -> np.ndarray:
        return self(data)[:, 1]


def load_model(checkpoint_path: str, in_features_ffnn: int | None = None,
               device=None, compute_dtype=None, fused_embrace: bool = True,
               seed: int = 0) -> ReloadedModel:
    """Load a checkpoint saved by either package.  ``device=None`` is the
    card (raises without CUDA; pass ``device="cpu"`` for the CPU)."""
    trees, meta = load_checkpoint(checkpoint_path)
    model = meta.get("model")
    flat = meta.get("model_params")
    if model is None:
        raise ValueError(f"checkpoint {checkpoint_path} lacks 'model' meta")
    if in_features_ffnn is None and "ffnn" in trees["params"]:
        in_features_ffnn = int(np.asarray(trees["params"]["ffnn"]["w0"]).shape[0])
    elif in_features_ffnn is None and model == "FFNN":
        in_features_ffnn = int(np.asarray(trees["params"]["w0"]).shape[0])
    return ReloadedModel(model, trees["params"], trees.get("bn_state", {}), flat,
                         in_features_ffnn=in_features_ffnn, device=device,
                         compute_dtype=compute_dtype, fused_embrace=fused_embrace,
                         seed=seed)
