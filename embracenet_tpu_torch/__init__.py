"""embracenet_tpu_torch — the PyTorch/CUDA port of ``embracenet_tpu``.

The JAX package stays the reference; this package mirrors its module layout,
names and array layouts (``x @ w`` with ``w[in, out]``, conv ``w[O, I, K]``,
NCW activations), so a JAX-written checkpoint loads here as a plain copy
(``convert.tree_to_torch``).  Every Pallas TPU kernel of the JAX package
becomes a kernel written by hand for Hopper under ``csrc/``.

Entry points run on the CUDA card.  Without one they raise unless the
caller asks for ``device="cpu"``; there is no silent CPU fallback.

Ported so far: the data layer (``preprocess``: raw CSV / BED / FASTA files
to cached, scaled, imputed and selected per-cell-line arrays), checkpoint
serving (``predict`` / ``evaluate``), population training
(``training.engine.fit``) and the whole search-and-CV workflow (``train``:
K-fold CV, a hyperparameter search per fold on a SQLite study, the best
trial's retrain, scores and checkpoints) for all five model families, with
EmbraceNet's docking and stochastic embracement in the fused CUDA kernels
and their gradient (``ops/embrace.py``).

The user-facing surface on top of them:

* ``sweep.run_sweep`` — the cells x tasks x models grid with the FFNN
  smote-vs-double contest, ``preprocess_all``, ``load_baseline_md`` and
  ``parity_report`` against ``BASELINE.md``;
* ``visual.report`` — result tables (nested dicts, no pandas), plots,
  ``CompareModelsResult`` and ``select_augmented_models``;
* ``python -m embracenet_tpu_torch`` — the CLI (``preprocess``, ``train``,
  ``sweep``, ``evaluate``, ``parity``; ``--device cpu`` for the CPU);
* ``utils.profiling`` (the program's spans, ``annotate``, on
  ``torch.profiler``; its counters, ``count`` / ``counters``; and
  ``device_trace``) and ``utils.logging.get_logger``;
* ``examples/torch_quickstart.py`` — the workflow in one script.

Multi-device training (``parallel/mesh.py``): one process per device on
``torch.distributed``; ``training.engine.fit``, ``train`` and
``sweep.run_sweep`` take ``mesh=`` (a ``Mesh``, a ``MeshConfig``,
``"auto"``); ``examples/torch_multichip_sweep.py`` runs a sweep over one.
"""

from __future__ import annotations

__version__ = "0.1.0"

TASKS = [
    "active_E_vs_inactive_E",
    "active_P_vs_inactive_P",
    "active_E_vs_active_P",
    "inactive_E_vs_inactive_P",
    "active_EP_vs_inactive_rest",
]

CELL_LINES = ["A549", "GM12878", "H1", "HEK293", "HEPG2", "K562", "MCF7"]

SEQ_LEN = 256        # bp per regulatory window
N_BASES = 4          # a, c, g, t (alphabetical channel order, reference parity)
N_CLASSES = 2


def default_device():
    """The card: ``torch.device("cuda")``.  Raises when CUDA is absent; a
    caller who wants the CPU passes ``device="cpu"`` explicitly."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the port on the CPU")
    return torch.device("cuda")


def resolve_device(device=None):
    """``None`` -> :func:`default_device`; anything else -> torch.device."""
    import torch

    return default_device() if device is None else torch.device(device)


def __getattr__(name):
    # Lazy: the api module pulls in the model stack.
    if name in ("preprocess", "train", "predict", "evaluate"):
        from embracenet_tpu_torch import api

        return getattr(api, name)
    raise AttributeError(name)


__all__ = [
    "TASKS",
    "CELL_LINES",
    "SEQ_LEN",
    "N_BASES",
    "N_CLASSES",
    "default_device",
    "resolve_device",
    "preprocess",
    "train",
    "predict",
    "evaluate",
]
