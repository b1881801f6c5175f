"""Analysis and visualisation over the results artifact (port of
``embracenet_tpu/visual/report.py``).

Parity with `BIOINF_tesi/visual/visual.py`:
  * label-ratio pies (`:32-60`), imbalance-ratio table (`:63-77`);
  * baseline AUPRC table = prevalence floored at 0.1 (`:81-96`);
  * per-cell fold-score plots vs baseline (`:100-166`);
  * average / std AUPRC tables over the 5 models x 5 tasks (`:188-243`);
  * pairwise model comparison: reload every fold's saved model, score the
    full dataset, Wilcoxon signed-rank between models per fold, "different
    if >= 2/3 folds p < 0.05" (`Compare_Models_Result`, `:250-404`);
  * pooled overall comparison of EmbraceNet vs others across all cellxtask
    score lists (`compare_model_overall_performance`, `:456-515`).

Stated divergence: pandas is not a dependency of the port.  Each table
function returns the nested dict the JAX function hands to
``pd.DataFrame`` — ``{column: {row: value}}``, with the same rounding and
NaN where an entry is missing (``compare_model_overall_performance``:
``{row: {column: value}}``, as the JAX ``.T``) — so
``pd.DataFrame(result)`` gives the JAX package's table;
:func:`format_table` prints one as text.

Plotting needs matplotlib, imported when a plot is drawn.
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np

from embracenet_tpu_torch import CELL_LINES, TASKS
from embracenet_tpu_torch.training.results import baseline_auprc
from embracenet_tpu_torch.utils.statcompat import ranksums, wilcoxon

DEFAULT_MODELS = ("FFNN", "CNN", "ConcatNetMultimodal", "EmbraceNetMultimodal",
                  "EmbraceNetMultimodal_augmentation")


def _columns(table: dict) -> dict:
    """``{column: {row: value}}`` with every column holding every row (in
    order of first appearance), NaN where a column lacks one, as
    ``pd.DataFrame`` aligns a dict of dicts."""
    rows = list(dict.fromkeys(r for col in table.values() for r in col))
    return {c: {r: col.get(r, math.nan) for r in rows}
            for c, col in table.items()}


def get_imbalance_ratio_df(labels: dict) -> dict:
    """cells x tasks neg/pos ratio table (`visual.py:63-77`), rounded to 2
    decimals.  ``labels``: {task: {cell: y array}} -> {task: {cell: ratio}}."""
    out = {}
    for task, cells in labels.items():
        out[task] = {c: float(np.round((np.asarray(y) == 0).sum() /
                                       max((np.asarray(y) == 1).sum(), 1), 2))
                     for c, y in cells.items()}
    return _columns(out)


def get_baseline_df(labels: dict) -> dict:
    """Baseline AUPRC table (`visual.py:81-96`), rounded to 3 decimals:
    {task: {cell: baseline}}."""
    out = {}
    for task, cells in labels.items():
        out[task] = {c: float(np.round(baseline_auprc(y), 3))
                     for c, y in cells.items()}
    return _columns(out)


def get_average_auprc_df(results: dict, cell_line: str,
                         models=DEFAULT_MODELS, tasks=TASKS) -> dict:
    """models x tasks table of average_CV_AUPRC (`visual.py:188-219`):
    {task: {model: value}}."""
    table = {}
    for task in tasks:
        col = {}
        node = results.get(cell_line, {}).get(task, {})
        for m in models:
            entry = node.get(m)
            avg = entry.get("average_CV_AUPRC") if entry else None
            col[m] = math.nan if avg is None else avg
        table[task] = col
    return table


def get_standard_dev_df(results: dict, cell_line: str,
                        models=DEFAULT_MODELS, tasks=TASKS) -> dict:
    """models x tasks std over fold scores (`visual.py:222-243`):
    {task: {model: value}}."""
    table = {}
    for task in tasks:
        col = {}
        node = results.get(cell_line, {}).get(task, {})
        for m in models:
            entry = node.get(m)
            scores = entry.get("final_test_AUPRC_scores") if entry else None
            col[m] = float(np.std(scores)) if scores else math.nan
        table[task] = col
    return table


def format_table(table) -> str:
    """Plain text of a table, right-aligned columns, floats to 6
    significant digits, ``NaN`` for a missing value.  ``table`` is a list
    of row dicts (printed without an index, as ``to_string(index=False)``
    prints a DataFrame of them) or a ``{column: {row: value}}`` dict (the
    row labels then lead each line, as ``pd.DataFrame(table)`` prints)."""
    index = None
    if isinstance(table, dict):
        table = _columns(table)
        index = list(next(iter(table.values()), {}))
        rows = [{c: table[c][r] for c in table} for r in index]
    else:
        rows = list(table)
    cols = list(dict.fromkeys(c for r in rows for c in r))

    def text(v):
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return "NaN"
        if isinstance(v, (bool, np.bool_)):
            return str(bool(v))
        if isinstance(v, (float, np.floating)):
            return format(float(v), ".6g")
        return str(v)

    grid = [[str(c) for c in cols]] + [[text(r.get(c)) for c in cols]
                                       for r in rows]
    if index is not None:
        grid = [[""] + grid[0]] + [[str(i)] + g for i, g in zip(index, grid[1:])]
    widths = [max(len(g[j]) for g in grid) for j in range(len(grid[0]))]
    return "\n".join(" ".join(cell.rjust(w) for cell, w in zip(g, widths))
                     for g in grid)


def plot_label_ratio(labels_by_cell: dict, task: str, save_path=None):
    """Pie grid of class ratios per cell (`visual.py:32-60`)."""
    import matplotlib.pyplot as plt

    cells = sorted(labels_by_cell)
    fig, axes = plt.subplots(1, len(cells), figsize=(3 * len(cells), 3))
    axes = np.atleast_1d(axes)
    for ax, cell in zip(axes, cells):
        y = np.asarray(labels_by_cell[cell])
        ax.pie([(y == 1).sum(), (y == 0).sum()], labels=["pos", "neg"],
               autopct="%1.1f%%")
        ax.set_title(cell)
    fig.suptitle(task)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def plot_scores(results: dict, cell_line: str, task: str, model: str,
                baseline: float | None = None, save_path=None):
    """Fold train/test AUPRC curves vs baseline line (`visual.py:100-166`)."""
    import matplotlib.pyplot as plt

    entry = results[cell_line][task][model]
    folds = sorted(k for k in entry if k.startswith("iteration_n_"))
    fig, axes = plt.subplots(1, len(folds), figsize=(4 * len(folds), 3),
                             sharey=True)
    axes = np.atleast_1d(axes)
    for ax, fold in zip(axes, folds):
        ax.plot(entry[fold]["AUPRC_train"], label="train")
        ax.plot(entry[fold]["AUPRC_test"], label="test")
        if baseline is None:
            baseline = results[cell_line][task].get("baseline_AUPRC")
        if baseline is not None:
            ax.axhline(baseline, color="gray", ls="--", label="baseline")
        ax.set_title(fold)
        ax.set_xlabel("epoch")
    axes[0].set_ylabel("AUPRC")
    axes[0].legend()
    fig.suptitle(f"{cell_line} / {task} / {model}")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def plot_fold_scores(results: dict, cells, models=("FFNN", "CNN"),
                     k: int = 3, save_path=None):
    """The reference's ``plot_scores`` FORM (`visual.py:100-166`): a facet
    grid (row = task, col = cell) of horizontal bars — one bar pair per
    model, train vs test hue, bar = mean of the k fold-final AUPRCs with a
    +-sd whisker (seaborn ``ci='sd'``), xlim (0, 1), and the cell/task
    baseline as a red dashed vline.  Plain matplotlib, same visual layout.

    ``results``: the results_dict mapping (ResultsDict.data or the
    reference pickle's dict)."""
    import matplotlib.pyplot as plt

    if isinstance(cells, str):
        cells = [cells]
    tasks = sorted({t for c in cells for t in results.get(c, {})})
    fig, axes = plt.subplots(
        len(tasks), len(cells),
        figsize=(5 * max(len(cells), 1), 2.2 * max(len(tasks), 1)),
        squeeze=False)
    colors = {"train": "#80d4ff", "test": "#ff3385"}
    for r, task in enumerate(tasks):
        for c, cell in enumerate(cells):
            ax = axes[r][c]
            entry = results.get(cell, {}).get(task, {})
            ypos, labels = [], []
            for mi, model in enumerate(models):
                med = entry.get(model)
                if not med:
                    continue
                for si, split in enumerate(("train", "test")):
                    scores = np.asarray(
                        med.get(f"final_{split}_AUPRC_scores", [])[:k],
                        dtype=float)
                    if not scores.size:
                        continue
                    y = mi + (si - 0.5) * 0.35
                    ax.barh(y, scores.mean(), height=0.32,
                            xerr=scores.std() if scores.size > 1 else None,
                            color=colors[split],
                            label=split if (mi == 0) else None)
                ypos.append(mi)
                labels.append(model)
            base = entry.get("baseline_AUPRC")
            if base is not None:
                ax.axvline(base, color="red", linewidth=3, ls="--")
            ax.set_xlim(0, 1)
            ax.set_yticks(ypos)
            ax.set_yticklabels(labels)
            ax.invert_yaxis()
            ax.set_title(f"{cell} | {task}", fontsize=9)
            if r == 0 and c == 0:
                ax.legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


# ---------------------------------------------------------------------------
# model comparison (Compare_Models_Result parity)
# ---------------------------------------------------------------------------

class CompareModelsResult:
    """Pairwise per-fold Wilcoxon signed-rank between models' P(class=1)
    over the full dataset; models "different" if >= threshold fraction of
    folds have p < alpha (`visual.py:250-404`; the reference uses 2/3).

    Fold ``f`` reads ``checkpoint_name(cell, model, task, f)``.  ``KfoldCV``
    writes that name only for the fold-best model (fold 0), so over a
    sweep's own output only ``n_folds=1`` finds its files, in both
    packages.  The models predict on ``device`` (the card unless
    ``"cpu"``)."""

    def __init__(self, checkpoint_dir: str = "models", n_folds: int = 3,
                 alpha: float = 0.05, majority: float = 2 / 3, device=None):
        self.checkpoint_dir = checkpoint_dir
        self.n_folds = n_folds
        self.alpha = alpha
        self.majority = majority
        self.device = device

    def _predictions(self, cell, model, task, fold, data, augmentation=False):
        from embracenet_tpu_torch.models.reload import load_model
        from embracenet_tpu_torch.training.cv import checkpoint_name

        name = checkpoint_name(cell, model, task, fold, augmentation)
        path = os.path.join(self.checkpoint_dir, name)
        return load_model(path, device=self.device).predict_proba_positive(data)

    def __call__(self, data_by_cell: dict, task: str,
                 models=("FFNN", "CNN", "ConcatNetMultimodal",
                         "EmbraceNetMultimodal")) -> dict:
        """``data_by_cell``: {cell: data dict}.  Returns
        {cell: {(m1, m2): {"pvalues": [...], "different": bool}}}."""
        out = {}
        for cell, data in data_by_cell.items():
            pair_res = {}
            preds = {}
            for m in models:
                preds[m] = [self._predictions(cell, m, task, f, data)
                            for f in range(self.n_folds)]
            for i, m1 in enumerate(models):
                for m2 in models[i + 1:]:
                    pvals = []
                    for f in range(self.n_folds):
                        diff = preds[m1][f] - preds[m2][f]
                        if np.allclose(diff, 0):
                            pvals.append(1.0)
                        else:
                            _, p = wilcoxon(preds[m1][f], preds[m2][f])
                            pvals.append(float(p))
                    n_sig = sum(p < self.alpha for p in pvals)
                    pair_res[(m1, m2)] = {
                        "pvalues": pvals,
                        "different": n_sig >= self.majority * self.n_folds,
                    }
            out[cell] = pair_res
        return out

    def save(self, result: dict, path: str):
        with open(path, "wb") as fh:
            pickle.dump(result, fh)

    def save_pval_dict(self, result: dict, task: str, out_dir: str = "."):
        """Write the reference-named per-task artifact
        ``pval_results_dict_{task}.pickle`` (`visual.py:396-397`) with the
        reference's nesting ``{task: {cell: {str(fold_1based): {base_model:
        {comp_model: pval}}}}}`` (`visual.py:374-389`; both pair directions
        carry the same symmetric Wilcoxon p).  Returns the path written."""
        from collections import OrderedDict

        pval_dict: dict = {task: {}}
        for cell, pairs in result.items():
            folds: dict = {}
            for (m1, m2), res in pairs.items():
                for f, p in enumerate(res["pvalues"], start=1):
                    d = folds.setdefault(str(f), {})
                    d.setdefault(m1, {})[m2] = p
                    d.setdefault(m2, {})[m1] = p
            pval_dict[task][cell] = folds
        path = os.path.join(out_dir, f"pval_results_dict_{task}.pickle")
        with open(path, "wb") as fh:
            pickle.dump(OrderedDict(pval_dict), fh)
        return path


def compare_model_overall_performance(results: dict,
                                      model: str = "EmbraceNetMultimodal",
                                      others=("FFNN", "CNN",
                                              "ConcatNetMultimodal"),
                                      tasks=TASKS,
                                      cells=CELL_LINES) -> dict:
    """Pooled Wilcoxon rank-sum of all cellxtask fold scores: ``model`` vs
    each other model, two-sided and one-sided (`visual.py:456-515`):
    {other: {"two_sided_p", "greater_p", "n"}}."""
    def pooled(m):
        scores = []
        for c in cells:
            for t in tasks:
                entry = results.get(c, {}).get(t, {}).get(m)
                if entry and entry.get("final_test_AUPRC_scores"):
                    scores.extend(entry["final_test_AUPRC_scores"])
        return np.asarray(scores)

    base = pooled(model)
    rows = {}
    for other in others:
        vs = pooled(other)
        if len(base) == 0 or len(vs) == 0:
            rows[other] = {"two_sided_p": math.nan, "greater_p": math.nan,
                           "n": 0}
            continue
        _, p2 = ranksums(base, vs)
        _, pg = ranksums(base, vs, alternative="greater")
        rows[other] = {"two_sided_p": float(p2), "greater_p": float(pg),
                       "n": min(len(base), len(vs))}
    return rows


def select_augmented_models(results: dict, cell_line: str, task: str,
                            checkpoint_dir: str = "models",
                            n_folds: int = 3, model_name: str = "FFNN",
                            augm_1: str = "smote", augm_2: str = "double",
                            fix_label_bug: bool = False, mesh=None) -> str:
    """Pick the better FFNN rebalancing variant by the reference's *realized*
    rule (`models/utils/utils.py:302-353`, the second definition which
    shadows the first): ``augm_2`` wins iff the rank-sum p-value over the
    fold AUPRC lists is < 0.3 AND ``average_CV_AUPRC[augm_2] >=
    average_CV_AUPRC[augm_1]``; otherwise ``augm_1`` wins.  The winner's
    entry is copied to ``results[cell][task][model_name]`` and its fold
    checkpoints to the canonical names.

    Bug-compat: the reference's else-branch sets ``best_augmentation`` to
    ``augm_2`` even when ``augm_1`` wins (``utils.py:342``, marked
    "#SISTEMA IN CV" — BASELINE.md confirms every pickle entry reads
    'double').  We reproduce that by default; ``fix_label_bug=True`` records
    the actual winner instead.  Returns the winner name.  Under a
    ``mesh`` rank 0 alone copies the checkpoints, and every rank waits
    until it has.
    """
    import copy
    import shutil

    from embracenet_tpu_torch.parallel.mesh import barrier, is_writer
    from embracenet_tpu_torch.training.cv import checkpoint_name

    node = results.get(cell_line, {}).get(task, {})
    e1 = node.get(f"{model_name}_{augm_1}", {})
    e2 = node.get(f"{model_name}_{augm_2}", {})
    s1 = e1.get("final_test_AUPRC_scores")
    s2 = e2.get("final_test_AUPRC_scores")
    if not s1 or not s2:
        raise ValueError(
            f"need {model_name}_{augm_1} and {model_name}_{augm_2} entries")
    _, p = ranksums(s1, s2)
    winner = augm_2 if (p < 0.3 and e2.get("average_CV_AUPRC", -np.inf)
                        >= e1.get("average_CV_AUPRC", -np.inf)) else augm_1
    node[model_name] = copy.deepcopy(node[f"{model_name}_{winner}"])
    node["best_augmentation"] = winner if fix_label_bug else augm_2
    # Copy the winner's fold checkpoints to the canonical (suffix-free)
    # names, like the reference's shutil.copy loop (utils.py:344-353, folds
    # 1-based).  Two filename protocols are checked: the reference's
    # `checkpoint_name` files, and the fold-resume files KfoldCV writes
    # (`{study_name}_fold{k}_result.npz` with study_name =
    # f"{cell}_{task}_{label}", api.train(model_label=...)).  Fold 0 is
    # included because api.train saves the winner variant's best TEST model
    # as checkpoint_name(cell, label, task, 0); promoting it creates the
    # canonical `{cell}_{model}_{task}_0_test_` file that api.predict /
    # evaluate and CompareModelsResult read.
    for fold in range(0, n_folds + 1 if is_writer(mesh) else 0):
        pairs = [
            (checkpoint_name(cell_line, f"{model_name}_{winner}", task,
                             fold) + ".npz",
             checkpoint_name(cell_line, model_name, task, fold) + ".npz"),
            (f"{cell_line}_{task}_{model_name}_{winner}"
             f"_fold{fold}_result.npz",
             f"{cell_line}_{task}_{model_name}_fold{fold}_result.npz"),
        ]
        for src, dst in pairs:
            src = os.path.join(checkpoint_dir, src)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(checkpoint_dir, dst))
    barrier(mesh)
    return winner
