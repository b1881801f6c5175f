"""K-fold cross-validation orchestrator, unimodal and multimodal (port of
``embracenet_tpu/training/cv.py``).

Reference: ``Kfold_CV`` (`BIOINF_tesi/models/utils/training_models.py:408-692`)
and ``Kfold_CV_Multimodal`` (`training_models_multimodal.py:475-798`).  Flow
per fold (both engines unified here because the model spec abstracts inputs):

  1. outer ``KFold(n_splits, shuffle, random_state)`` split;
  2. inner train/val split with ``test_size = 1/n_folds`` (same seed across
     modality views keeps rows aligned, `training_models_multimodal.py:737-742`);
  3. rebalance the training split when pos/neg < threshold — SMOTE or
     positive-resampling for tabular, complement strands for sequence; in
     multimodal both views rebalance to identical counts and label layout so
     one batch plan serves both (`:528-534`);
  4. hyperparameter search on (train, val) — one population;
  5. ``weight_reset`` of the best trial (keeping BatchNorm, a reference
     quirk), optimizer rebuilt from the best flat params, retrain on
     train+val, evaluate on the fold's test split;
  6. keep the best-across-folds checkpoint under the reference's filename
     protocol; accumulate ``scores_dict`` incl. ``average_CV_AUPRC``
     (= round(sum/n_folds, 5), `training_models.py:690-691`).

Seeds: integer seeds take the place of the JAX package's PRNG keys.
``weight_reset`` takes ``random_state + 100 + fold``; the sequential
retrain fits with ``seed = random_state + 200 + fold`` and the fold-fused
retrain takes its run seed from ``engine.seed_streams(random_state + 200 +
fold, 1)``, the stream that fit derives from that seed, so both paths
train each trial alike.  A fold-fused population pads every fold's
batches to the widest fold's rows; the sequential path's fits run as many
rows (``engine.fit``'s ``plan_rows``, over the folds it trains), so its
trials sum over the same batches as their fused copies.

Stated divergence: the JAX package's ``CVConfig.share_programs`` and
``TrainConfig.pad_ffnn_features`` (a retrain padded to the search's
population, features padded to a fixed width) only make XLA reuse compiled
programs; eager PyTorch compiles none, and the port has neither.
Everything runs on the card unless ``device`` says otherwise.

Under a mesh (``mesh=``, any form ``parallel.mesh.resolve_mesh`` takes) the
fold-fused path is the default (``CVConfig.fuse_folds=None``), as in the
JAX package: its population is the widest the trial axes can shard.  Every
rank runs the same CV and returns the same scores; rank 0 alone writes
studies and checkpoints, and a resumed fold is read from rank 0's files.
"""

from __future__ import annotations

import os
import warnings
from collections import defaultdict

import numpy as np
import torch

from embracenet_tpu_torch.config import CVConfig, TrainConfig
from embracenet_tpu_torch.convert import tree_to_numpy
from embracenet_tpu_torch.data import sampling
from embracenet_tpu_torch.hpo import space as space_mod
from embracenet_tpu_torch.hpo.search import (concat_fold_views, run_search,
                                             run_search_fused)
from embracenet_tpu_torch.parallel.mesh import broadcast, is_writer, resolve_mesh
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.batching import (balanced_plan, eval_plan,
                                                    shift_plan)
from embracenet_tpu_torch.training.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from embracenet_tpu_torch.training.modelspec import get_spec
from embracenet_tpu_torch.utils.skcompat import kfold_split, train_test_split


def _views_for_model(model: str):
    if model == "FFNN":
        return ("ffnn",)
    if model == "CNN":
        return ("cnn",)
    return ("ffnn", "cnn")


def rebalance_views(data: dict, views, type_augm: str, threshold: float,
                    augmentation: bool = False, random_state: int = 123) -> dict:
    """Rebalance (or augment) every view to identical counts/labels.

    Tabular views use SMOTE/double; sequence views use complement strands.
    All paths append the same number of positives (and, for augmentation,
    negatives) in the same label order, so a single ``y``/batch plan stays
    valid across views — mirroring how the reference feeds two loaders built
    with the same sampler seed and asserts target equality per batch
    (`training_models_multimodal.py:132-136`).
    """
    y = np.asarray(data["y"])
    out = {}
    new_y = None
    for v in views:
        if augmentation:
            xv, yv = sampling.data_augmentation(
                data[v], y, sequence=(v == "cnn"),
                rebalance_threshold=threshold, random_state=random_state)
        else:
            xv, yv = sampling.data_rebalancing(
                data[v], y, sequence=(v == "cnn"),
                type_augm_genfeatures=type_augm,
                rebalance_threshold=threshold, random_state=random_state)
        out[v] = xv
        if new_y is None:
            new_y = np.asarray(yv)
        else:
            assert np.array_equal(new_y, np.asarray(yv)), \
                "modality views diverged during rebalancing"
    out["y"] = new_y if new_y is not None else y
    return out


def _plan_rows(pairs, batch_size: int) -> tuple:
    """(train, eval) rows of the widest batch plans over the folds' (train,
    eval) data pairs: what a fold-fused population's batches run."""
    if not pairs:
        return (0, 0)
    return (max(balanced_plan(np.asarray(tr["y"]), batch_size,
                              seed=123).idx.shape[1] for tr, _ in pairs),
            max(eval_plan(len(np.asarray(ev["y"])), batch_size * 2,
                          seed=123).idx.shape[1] for _, ev in pairs))


def _warn_no_best_model(study_name, fold):
    # Without the best trial's checkpoint the retrain starts from a fresh
    # init and LOSES the reference's keep-trained-BN weight_reset quirk
    # (training_models.py:511-520) — say so instead of silently diverging.
    warnings.warn(
        f"{study_name} fold {fold}: best-trial checkpoint missing; "
        "retraining from a fresh init (the reference's weight_reset would "
        "have kept HPO-trained BatchNorm state)", RuntimeWarning, stacklevel=3)


def _reset(spec, hp, best_model, random_state, fold):
    """The weight reset of the best trial, seeded with ``random_state + 100
    + fold``: its ``(params, bn_state)``."""
    return engine.weight_reset(random_state + 100 + fold, spec, hp,
                               best_model[0], best_model[1])


class KfoldCV:
    """Callable K-fold CV; accumulates a reference-shaped ``scores_dict``."""

    def __init__(self):
        self.scores_dict = defaultdict(dict)
        self.scores_dict["final_test_AUPRC_scores"] = []
        self.scores_dict["final_train_AUPRC_scores"] = []
        self.best_params = {}

    def _split(self, data, views, y, train_index, test_index, cv_cfg,
               train_cfg, random_state):
        """(train, val, train+val, test) views of one fold, the training
        splits rebalanced."""
        tr_idx, val_idx = train_test_split(
            train_index, test_size=1 / cv_cfg.n_folds,
            random_state=random_state)

        def view_slice(idx):
            d = {v: np.asarray(data[v])[idx] for v in views}
            d["y"] = y[idx]
            return d

        def rebalanced(idx):
            return rebalance_views(view_slice(idx), views,
                                   cv_cfg.type_augm_genfeatures,
                                   train_cfg.rebalance_threshold,
                                   augmentation=cv_cfg.augmentation)

        return (rebalanced(tr_idx), view_slice(val_idx),
                rebalanced(train_index), view_slice(test_index))

    @staticmethod
    def _finished(fold_ck, resume, mesh):
        """The meta of a finished fold's checkpoint (rank 0's file, on
        every rank), or None where the fold is to run."""
        meta = None
        if resume and is_writer(mesh) and os.path.exists(fold_ck + ".npz"):
            meta = load_checkpoint(fold_ck)[1]
        return broadcast(mesh, meta)

    def _resume(self, meta, fold, verbose):
        """A finished fold's scores from its checkpoint's meta -> (test,
        train)."""
        self.scores_dict[f"iteration_n_{fold}"] = meta["scores"]
        self.best_params[fold] = meta["best_params"]
        final_test = meta["scores"]["AUPRC_test"][-1]
        if verbose:
            print(f"fold {fold}: resumed (test AUPRC {final_test:.4f})")
        return final_test, meta["scores"]["AUPRC_train"][-1]

    def __call__(self,
                 data: dict,
                 model: str,
                 task: str | None = None,
                 cell_line: str | None = None,
                 cv_cfg: CVConfig = CVConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 study_name: str | None = None,
                 storage: str = "optuna_tuning.db",
                 checkpoint_dir: str = "models",
                 test_model_path: str | None = None,
                 random_state: int = 789,
                 resume: bool = True,
                 verbose: bool = False,
                 mesh=None,
                 device=None):
        """``data``: {"ffnn": [N,D] float, "cnn": [N,256] uint8 codes, "y"}
        (views required by ``model`` must be present).
        Returns the scores_dict.

        ``mesh``: a ``parallel.mesh.Mesh``, ``MeshConfig``, ``"auto"`` or
        None; every rank of it calls with the same arguments.  ``device``:
        where every fit runs (None = the card, or the mesh's device)."""
        mesh = resolve_mesh(mesh, device)
        views = _views_for_model(model)
        for v in views:
            if v not in data:
                raise ValueError(f"model {model} requires data view {v!r}")
        y = np.asarray(data["y"])
        n = len(y)
        in_features = (np.asarray(data["ffnn"]).shape[1]
                       if "ffnn" in views else None)
        spec = get_spec(model, in_features_ffnn=in_features)
        study_name = study_name or f"{cell_line}_{task}_{model}"
        avg_score = []

        folds = kfold_split(n, cv_cfg.n_folds, random_state)

        fuse = (cv_cfg.fuse_folds if cv_cfg.fuse_folds is not None
                else mesh is not None)
        if (fuse and spec.vmappable
                and not train_cfg.eval_reshuffle
                and not hasattr(cv_cfg.sampler, "sample")):
            return self._call_fused(
                data, model, spec, views, folds, y,
                cv_cfg=cv_cfg, train_cfg=train_cfg, study_name=study_name,
                storage=storage, checkpoint_dir=checkpoint_dir,
                test_model_path=test_model_path, random_state=random_state,
                resume=resume, verbose=verbose, cell_line=cell_line,
                task=task, device=device, mesh=mesh)

        # fold-level resume: the reference's fit() short-circuits when its
        # checkpoint exists (training_models.py:71-76); here a finished
        # fold reloads its scores
        splits = {}
        for i, (train_index, test_index) in enumerate(folds):
            fold_ck = os.path.join(checkpoint_dir,
                                   f"{study_name}_fold{i + 1}_result")
            if self._finished(fold_ck, resume, mesh) is None:
                splits[i + 1] = self._split(data, views, y, train_index,
                                            test_index, cv_cfg, train_cfg,
                                            random_state)
        # every fit's batches run the rows the fold-fused populations run
        # (the widest pending fold's), so each trial trains exactly as it
        # does fold-fused
        search_rows = _plan_rows([(s[0], s[1]) for s in splits.values()],
                                 train_cfg.batch_size)
        retrain_rows = _plan_rows([(s[2], s[3]) for s in splits.values()],
                                  train_cfg.batch_size)
        for i in range(len(folds)):
            fold = i + 1
            if verbose:
                print(f">>> fold {fold}/{cv_cfg.n_folds}")
            if fold not in splits:
                fold_ck = os.path.join(checkpoint_dir,
                                       f"{study_name}_fold{fold}_result")
                meta = self._finished(fold_ck, resume, mesh)
                final_test, final_train = self._resume(meta, fold, verbose)
                self.scores_dict["final_test_AUPRC_scores"].append(final_test)
                self.scores_dict["final_train_AUPRC_scores"].append(final_train)
                avg_score.append(final_test)
                continue
            fold_ck = os.path.join(checkpoint_dir,
                                   f"{study_name}_fold{fold}_result")
            train_d, val_d, trainval_d, test_d = splits.pop(fold)

            # ---- hyperparameter search (one population) ----
            search = run_search(
                spec, model, train_d, val_d,
                study_name=f"{study_name}_{fold}", storage=storage,
                sampler=cv_cfg.sampler, n_trials=cv_cfg.n_trials,
                train_cfg=train_cfg, checkpoint_dir=checkpoint_dir,
                seed=random_state + fold, verbose=verbose,
                fit_kwargs={"plan_rows": search_rows}, device=device,
                mesh=mesh)

            hp = space_mod.params_to_hp(model, search.best_params)
            opt = space_mod.optimizer_hp(search.best_params)
            init_params = init_bn = None
            if search.best_model is not None:
                # weight_reset: fresh Linear/Conv, keep trained BN (quirk)
                params, bn = _reset(spec, hp, search.best_model, random_state,
                                    fold)
                init_params = engine.stack_trials([params])
                init_bn = engine.stack_trials([bn])
            else:
                _warn_no_best_model(study_name, fold)

            result = engine.fit(spec, [hp], [opt],
                                trainval_d, test_d, train_cfg,
                                seed=random_state + 200 + fold,
                                init_params=init_params, init_bn_state=init_bn,
                                verbose=verbose, device=device, mesh=mesh,
                                plan_rows=retrain_rows)

            fold_scores = {
                "AUPRC_train": result.auprc_train[0],
                "AUPRC_test": result.auprc_test[0],
                "F1_precision_recall": result.f1_precision_recall[0],
            }
            self.scores_dict[f"iteration_n_{fold}"] = fold_scores
            trial0_tree = engine._trial(
                tree_to_numpy((result.params, result.bn_state)), 0)
            save_checkpoint(fold_ck,
                            {"params": trial0_tree[0],
                             "bn_state": trial0_tree[1]},
                            meta={"scores": fold_scores,
                                  "best_params": search.best_params,
                                  "model": model, "model_params":
                                  search.best_params}, mesh=mesh)
            final_test = result.final_test_auprc[0]
            final_train = result.final_train_auprc[0]
            self.scores_dict["final_test_AUPRC_scores"].append(final_test)
            self.scores_dict["final_train_AUPRC_scores"].append(final_train)
            if verbose:
                print(f"fold {fold} test AUPRC: {final_test:.4f}")

            avg_score.append(final_test)
            if final_test == max(avg_score) and test_model_path:
                save_checkpoint(
                    os.path.join(checkpoint_dir, test_model_path),
                    {"params": trial0_tree[0], "bn_state": trial0_tree[1]},
                    meta={"model_params": search.best_params,
                          "model": model, "cell_line": cell_line,
                          "task": task, "fold": fold}, mesh=mesh)

        avg = float(np.round(sum(avg_score) / cv_cfg.n_folds, 5))
        self.scores_dict["average_CV_AUPRC"] = avg
        if verbose:
            print(f"{cv_cfg.n_folds}-fold CV AUPRC: {avg}")
        return dict(self.scores_dict)

    def _call_fused(self, data, model, spec, views, folds, y, *,
                    cv_cfg, train_cfg, study_name, storage, checkpoint_dir,
                    test_model_path, random_state, resume, verbose,
                    cell_line, task, device=None, mesh=None):
        """All folds' HPO searches, then all folds' retrains, as two fused
        populations (engine per-trial plans over fold-concatenated data).
        Scores, study accounting, checkpoints and the reference filename
        protocol are identical to the sequential path; per-trial seeds are
        pinned to the (unbucketed) sequential ones via
        ``engine.seed_streams``, so each trial trains as it would there.
        2 fits per CV instead of 2 * n_folds."""
        n_trials = cv_cfg.n_trials
        resumed: dict[int, tuple] = {}      # fold -> (final_test, final_train)
        pending = []   # (fold, train_d, val_d, trainval_d, test_d)
        for i, (train_index, test_index) in enumerate(folds):
            fold = i + 1
            fold_ck = os.path.join(checkpoint_dir,
                                   f"{study_name}_fold{fold}_result")
            meta = self._finished(fold_ck, resume, mesh)
            if meta is not None:
                resumed[fold] = self._resume(meta, fold, verbose)
                continue
            pending.append((fold,) + self._split(
                data, views, y, train_index, test_index, cv_cfg, train_cfg,
                random_state))

        fold_final: dict[int, tuple] = {}   # fold -> (test, train, tree, bp)
        if pending:
            searches = run_search_fused(
                spec, model,
                [(p[1], p[2]) for p in pending],
                study_names=[f"{study_name}_{p[0]}" for p in pending],
                seeds=[random_state + p[0] for p in pending],
                storage=storage, sampler=cv_cfg.sampler, n_trials=n_trials,
                train_cfg=train_cfg, checkpoint_dir=checkpoint_dir,
                verbose=verbose, device=device, mesh=mesh)

            # ---- fused retrain: one population over all pending folds ----
            cat_tr, off_tr = concat_fold_views([p[3] for p in pending],
                                               tuple(views) + ("y",))
            cat_te, off_te = concat_fold_views([p[4] for p in pending],
                                               tuple(views) + ("y",))
            hp_list, opt_list, init_trees, run_seeds = [], [], [], []
            train_plans, eval_plans = [], []
            for j, (fold, train_d, val_d, trainval_d, test_d) in \
                    enumerate(pending):
                search = searches[j]
                hp = space_mod.params_to_hp(model, search.best_params)
                opt = space_mod.optimizer_hp(search.best_params)
                tp = shift_plan(balanced_plan(np.asarray(trainval_d["y"]),
                                              train_cfg.batch_size, seed=123),
                                off_tr[j])
                ep = shift_plan(eval_plan(len(np.asarray(test_d["y"])),
                                          train_cfg.batch_size * 2, seed=123),
                                off_te[j])
                # the streams a sequential fit(seed=random_state + 200 +
                # fold) draws
                (iseed,), (rseed,) = engine.seed_streams(
                    random_state + 200 + fold, 1)
                if search.best_model is not None:
                    # weight_reset: fresh Linear/Conv, keep trained BN
                    init_trees.append(_reset(spec, hp, search.best_model,
                                             random_state, fold))
                else:
                    _warn_no_best_model(study_name, fold)
                    init_trees.append(spec.init(
                        torch.Generator().manual_seed(int(iseed)), hp))
                hp_list.append(hp)
                opt_list.append(opt)
                run_seeds.append(rseed)
                train_plans.append(tp)
                eval_plans.append(ep)

            result = engine.fit(
                spec, hp_list, opt_list, cat_tr, cat_te, train_cfg,
                init_params=engine.stack_trials([t[0] for t in init_trees]),
                init_bn_state=engine.stack_trials([t[1] for t in init_trees]),
                verbose=verbose, train_plans=train_plans,
                eval_plans=eval_plans,
                run_seeds=np.asarray(run_seeds, np.uint32), device=device,
                mesh=mesh)

            trees = tree_to_numpy((result.params, result.bn_state))
            for j, (fold, *_rest) in enumerate(pending):
                search = searches[j]
                fold_scores = {
                    "AUPRC_train": result.auprc_train[j],
                    "AUPRC_test": result.auprc_test[j],
                    "F1_precision_recall": result.f1_precision_recall[j],
                }
                self.scores_dict[f"iteration_n_{fold}"] = fold_scores
                trial0_tree = engine._trial(trees, j)
                fold_ck = os.path.join(checkpoint_dir,
                                       f"{study_name}_fold{fold}_result")
                save_checkpoint(fold_ck,
                                {"params": trial0_tree[0],
                                 "bn_state": trial0_tree[1]},
                                meta={"scores": fold_scores,
                                      "best_params": search.best_params,
                                      "model": model, "model_params":
                                      search.best_params}, mesh=mesh)
                fold_final[fold] = (result.final_test_auprc[j],
                                    result.final_train_auprc[j],
                                    trial0_tree, search.best_params)
                if verbose:
                    print(f"fold {fold} test AUPRC: "
                          f"{fold_final[fold][0]:.4f}")

        # reference score-accounting order: folds ascending; the fold-best
        # checkpoint saves whenever a fold's score equals the running max
        # (resumed folds raise the bar but never save)
        avg_score = []
        for i in range(len(folds)):
            fold = i + 1
            if fold in resumed:
                final_test, final_train = resumed[fold]
                self.scores_dict["final_test_AUPRC_scores"].append(final_test)
                self.scores_dict["final_train_AUPRC_scores"].append(final_train)
                avg_score.append(final_test)
                continue
            final_test, final_train, trial0_tree, best_params = \
                fold_final[fold]
            self.scores_dict["final_test_AUPRC_scores"].append(final_test)
            self.scores_dict["final_train_AUPRC_scores"].append(final_train)
            avg_score.append(final_test)
            if final_test == max(avg_score) and test_model_path:
                save_checkpoint(
                    os.path.join(checkpoint_dir, test_model_path),
                    {"params": trial0_tree[0], "bn_state": trial0_tree[1]},
                    meta={"model_params": best_params,
                          "model": model, "cell_line": cell_line,
                          "task": task, "fold": fold}, mesh=mesh)

        avg = float(np.round(sum(avg_score) / cv_cfg.n_folds, 5))
        self.scores_dict["average_CV_AUPRC"] = avg
        if verbose:
            print(f"{cv_cfg.n_folds}-fold CV AUPRC: {avg}")
        return dict(self.scores_dict)


def checkpoint_name(cell_line: str, model: str, task: str, fold: int,
                    augmentation: bool = False) -> str:
    """Reference filename protocol
    (`training_models_multimodal.py:792`)."""
    augm = "_augmentation" if augmentation else ""
    return f"{cell_line}_{model}{augm}_{task}_{fold}_test_"
