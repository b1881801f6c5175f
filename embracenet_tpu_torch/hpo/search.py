"""Hyperparameter search as one population (Param_Search equivalent; port
of ``embracenet_tpu/hpo/search.py``).

Reference: ``Param_Search`` / ``Param_Search_Multimodal``
(`BIOINF_tesi/models/utils/training_models.py:192-399`,
`training_models_multimodal.py:232-462`) run trials *sequentially*, each a
full train loop.  Here the study's remaining trials are sampled up front and
trained together as one ``engine.fit`` population.

Semantics preserved:
  * objective = per-epoch test AUPRC, early stopping patience 4;
  * resume accounting (only ``n_trials - n_complete`` new trials);
  * per-trial intermediate values persisted; optional pruning via the
    reference's MedianPruner-in-PatientPruner stack (inert at 3 trials/study,
    as in the reference) or same-epoch population median (``prune="population"``);
  * per-trial final weights checkpointed as ``{study_name}{number}`` (the
    reference saves ``{study_name}{trial}.pt``, `training_models.py:350`);
  * ``best_trial`` = argmax final objective over all completed trials.

Integer seeds take the place of the JAX package's PRNG keys: group ``gi``
of ``run_search`` fits with ``seed + 7919 * gi``, and ``run_search_fused``
pins each fold's trials to ``engine.seed_streams(seeds[f], rem)``, the
streams a sequential fit of that fold would draw.  ``plan_buckets`` is
called without ``in_features``, as the JAX package calls it, so its cost
model counts 256 features whatever the data has and both packages form the
same groups.  Fits run on the card unless ``device`` says otherwise.

Under a mesh (``mesh=``, ``parallel/mesh.py``) every rank runs the same
search: each fit gathers every trial's metrics to every rank, so every
rank's sampler proposes the same trials from the same history.  Rank 0
alone writes the study file and the checkpoints; the other ranks keep the
study in memory, started from rank 0's trials (``study.open_study``), and
take the best trial's weights from rank 0.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np

from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.convert import tree_map, tree_to_numpy
from embracenet_tpu_torch.hpo import space as space_mod
from embracenet_tpu_torch.hpo.samplers import get_sampler, sample_n
from embracenet_tpu_torch.hpo.study import (COMPLETE, PRUNED, MedianPruner,
                                            PatientPruner, Study, open_study)
from embracenet_tpu_torch.parallel.mesh import broadcast, is_writer, resolve_mesh
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from embracenet_tpu_torch.training.modelspec import ModelSpec


@dataclasses.dataclass
class SearchResult:
    best_params: dict           # flat reference-named hyperparameters
    best_value: float
    best_model: Any             # (params, bn_state) of the best trial or None
    n_complete: int
    n_pruned: int


def _per_trial(result, idxs, per_trial):
    """Slice a fit's stacked trees into ``per_trial[i] = ((params, bn),
    test AUPRC history)``: one copy of the stacked trees to the host, then
    numpy views along the trial axis."""
    trees = tree_to_numpy((result.params, result.bn_state))
    for lt, i in enumerate(idxs):
        per_trial[i] = (tuple(tree_map(lambda a, lt=lt: a[lt], tree)
                              for tree in trees),
                        result.auprc_test[lt])


def _prune_decision(prune, pruner, completed, epoch, value, hist, at_epoch):
    """Whether to prune a trial at ``epoch`` (``hist`` is its own history,
    ``at_epoch`` the values its population reached at that epoch)."""
    if prune == "reference":
        return pruner.should_prune(completed, epoch, value, hist)
    if prune == "population":
        at_e = sorted(v for v in at_epoch if v is not None)
        return (len(at_e) >= 3 and len(hist) > 2
                and value < at_e[len(at_e) // 2]
                and hist[-1] <= max(hist[:-1]))
    return False


def _tell(study, number, flat, per_trial, pruned, intermediate,
          checkpoint_dir, study_name, model, mesh=None):
    value = per_trial[1][-1] if per_trial[1] else 0.0
    study.tell(number, flat, None if pruned else value,
               PRUNED if pruned else COMPLETE, intermediate)
    if checkpoint_dir and not pruned:
        params, bn_state = per_trial[0]
        save_checkpoint(os.path.join(checkpoint_dir, f"{study_name}{number}"),
                        {"params": params, "bn_state": bn_state},
                        meta={"model": model, "model_params": flat,
                              "value": value}, mesh=mesh)


def run_search(spec: ModelSpec,
               model: str,
               data_train: dict,
               data_val: dict,
               study_name: str,
               storage: str = "optuna_tuning.db",
               sampler: str = "TPE",
               n_trials: int = 3,
               train_cfg: TrainConfig = TrainConfig(),
               prune: str = "reference",
               checkpoint_dir: str | None = None,
               seed: int = 0,
               verbose: bool = False,
               fit_kwargs: dict | None = None,
               device=None, mesh=None) -> SearchResult:
    """Run (or resume) a study; returns the best trial across all runs.
    ``mesh``: every fit's mesh (see the module docstring)."""
    mesh = resolve_mesh(mesh, device)
    study = open_study(study_name, storage, mesh)
    completed = study.completed_trials()
    remaining = max(0, n_trials - len(completed))

    if remaining > 0:
        # `sampler` may be a name from the reference menu or a sampler
        # object (e.g. ReplaySampler for paired benchmarks / fixed grids)
        smp = sampler if hasattr(sampler, "sample") \
            else get_sampler(sampler, seed=seed)
        flat_list = sample_n(smp, model, remaining, study.history())
        hp_list = [space_mod.params_to_hp(model, f) for f in flat_list]
        opt_list = [space_mod.optimizer_hp(f) for f in flat_list]
        numbers = [study.next_number() + i for i in range(remaining)]

        pruner = PatientPruner(MedianPruner(), patience=2)
        intermediates: list[dict] = [dict() for _ in range(remaining)]
        pruned_flags = [False] * remaining

        def report_fn(t, epoch, value):
            intermediates[t][epoch] = value
            hist = [intermediates[t][e] for e in sorted(intermediates[t])]
            do = _prune_decision(prune, pruner, completed, epoch, value, hist,
                                 [iv.get(epoch) for iv in intermediates])
            if do:
                pruned_flags[t] = True
            return do

        if spec.vmappable:
            # width-bucketed sub-populations: split the population into cost
            # groups so narrow/shallow trials stop paying the widest trial's
            # supernet FLOPs (plan_buckets only splits when the projected
            # saving clears its threshold)
            groups = [list(range(remaining))]
            if train_cfg.width_buckets and remaining > 1:
                from embracenet_tpu_torch.training.bucketing import plan_buckets

                groups = plan_buckets(spec, model, hp_list)
        else:
            # trial shapes differ per architecture (e.g. CNN_LSTM): trials
            # sharing one statics signature still train together; only
            # distinct architectures run as separate fits
            sig_to_idxs: dict = {}
            for i, hp in enumerate(hp_list):
                sig = tuple(sorted(spec.statics([hp]).items())) \
                    if spec.statics else i
                sig_to_idxs.setdefault(sig, []).append(i)
            groups = list(sig_to_idxs.values())

        per_trial = [None] * remaining
        for gi, idxs in enumerate(groups):
            result = engine.fit(
                spec, [hp_list[i] for i in idxs],
                [opt_list[i] for i in idxs], data_train, data_val,
                train_cfg,
                seed=seed if gi == 0 else seed + 7919 * gi,
                verbose=verbose,
                report_fn=(lambda lt, e, v, idxs=idxs:
                           report_fn(idxs[lt], e, v)),
                device=device, mesh=mesh,
                **(fit_kwargs or {}))
            _per_trial(result, idxs, per_trial)

        for t in range(remaining):
            _tell(study, numbers[t], flat_list[t], per_trial[t],
                  pruned_flags[t], intermediates[t], checkpoint_dir,
                  study_name, model, mesh)

    res = _study_result(study, study_name, checkpoint_dir, verbose, mesh)
    study.close()
    return res


def _study_result(study: Study, study_name: str, checkpoint_dir,
                  verbose: bool, mesh=None) -> SearchResult:
    """Best-trial summary of a (possibly just-updated) study; under a mesh
    the best trial's weights are rank 0's file, broadcast."""
    best = study.best_trial
    best_model = None
    if checkpoint_dir and is_writer(mesh):
        path = os.path.join(checkpoint_dir, f"{study_name}{best.number}.npz")
        if os.path.exists(path):
            trees, _ = load_checkpoint(path)
            best_model = (trees["params"], trees.get("bn_state", {}))
    best_model = broadcast(mesh, best_model)
    n_pruned = len(study.pruned_trials())
    res = SearchResult(best_params=best.params, best_value=best.value,
                       best_model=best_model,
                       n_complete=len(study.completed_trials()),
                       n_pruned=n_pruned)
    if verbose:
        print(f"study {study_name}: {res.n_complete} complete, "
              f"{n_pruned} pruned, best value {res.best_value:.4f}")
    return res


def run_search_fused(spec: ModelSpec,
                     model: str,
                     fold_data: list,
                     study_names: list[str],
                     seeds: list[int],
                     storage: str = "optuna_tuning.db",
                     sampler: str = "TPE",
                     n_trials: int = 3,
                     train_cfg: TrainConfig = TrainConfig(),
                     prune: str = "reference",
                     checkpoint_dir: str | None = None,
                     verbose: bool = False,
                     fit_kwargs: dict | None = None,
                     device=None, mesh=None) -> list[SearchResult]:
    """Several folds' hyperparameter searches as ONE population.

    ``fold_data``: per fold a ``(data_train, data_val)`` pair;
    ``study_names``/``seeds``: per-fold study identity and sampler/RNG seed
    (matching what sequential per-fold ``run_search`` calls would use).

    Where the reference runs `Param_Search` once per CV fold — each a full
    sequential Optuna loop (`training_models.py:482-520`) — and the
    sequential path here runs one fit per fold, this fuses all folds'
    trials into a single population: the train/val splits of every fold are
    concatenated row-wise and each trial's batch plan indexes only its own
    fold's rows.  Per-trial seeds are pinned via ``engine.seed_streams`` so
    every trial trains as the (unbucketed) sequential fit that would have
    produced it.  Study accounting (sampling, resume, pruning, telling,
    per-trial checkpoints) stays per fold.
    """
    from embracenet_tpu_torch.training.batching import (balanced_plan,
                                                        eval_plan, shift_plan)

    if not spec.vmappable:
        raise ValueError("run_search_fused needs a vmappable spec "
                         "(architecture-dependent shapes cannot share a "
                         "population)")
    n_folds = len(fold_data)
    mesh = resolve_mesh(mesh, device)
    studies = [open_study(study_names[f], storage, mesh) for f in range(n_folds)]
    parts: list[tuple[int, int]] = []       # (fold, remaining)
    for f in range(n_folds):
        rem = max(0, n_trials - len(studies[f].completed_trials()))
        if rem > 0:
            parts.append((f, rem))

    if parts:
        # per-fold sampling (same sampler construction + history warm-start
        # as sequential run_search)
        fold_of: list[tuple[int, int]] = []  # global trial -> (fold, local)
        flat_list, hp_list, opt_list, numbers = [], [], [], []
        init_seeds, run_seeds = [], []
        for f, rem in parts:
            smp = sampler if hasattr(sampler, "sample") \
                else get_sampler(sampler, seed=seeds[f])
            flats = sample_n(smp, model, rem, studies[f].history())
            base = studies[f].next_number()
            iseeds, rseeds = engine.seed_streams(seeds[f], rem)
            for lt in range(rem):
                fold_of.append((f, lt))
                flat_list.append(flats[lt])
                hp_list.append(space_mod.params_to_hp(model, flats[lt]))
                opt_list.append(space_mod.optimizer_hp(flats[lt]))
                numbers.append(base + lt)
                init_seeds.append(iseeds[lt])
                run_seeds.append(rseeds[lt])
        n_total = len(hp_list)

        # concatenated data + per-trial plans addressing each fold's rows
        views = tuple(spec.inputs) + ("y",)
        cat_tr, off_tr = concat_fold_views(
            [fold_data[f][0] for f, _ in parts], views)
        cat_va, off_va = concat_fold_views(
            [fold_data[f][1] for f, _ in parts], views)
        tr_plan_of, va_plan_of = {}, {}
        for j, (f, _) in enumerate(parts):
            y_f = np.asarray(fold_data[f][0]["y"])
            tr_plan_of[f] = shift_plan(
                balanced_plan(y_f, train_cfg.batch_size, seed=123), off_tr[j])
            va_plan_of[f] = shift_plan(
                eval_plan(len(np.asarray(fold_data[f][1]["y"])),
                          train_cfg.batch_size * 2, seed=123), off_va[j])
        train_plans = [tr_plan_of[fold_of[g][0]] for g in range(n_total)]
        eval_plans = [va_plan_of[fold_of[g][0]] for g in range(n_total)]

        # pruning state per fold (reference MedianPruner-in-PatientPruner is
        # per-study; population pruning compares within a fold only)
        pruners = {f: PatientPruner(MedianPruner(), patience=2)
                   for f, _ in parts}
        completed_of = {f: studies[f].completed_trials() for f, _ in parts}
        intermediates: list[dict] = [dict() for _ in range(n_total)]
        pruned_flags = [False] * n_total

        def report_fn(g, epoch, value):
            f, _ = fold_of[g]
            intermediates[g][epoch] = value
            hist = [intermediates[g][e] for e in sorted(intermediates[g])]
            do = _prune_decision(prune, pruners[f], completed_of[f], epoch,
                                 value, hist,
                                 [intermediates[j].get(epoch)
                                  for j in range(n_total)
                                  if fold_of[j][0] == f])
            if do:
                pruned_flags[g] = True
            return do

        groups = [list(range(n_total))]
        if train_cfg.width_buckets and n_total > 1:
            from embracenet_tpu_torch.training.bucketing import plan_buckets

            groups = plan_buckets(spec, model, hp_list)

        per_trial = [None] * n_total
        for idxs in groups:
            result = engine.fit(
                spec, [hp_list[i] for i in idxs],
                [opt_list[i] for i in idxs], cat_tr, cat_va, train_cfg,
                verbose=verbose,
                report_fn=(lambda lt, e, v, idxs=idxs:
                           report_fn(idxs[lt], e, v)),
                train_plans=[train_plans[i] for i in idxs],
                eval_plans=[eval_plans[i] for i in idxs],
                # every group's batches run the widest fold's rows, as a
                # sequential CV's fits do
                plan_rows=(max(p.idx.shape[1] for p in train_plans),
                           max(p.idx.shape[1] for p in eval_plans)),
                init_seeds=np.asarray([init_seeds[i] for i in idxs], np.uint32),
                run_seeds=np.asarray([run_seeds[i] for i in idxs], np.uint32),
                device=device, mesh=mesh,
                **(fit_kwargs or {}))
            _per_trial(result, idxs, per_trial)

        for g in range(n_total):
            f, _ = fold_of[g]
            _tell(studies[f], numbers[g], flat_list[g], per_trial[g],
                  pruned_flags[g], intermediates[g], checkpoint_dir,
                  study_names[f], model, mesh)

    results = []
    for f in range(n_folds):
        results.append(_study_result(studies[f], study_names[f],
                                     checkpoint_dir, verbose, mesh))
        studies[f].close()
    return results


def concat_fold_views(datas: list[dict], views) -> tuple[dict, list[int]]:
    """Row-concatenate per-fold data dicts; returns (concat, row offsets)."""
    offsets, total = [], 0
    for d in datas:
        offsets.append(total)
        total += len(np.asarray(d["y"]))
    cat = {v: np.concatenate([np.asarray(d[v]) for d in datas])
           for v in views}
    return cat, offsets
