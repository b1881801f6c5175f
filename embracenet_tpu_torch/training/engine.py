"""Population training engine (port of ``embracenet_tpu/training/engine.py``).

Replaces the reference's per-batch Python loops (`BIOINF_tesi/models/utils/
training_models.py:31-186` ``fit`` and the Optuna objective's inner loop):

  * the fold's train/test set lives on the device; an epoch walks a padded
    batch-index matrix (see batching.py) and gathers each batch there;
  * a *population* of T trials (different architectures via supernet masks,
    different optimizers/lr/wd via the branchless update) trains as one
    program, as ``jax.jit(jax.vmap(chunk_one))`` trains it in the JAX
    package: params, BN state, optimizer state and hyperparameters carry a
    leading trial axis ``[T, ...]``, and every batch step runs one forward
    pass, one loss, one autograd backward and one optimizer update for all
    T trials (:func:`population_step`).  The fused kernel is launched once
    per population forward pass, with the trial axis in its grid.  Only the
    random draws go trial by trial (``models.layers.Draws``): trial t draws
    from its own generator at the shape its fit alone has, so it draws what
    that fit draws, and the values it computes equal that fit's up to the
    summation order of batched products (exactly where they sum alike);
  * per-batch INS-weighted cross entropy, per-batch argmax-AUPRC and the
    reference's metric averaging (divide by ``len(loader)``) are preserved;
  * early stopping (patience on test AUPRC, `models/utils/utils.py:23-67`)
    runs on the device: best, counter, stopped and epochs run are device
    tensors, and a stopped trial, like a fully masked batch or a padded
    batch of a shorter per-trial plan, keeps its params, BN state and
    optimizer state through a select (a ``[T]`` mask).  Nothing inside
    an epoch chunk waits for the device: the host reads the metrics once a
    chunk is enqueued (with ``pipeline_chunks``, once the next one is).

Runs on the CUDA card unless the caller passes ``device="cpu"``.  For
EmbraceNetMultimodal the docking + embracement runs in the fused CUDA
kernel and its gradient (``ops/embrace.py``) unless
``TrainConfig.fused_embrace`` is False.  A step's new params, BN state and
optimizer state replace the old ones, as the JAX update computes them.

Random streams: the JAX PRNG keys become per-trial integer seeds
(:func:`seed_streams`): an init seed feeds the trial's CPU
``torch.Generator`` for its parameter init, whose numbers the fit draws on
its device (:func:`init_population`; on the card the MT19937 kernel), a run
seed a numpy generator that gives every batch step of the trial its
forward seed, the seed of the step's generator of that trial.  Same
distributions as the JAX package, different streams.

Spans and counters (``utils.profiling``; spans record only inside a torch
profile): ``engine.fit`` holds ``engine.fit.setup`` (everything before the
first step: the init drawn on the fit's device, every copy to the device,
the plans), one ``engine.step`` a stacked train step
(``engine.step.gather``, ``engine.step.draws`` and, in
:func:`population_step`, ``engine.forward``, ``engine.backward`` and
``engine.update``), one ``engine.eval`` an epoch's evaluation and one
``engine.fetch`` a chunk's metric fetch and host bookkeeping.  The
counters ``engine.train_steps``, ``engine.to_device_bytes`` and
``engine.init_device_draws`` count the stacked train steps, the bytes a
fit copies to its device and the initial parameters a fit draws on its
device.

Under a mesh (``parallel/mesh.py``) each rank trains its block of the
population (the trial axes) on its columns of every batch (the 'data'
axis).  The population is padded to the trial axes with copies of its last
trial; every rank of a data group takes the same step seed, every per-row
draw is taken by global row and every reduction over the batch is a sum
over the data group (``parallel.mesh.BatchShard``), so a sharded fit draws
and sums what the meshless fit does; a stacked step sums each quantity of
all local trials in one all-reduce.  The host reads the per-trial metrics
of all blocks at each chunk, so early exit, pruning and callbacks decide
alike on every rank, and every rank returns the whole population.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from embracenet_tpu_torch import resolve_device
from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.convert import (tree_leaves, tree_map, tree_to_torch,
                                          tree_unflatten)
from embracenet_tpu_torch.models.layers import (Draws, InitPlan, Trials,
                                                exact_float32, one_trial,
                                                population_invariant,
                                                stack_hps)
from embracenet_tpu_torch.ops import losses, metrics, optim
from embracenet_tpu_torch.ops.mt19937 import uniform_init
from embracenet_tpu_torch.parallel.mesh import (BatchShard, batch_sharding,
                                                gather_trials, resolve_mesh,
                                                shard_population,
                                                trial_device_count)
from embracenet_tpu_torch.training import slicing
from embracenet_tpu_torch.training.batching import balanced_plan, eval_plan
from embracenet_tpu_torch.training.modelspec import ModelSpec
from embracenet_tpu_torch.utils.profiling import annotate, count, spanned


@dataclasses.dataclass
class FitResult:
    params: Any                 # stacked over trials, on the fit's device
    bn_state: Any
    auprc_train: list           # per trial: list of per-epoch floats
    auprc_test: list
    f1_precision_recall: list   # per trial: list of [p, r, f1]
    epochs_run: list            # per trial
    loss_train: list = dataclasses.field(default_factory=list)
    #                             per trial: per-epoch mean train loss (the
    #                             JAX FitResult does not keep it)

    @property
    def final_test_auprc(self):
        return [h[-1] if h else 0.0 for h in self.auprc_test]

    @property
    def final_train_auprc(self):
        return [h[-1] if h else 0.0 for h in self.auprc_train]


class EarlyStopping:
    """Reference-parity early stopping (`models/utils/utils.py:23-67`):
    counter increments when score < best + delta, resets (and updates best)
    otherwise; stop when counter >= patience."""

    def __init__(self, patience: int = 4, delta: float = 0.0):
        self.patience = patience
        self.delta = delta
        self.best = None
        self.counter = 0
        self.stop = False

    def __call__(self, score: float) -> bool:
        if self.best is None:
            self.best = score
        elif score < self.best + self.delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.stop = True
        else:
            self.best = score
            self.counter = 0
        return self.stop


def early_stop_update(es, score, patience: int, delta: float):
    """One epoch of :class:`EarlyStopping` for every trial at once, on the
    device (JAX ``engine.py:323-336``).  ``es`` = (best, counter, stopped,
    epochs_run), tensors of shape [T]; ``best`` starts at -inf.  A stopped
    trial's state stays as it was."""
    best, counter, stopped, epochs_run = es
    first = torch.isinf(best)
    improved = first | (score >= best + delta)
    new_best = torch.where(improved, score, best)
    new_counter = torch.where(improved, torch.zeros_like(counter), counter + 1)
    new_stopped = stopped | (~stopped & (new_counter >= patience))
    new_epochs = torch.where(stopped, epochs_run, epochs_run + 1)
    return (torch.where(stopped, best, new_best),
            torch.where(stopped, counter, new_counter),
            new_stopped, new_epochs)


def stack_trials(trees):
    """Per-trial trees (tensors or numpy) -> one tree stacked over trials."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(np.asarray(x))
                                             if not isinstance(x, torch.Tensor)
                                             else x for x in xs]), *trees)


def seed_streams(seed: int, n_trials: int):
    """fit()'s per-trial seeds, the counterpart of the JAX ``key_streams``:
    ``(init_seeds [T], run_seeds [T])`` as uint32 numpy arrays.  A caller
    that passes them to single-trial fits reproduces a population's trials
    exactly."""
    children = np.random.SeedSequence(int(seed)).spawn(n_trials + 1)
    init = [c.generate_state(1)[0] for c in children[1:]]
    run = [c.generate_state(1)[0] for c in children[0].spawn(n_trials)]
    return np.asarray(init, np.uint32), np.asarray(run, np.uint32)


def _resolve_statics(spec: ModelSpec, hp_list, cfg: TrainConfig) -> dict:
    """Static shape knobs for this population after config overrides.
    EmbraceNetMultimodal runs through the fused kernel (as in serving)
    unless ``fused_embrace`` is False, which keeps the unfused path.
    The JAX package's automatic rule was tuned on its own hardware and is
    not carried over."""
    statics = spec.statics(hp_list) if spec.statics else {}
    width_keys = ("cnn_max_channels", "cnn_max_kernels", "ffnn_max_width",
                  "embrace_max", "post_max")
    if not cfg.width_buckets:
        for k in width_keys:
            statics.pop(k, None)
    if cfg.fused_embrace is not False and spec.name == "EmbraceNetMultimodal":
        statics["fused_embrace"] = True
    return statics


def _to_device(tree, device):
    """``tree`` (tensors or numpy arrays) as tensors on ``device``, every
    leaf a copy of its own, its bytes added to the
    ``engine.to_device_bytes`` counter whatever the device."""
    out = tree_map(lambda a: torch.as_tensor(a).to(device, copy=True)
                   .contiguous(), tree)
    count("engine.to_device_bytes", sum(a.nbytes for a in tree_leaves(out)))
    return out


def host_init(spec: ModelSpec, hps, seeds):
    """The population's init drawn on the host, ``(params, bn_state)``
    stacked over trials on the CPU: trial t's ``spec.init`` from a CPU
    ``torch.Generator`` seeded with ``seeds[t]``.  The reference that
    :func:`init_population` is held to."""
    inits = [spec.init(torch.Generator().manual_seed(int(s)), hp)
             for s, hp in zip(seeds, hps)]
    return (stack_trials([i[0] for i in inits]),
            stack_trials([i[1] for i in inits]))


def init_population(spec: ModelSpec, hps, seeds, device):
    """The population's init, ``(params, bn_state)`` stacked over trials on
    ``device``: trial t's numbers are what its init draws from a CPU
    ``torch.Generator`` seeded with ``seeds[t]``, bit for bit.  Each
    trial's init runs once against a ``layers.InitPlan``, which records its
    draws (shapes and bounds, in stream order); ``ops/mt19937.uniform_init``
    then draws them all, on the card by its kernel, written in place with
    no host draw and no copy, on the CPU by its plain version.  Leaves the
    init does not draw (BatchNorm's constants) are stacked and copied.
    Counts the numbers drawn in ``engine.init_device_draws``."""
    plans = [InitPlan() for _ in hps]
    trees = [spec.init(plan, hp) for plan, hp in zip(plans, hps)]
    shapes = plans[0].shapes
    if any(p.shapes != shapes for p in plans):
        raise ValueError(f"{spec.name}: the trials draw leaves of different "
                         "shapes; a population stacks one shape a leaf")
    drawn = uniform_init(shapes, [p.bounds for p in plans], seeds, device)
    count("engine.init_device_draws", sum(d.numel() for d in drawn))
    where = [{id(leaf): k for k, leaf in enumerate(p.leaves)} for p in plans]

    def stacked(*leaves):
        ks = {w.get(id(a)) for w, a in zip(where, leaves)}
        if ks == {None}:
            return _to_device(torch.stack([torch.as_tensor(a)
                                           for a in leaves]), device)
        if len(ks) != 1:
            raise ValueError(f"{spec.name}: the trials put different draws "
                             "at one leaf")
        return drawn[ks.pop()]

    return (tree_map(stacked, *[t[0] for t in trees]),
            tree_map(stacked, *[t[1] for t in trees]))


def _device_data(data, spec: ModelSpec, device):
    """The split's arrays as tensors on the device (the JAX engine also pads
    the rows to a bucket of 512 to reuse compiled programs; eager PyTorch
    has none to reuse)."""
    out = {"y": np.asarray(data["y"], np.int64)}
    if "ffnn" in spec.inputs:
        out["ffnn"] = np.asarray(data["ffnn"], np.float32)
    if "cnn" in spec.inputs:
        out["cnn"] = np.asarray(data["cnn"], np.uint8)
    return _to_device(out, device)


def _pad_plan(plan, n_batches: int, width: int):
    """A BatchPlan padded to (n_batches, width) with masked rows, so that
    per-trial plans of different shapes stack: in a padded batch a trial
    is frozen and draws nothing, and its rows past its width are masked.
    The JAX engine also rounds both up to buckets (4 batches, 16 rows) to
    reuse compiled programs."""
    idx = np.zeros((n_batches, width), np.int64)
    mask = np.zeros((n_batches, width), np.float32)
    idx[:plan.idx.shape[0], :plan.idx.shape[1]] = plan.idx
    mask[:plan.mask.shape[0], :plan.mask.shape[1]] = plan.mask
    return idx, mask


def _stack_plans(ps, device, n_data: int = 1, rows: int = 0):
    """[P, nb, bw] plan tensors on the device (P = 1 for a shared plan);
    ``bw`` covers every plan's width and ``rows``, rounded up to a multiple
    of ``n_data``, so each data shard's columns exist (masked past a
    plan's own width)."""
    nb = max(p.idx.shape[0] for p in ps)
    bw = max(-(-max(p.idx.shape[1], rows) // n_data) * n_data for p in ps)
    padded = [_pad_plan(p, nb, bw) for p in ps]
    return _to_device((np.stack([p[0] for p in padded]),
                       np.stack([p[1] for p in padded])), device)


def _gather(data, idx, spec: ModelSpec):
    inputs = {k: data[k][idx] for k in ("ffnn", "cnn") if k in spec.inputs}
    return inputs, data["y"][idx]


def _trial(tree, t: int):
    """Trial ``t``'s slice of a tree stacked over trials."""
    return tree_map(lambda a: a[t], tree)


def _sum_grads(shard, grads):
    """The data group's sum of each gradient, in one all-reduce (float32;
    a leaf without a gradient has none on any rank)."""
    have = [g for g in grads if g is not None]
    flat = shard.sum(torch.cat([g.reshape(-1).float() for g in have]))
    sums = iter(s.view(g.shape).to(g.dtype) for s, g in
                zip(flat.split([g.numel() for g in have]), have))
    return [None if g is None else next(sums) for g in grads]


def population_step(spec: ModelSpec, params, bn_state, opt_state, trials,
                    opt_hp, inputs, y, mask, compute_dtype, statics,
                    shard=None, upd=None):
    """One batch step of a whole population: one forward pass
    (``spec.apply_trials``), the per-trial weighted CE, one autograd
    backward of their sum (each trial's gradient is its own) and one
    optimizer update of the stacked tree.  ``trials`` (a
    ``layers.Trials``) carries the step's draws; ``opt_hp`` holds ``[T]``
    tensors; ``inputs`` and ``y`` are ``[B, ...]`` (shared by every trial)
    or ``[T, B, ...]``, ``mask`` ``[T, B]``.  ``upd`` (``[T]`` bool,
    optional) freezes the trials where it is False.  Returns ``(loss [T],
    logits [T, B, 2], new_params, new_bn_state, new_opt_state)``.  For a
    ``shard`` of a data-sharded batch the losses are the whole batch's
    and the gradients are summed over the data group (one all-reduce for
    all trials) before the update, so every rank of the group updates
    alike."""
    if y.dim() == 1:
        y = y.expand(len(trials), -1)
    leaves = [a.detach().requires_grad_(True) for a in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    # the backward pass too in full float32: cuDNN would take its
    # convolutions' and LSTM's gradients in TF32 outside this context
    with exact_float32():
        with annotate("engine.forward"):
            logits, new_bn = spec.apply_trials(live, bn_state, trials, inputs,
                                               True, mask, compute_dtype,
                                               statics, shard)
            loss = losses.weighted_cross_entropy(logits, y, mask, shard=shard)
        with annotate("engine.backward"):
            grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    with annotate("engine.update"):
        if shard is not None:
            grads = _sum_grads(shard, grads)
            loss = shard.sum(loss.detach())
        new_params, new_opt = optim.apply_update(
            params, tree_unflatten(params, grads), opt_state,
            opt_hp["optimizer"], opt_hp["lr"], opt_hp["weight_decay"], upd)
        new_bn = tree_map(torch.Tensor.detach, new_bn)
        if upd is not None:
            new_bn = tree_map(lambda n, o: torch.where(
                upd.reshape((-1,) + (1,) * (o.dim() - 1)), n, o), new_bn,
                bn_state)
    return loss.detach(), logits.detach(), new_params, new_bn, new_opt


def train_step(spec: ModelSpec, params, bn_state, opt_state, hp, opt_hp,
               inputs, y, mask, seed: int, compute_dtype, statics, shard=None):
    """One trial's batch step: :func:`population_step` of a population of
    one, its draws from a ``torch.Generator`` seeded with ``seed``.
    Returns ``(loss, logits, new_params, new_bn_state, new_opt_state)``;
    the caller decides whether the new state is kept."""
    trials, stack, unstack = one_trial(hp, y.shape[0], y.device, seed, True,
                                       shard)
    loss, logits, new_p, new_bn, new_opt = population_step(
        spec, stack(params), stack(bn_state), stack(opt_state), trials,
        stack(opt_hp), inputs, y, stack(mask), compute_dtype, statics, shard)
    return loss[0], logits[0], unstack(new_p), unstack(new_bn), \
        unstack(new_opt)


def _auprc_of(cfg, logits, y, mask, shard=None):
    if cfg.auprc_on_probabilities:
        return metrics.auprc_prob(torch.softmax(logits, -1)[..., 1], y, mask,
                                  shard)
    return metrics.auprc_argmax(logits, y, mask, shard)


def _pad_population(n_pad: int, lists, trees):
    """Each per-trial list and each tree stacked over trials (None stays
    None) with ``n_pad`` copies of its last trial appended."""
    lists = [None if v is None else list(v) + [v[-1]] * n_pad for v in lists]
    trees = [None if t is None else tree_map(
        lambda a: torch.cat([a, a[-1:].expand(n_pad, *a.shape[1:])]),
        tree_to_torch(t, "cpu")) for t in trees]
    return lists, trees


def _gather_population(mesh, trees, n_real: int, device):
    """Every trial block's trees (stacked over its trials), concatenated in
    trial order on every rank and cut to the real population."""
    blocks = gather_trials(mesh, tree_map(lambda a: a.detach().cpu(), trees))
    return _to_device(tree_map(lambda *xs: torch.cat(xs)[:n_real], *blocks),
                      device)


@spanned("engine.fit")
def fit(spec: ModelSpec,
        hp_list: list,
        opt_list: list,
        data_train: dict,
        data_test: dict,
        cfg: TrainConfig = TrainConfig(),
        seed: int | None = None,
        init_params=None,
        init_bn_state=None,
        verbose: bool = False,
        report_fn=None,
        mesh=None,
        train_plans: list | None = None,
        eval_plans: list | None = None,
        init_seeds=None,
        run_seeds=None,
        chunk_callback=None,
        device=None,
        plan_rows=(0, 0)) -> FitResult:
    """Train a population of trials on one (train, test) split.

    ``hp_list``/``opt_list``: per-trial concrete hyperparameter dicts
    (architecture / {optimizer, lr, weight_decay}).  ``seed`` (default
    ``cfg.seed``) derives the per-trial ``init_seeds`` / ``run_seeds``
    (:func:`seed_streams`) unless they are given.  ``init_params`` /
    ``init_bn_state``: trees stacked over trials (numpy arrays, tensors, or
    a JAX ``FitResult``'s params through numpy); without them the fit
    draws its init on its device (:func:`init_population`), the same
    numbers on either.  ``report_fn`` (optional)
    is called per epoch with (trial_idx, epoch, test_auprc) -> bool prune.

    ``train_plans``/``eval_plans`` (optional): one BatchPlan per trial,
    indexing rows of ``data_train``/``data_test``.  Omitted: every trial
    trains the reference's balanced plan over the whole split.

    ``chunk_callback`` (optional) is called after every epoch chunk with
    ``(chunk_idx, n_epochs, wall_s, windows_per_epoch)``: ``wall_s`` covers
    dispatch, execution and the metric fetch of the chunk, and
    ``windows_per_epoch`` counts the real (unmasked) windows each live
    trial trained, trials that stopped inside the chunk only for the
    epochs they trained.

    Runs on the card unless ``device`` says otherwise (``"cpu"``).

    ``plan_rows`` = (train, eval): the fewest rows a batch of this fit
    runs, its plans padded with masked rows up to them.  A trial computes
    exactly what it computes in any population whose batches run as many
    rows (fold-fused CV pads every fold's plan to the widest fold's, so
    ``KfoldCV`` gives its sequential fits the fused stack's rows).

    ``mesh``: a ``parallel.mesh.Mesh``, a ``MeshConfig``, ``"auto"`` or
    None (``parallel.mesh.resolve_mesh``).  Every rank of the mesh calls
    fit with the same arguments; it trains on the mesh's device, and its
    result holds the whole real population on every rank.
    """
    with annotate("engine.fit.setup"):
        mesh = resolve_mesh(mesh, device)
        dev = mesh.device if mesh is not None else resolve_device(device)
        n_real = len(hp_list)
        if train_plans is not None and cfg.eval_reshuffle:
            raise ValueError("per-trial plans and eval_reshuffle are "
                             "exclusive (use the sequential per-fold path "
                             "for strict reference eval-shuffle parity)")
        if (train_plans is None) != (eval_plans is None):
            raise ValueError("train_plans and eval_plans go together")
        if train_plans is not None and (len(train_plans) != n_real
                                        or len(eval_plans) != n_real):
            raise ValueError("per-trial plans must match the population "
                             "size")
        s_init, s_run = seed_streams(cfg.seed if seed is None else seed,
                                     n_real)
        init_seeds = s_init if init_seeds is None else np.asarray(init_seeds)
        run_seeds = s_run if run_seeds is None else np.asarray(run_seeds)
        n_data = 1
        if mesh is not None:
            # pad the population to the trial axes with copies of its last
            # trial (same statics, so the real trials train as without it);
            # results are cut back to the real population
            pad = (-n_real) % trial_device_count(mesh)
            (hp_list, opt_list, init_seeds, run_seeds, train_plans,
             eval_plans), (init_params, init_bn_state) = _pad_population(
                pad, (hp_list, opt_list, init_seeds, run_seeds, train_plans,
                      eval_plans), (init_params, init_bn_state))
            n_data = mesh.shape["data"]
        n_trials = len(hp_list)            # the padded population
        compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                         else None)
        state_dtype = (torch.bfloat16 if cfg.optim_dtype == "bfloat16"
                       else None)
        use_master = cfg.param_dtype == "bfloat16"
        statics = _resolve_statics(spec, hp_list, cfg)
        shrunk = slicing.has_width_statics(statics)
        # this rank's trials (all of them without a mesh)
        hps, opts, my_init_seeds, my_run_seeds = shard_population(
            mesh, hp_list, opt_list, init_seeds, run_seeds)
        n_local = len(hps)

        # population init: each trial's numbers from its own CPU
        # generator's stream, drawn where the fit runs (init_population);
        # given trees are copied
        if init_params is None:
            params, bn_state = init_population(spec, hps, my_init_seeds, dev)
        else:
            params, bn_state = shard_population(
                mesh, tree_to_torch(init_params, "cpu"),
                tree_to_torch(init_bn_state or {}, "cpu"))
        if shrunk:
            params, bn_state = slicing.shrink(spec.name, params, bn_state,
                                              statics)
        if init_params is None:
            params, bn_state = tree_map(lambda a: a.contiguous(),
                                        (params, bn_state))
        else:
            params, bn_state = _to_device((params, bn_state), dev)
        opt_state = optim.init_state(params, state_dtype, use_master,
                                     lead=(n_local,))
        if use_master:
            params = tree_map(lambda a: a.to(torch.bfloat16), params)

        opt_hp = _to_device({k: np.asarray([o[k] for o in opts]) for k in
                             ("optimizer", "lr", "weight_decay")}, dev)
        opt_hp["lr"] = opt_hp["lr"].float()
        opt_hp["weight_decay"] = opt_hp["weight_decay"].float()

        train_data = _device_data(data_train, spec, dev)
        test_data = _device_data(data_test, spec, dev)
        n_test = len(np.asarray(data_test["y"]))
        if train_plans is None:
            all_plans = [balanced_plan(np.asarray(data_train["y"]),
                                       cfg.batch_size, seed=123)]
            all_tplans = [eval_plan(n_test, cfg.batch_size * 2, seed=123)]
            plans, tplans = all_plans, all_tplans
        else:
            all_plans, all_tplans = list(train_plans), list(eval_plans)
            plans, tplans = shard_population(mesh, all_plans, all_tplans)

        def _div_vec(ps):
            d = np.asarray([p.metric_divisor for p in ps], np.float32)
            return (np.broadcast_to(d, (n_trials,)).copy() if len(ps) == 1
                    else d)

        train_div = _div_vec(all_plans)    # [n_trials], read on the host
        eval_div = _div_vec(all_tplans)
        eval_div_dev = _to_device(shard_population(mesh, eval_div)[0], dev)

        plan_idx, plan_mask = _stack_plans(plans, dev, n_data, plan_rows[0])
        # each trial's own plan shape [nb, bw]: in a padded stack (fold-fused
        # plans) a trial steps through its own batches only (past them it
        # is frozen and draws nothing) and draws at its own width, so it
        # draws what the fit that had its plan alone draws
        train_dims = ([p.idx.shape for p in plans]
                      * (n_local if len(plans) == 1 else 1))
        eval_rows = max([p.idx.shape[1] for p in tplans] + [plan_rows[1]])
        if cfg.eval_reshuffle:
            # the reference reshuffles its test loader every epoch
            # (training_models.py:477); every epoch's plan goes to the
            # device now, so no chunk waits for a copy
            eval_plans_by_epoch = [
                _stack_plans([eval_plan(n_test, cfg.batch_size * 2,
                                        seed=123 + ep)],
                             dev, n_data, plan_rows[1])
                for ep in range(cfg.num_epochs)]
        else:
            eval_plans_by_epoch = [_stack_plans(
                tplans, dev, n_data, plan_rows[1])] * cfg.num_epochs
        plan_has_rows = plan_mask.sum(-1) > 0                    # [P, nb]

        def cols(bw):
            """This rank's columns of a plan row of width ``bw`` (the 'data'
            axis' share of it, padded to its multiple) and their shard."""
            if n_data == 1:
                return slice(0, bw), None
            c = batch_sharding(mesh, bw)
            return c, BatchShard(c.start, bw, n_data, mesh.group("data"))

        # the population's hyperparameters on the device, and the statics
        # each trial's fit alone would have (the shapes it draws at)
        hp_dev = _to_device(stack_hps(hps), dev)
        own = [_resolve_statics(spec, [hp], cfg) for hp in hps]
        tr_cols, tr_shard = cols(max([w for _, w in train_dims]
                                     + [plan_rows[0]]))
        ev_cols, ev_shard = cols(eval_rows)
        eval_trials = Trials(hps, hp_dev, own)
        run_rngs = [np.random.default_rng(int(s)) for s in my_run_seeds]
        es = (torch.full((n_local,), -float("inf"), device=dev),   # best score
              torch.zeros(n_local, dtype=torch.int32, device=dev),  # counter
              torch.zeros(n_local, dtype=torch.bool, device=dev),   # stopped
              torch.zeros(n_local, dtype=torch.int32, device=dev))  # epochs run

    def rows_of(idx, mask, data):
        """A plan row's inputs, targets and [T, bw] mask: one gather for
        every trial (shared by all, or [T, bw] per-trial rows)."""
        inputs, y = _gather(data, idx if idx.shape[0] > 1 else idx[0], spec)
        return inputs, y, mask.expand(n_local, -1)

    def run_epoch(active, t_idx, t_mask):
        """Train the population over the plan, one stacked step a batch,
        then evaluate it: per-trial device tensors (loss sum, train AUPRC
        sum, test AUPRC sum, f1)."""
        nonlocal params, bn_state, opt_state
        zeros = torch.zeros(n_local, device=dev)
        tr_loss, tr_auprc, te_auprc, te_f1 = zeros, zeros, zeros, 0.0
        for b in range(plan_idx.shape[1]):
            with annotate("engine.step"):
                with annotate("engine.step.gather"):
                    inputs, y, mask = rows_of(plan_idx[:, b, tr_cols],
                                              plan_mask[:, b, tr_cols],
                                              train_data)
                # each trial's generator for this step (its run stream's
                # next seed); a trial past its own plan draws nothing
                with annotate("engine.step.draws"):
                    gens = [torch.Generator(dev).manual_seed(
                                int(rng.integers(0, 2 ** 31 - 1)))
                            if b < nb else None
                            for rng, (nb, _) in zip(run_rngs, train_dims)]
                    trials = Trials(hps, hp_dev, own,
                                    Draws(gens, [w for _, w in train_dims],
                                          dev, tr_shard))
                # freeze stopped trials and fully masked (or padding)
                # batches
                upd = active & plan_has_rows[:, b]
                count("engine.train_steps")
                loss, logits, params, bn_state, opt_state = population_step(
                    spec, params, bn_state, opt_state, trials, opt_hp, inputs,
                    y, mask, compute_dtype, statics, tr_shard, upd)
                # running sums, a batch at a time: a trial's sums do not
                # depend on how many batches the other trials' plans have
                tr_loss = tr_loss + loss
                tr_auprc = tr_auprc + _auprc_of(cfg, logits, y, mask,
                                                tr_shard)
        with torch.no_grad(), annotate("engine.eval"):
            for b in range(t_idx.shape[1]):
                inputs, y, mask = rows_of(t_idx[:, b, ev_cols],
                                          t_mask[:, b, ev_cols], test_data)
                logits, _ = spec.apply_trials(params, bn_state, eval_trials,
                                              inputs, False, mask,
                                              compute_dtype, statics, ev_shard)
                te_auprc = te_auprc + _auprc_of(cfg, logits, y, mask, ev_shard)
                te_f1 = te_f1 + metrics.f1_precision_recall(logits, y, mask,
                                                            ev_shard)
        return tr_loss, tr_auprc, te_auprc, te_f1

    def run_chunk(n_ep: int, epoch_lo: int):
        nonlocal es
        outs = []
        for e in range(n_ep):
            t_idx, t_mask = eval_plans_by_epoch[epoch_lo + e]
            active = ~es[2]
            # a trial's sums are those of its population of any size
            with population_invariant():
                tr_loss, tr_auprc, te_auprc, te_f1 = run_epoch(active, t_idx,
                                                               t_mask)
            # EarlyStopping parity on the batch-averaged test AUPRC
            es = early_stop_update(es, te_auprc / eval_div_dev, cfg.patience,
                                   cfg.delta)
            outs.append((tr_loss, tr_auprc, te_auprc, te_f1, es[2]))
        return tuple(torch.stack(x, dim=1) for x in zip(*outs))   # [T, n_ep, ...]

    # host bookkeeping covers the real population; padding trials train
    # but are never reported or returned
    pruned = [False] * n_real
    hist_train = [[] for _ in range(n_real)]
    hist_test = [[] for _ in range(n_real)]
    hist_f1 = [[] for _ in range(n_real)]
    hist_loss = [[] for _ in range(n_real)]
    if chunk_callback is not None:
        _wpt = ([float(p.mask.sum()) for p in all_plans] if len(all_plans) > 1
                else [float(all_plans[0].mask.sum())] * n_trials)
    done = [False] * n_real
    t_state = {"prev_fetch": time.perf_counter()}

    @spanned("engine.fetch")
    def _process(rec):
        """Fetch one chunk's metrics (the only wait for the device; under a
        mesh, every trial block's) and run the host bookkeeping: history,
        early exit, pruning, callback."""
        c_idx, n_ep, ep_lo, outs, live0, t_disp = rec
        arrays = [o.cpu().numpy() for o in outs]
        if mesh is not None:
            blocks = gather_trials(mesh, arrays)
            arrays = [np.concatenate(parts) for parts in zip(*blocks)]
        loss_sum, tr_sum, te_sum, f1_sum, stopped_seq = arrays
        now = time.perf_counter()
        if chunk_callback is not None:
            # a trial stopping at in-chunk epoch e trained e + 1 epochs
            ss = stopped_seq.astype(bool)
            ep_tr = np.where(ss.any(axis=1), ss.argmax(axis=1) + 1, n_ep)
            prev_stopped = t_state.get("stopped", [False] * n_real)
            real_windows = sum(w * int(e) for w, e, live, sp
                               in zip(_wpt, ep_tr, live0, prev_stopped)
                               if live and not sp)
            t_state["stopped"] = ss[:n_real, -1].tolist()
            chunk_callback(c_idx, n_ep,
                           now - max(t_disp, t_state["prev_fetch"]),
                           real_windows / n_ep)
        t_state["prev_fetch"] = now
        loss_tr = loss_sum / train_div[:, None]       # [T, n_ep]
        auprc_tr = tr_sum / train_div[:, None]
        auprc_te = te_sum / eval_div[:, None]
        f1 = f1_sum / eval_div[:, None, None]         # [T, n_ep, 3]
        for e in range(n_ep):
            epoch = ep_lo + e + 1
            for t in range(n_real):
                if done[t]:
                    continue
                # history includes the stop epoch (the reference records
                # the epoch's scores, then breaks)
                hist_loss[t].append(float(loss_tr[t, e]))
                hist_train[t].append(float(auprc_tr[t, e]))
                hist_test[t].append(float(auprc_te[t, e]))
                hist_f1[t].append(f1[t, e].tolist())
                if report_fn is not None and \
                        report_fn(t, epoch, float(auprc_te[t, e])):
                    pruned[t] = True
                    done[t] = True
                elif stopped_seq[t, e]:
                    done[t] = True
        if verbose:
            print(f"epochs {ep_lo + 1}-{ep_lo + n_ep}: "
                  f"test AUPRC {auprc_te[:n_real, -1].round(4)} "
                  f"done={sum(done)}/{n_real}")

    epochs_done, chunk_idx, pending = 0, 0, None
    while epochs_done < cfg.num_epochs and not all(done):
        n_ep = min(cfg.epoch_chunk, cfg.num_epochs - epochs_done)
        live0 = [not d for d in done] if chunk_callback is not None else None
        t_chunk0 = time.perf_counter()
        outs = run_chunk(n_ep, epochs_done)
        rec = (chunk_idx, n_ep, epochs_done, outs, live0, t_chunk0)
        chunk_idx += 1
        epochs_done += n_ep
        if cfg.pipeline_chunks:
            # chunk k's metrics are read after chunk k + 1 is enqueued;
            # early exit lags one chunk, the numerics do not change
            if pending is not None:
                _process(pending)
            pending = rec
        else:
            _process(rec)
    if pending is not None:
        _process(pending)

    if use_master:
        # the float32 master is the source of truth; the bf16 live copy
        # was only the compute stream's format
        params = opt_state["master"]
    if shrunk:
        params, bn_state = slicing.grow(spec.name, params, bn_state, statics)
    if mesh is not None:
        params, bn_state = _gather_population(mesh, (params, bn_state),
                                              n_real, dev)
    return FitResult(params=params, bn_state=bn_state,
                     auprc_train=hist_train, auprc_test=hist_test,
                     f1_precision_recall=hist_f1,
                     epochs_run=[len(h) for h in hist_test],
                     loss_train=hist_loss)


def weight_reset(seed: int, spec: ModelSpec, hp_concrete, old_params,
                 old_bn_state):
    """Reference ``weight_reset`` parity (`models/utils/utils.py:155-163`;
    JAX ``engine.weight_reset``): re-initialise Linear/Conv weights from a
    generator seeded with ``seed`` but keep BatchNorm affine params and
    running stats from HPO training (the reference resets only
    Conv1d/Linear/LSTM modules — a quirk kept here).  Returns
    ``(params, old_bn_state)``; kept leaves stay as they were given."""
    fresh_params, _ = spec.init(torch.Generator().manual_seed(int(seed)),
                                hp_concrete)

    def merge(fresh, old):
        if isinstance(fresh, dict):
            return {k: (old[k] if k.startswith("bn") else merge(fresh[k], old[k]))
                    for k in fresh}
        return fresh

    return merge(fresh_params, old_params), old_bn_state
