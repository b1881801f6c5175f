"""Population training engine (port of ``embracenet_tpu/training/engine.py``).

Replaces the reference's per-batch Python loops (`BIOINF_tesi/models/utils/
training_models.py:31-186` ``fit`` and the Optuna objective's inner loop):

  * the fold's train/test set lives on the device; an epoch walks a padded
    batch-index matrix (see batching.py) and gathers each batch there;
  * a *population* of T trials (different architectures via supernet masks,
    different optimizers/lr/wd via the branchless update) trains together.
    Params, BN state and optimizer state are stacked over a leading trial
    axis, as ``FitResult.params`` is in the JAX package; each batch step
    runs the trials one after another on their slices (a trial axis inside
    the kernels is later work), which gives the results of T single-trial
    fits with the same seeds;
  * per-batch INS-weighted cross entropy, per-batch argmax-AUPRC and the
    reference's metric averaging (divide by ``len(loader)``) are preserved;
  * early stopping (patience on test AUPRC, `models/utils/utils.py:23-67`)
    runs on the device: best, counter, stopped and epochs run are device
    tensors, and a stopped trial, like a fully masked batch, keeps its
    params, BN state and optimizer state through a select.  Nothing inside
    an epoch chunk waits for the device: the host reads the metrics once a
    chunk is enqueued (with ``pipeline_chunks``, once the next one is).

Runs on the CUDA card unless the caller passes ``device="cpu"``.  For
EmbraceNetMultimodal the docking + embracement runs in the fused CUDA
kernel and its gradient (``ops/embrace.py``) unless
``TrainConfig.fused_embrace`` is False.  The optimizer state is updated in
place (``copy_`` into the stacked tensors) so a step holds one copy of it.

Random streams: the JAX PRNG keys become per-trial integer seeds
(:func:`seed_streams`): an init seed feeds the trial's ``torch.Generator``
for its parameter init, a run seed a numpy generator that gives every batch
step its forward seed.  Same distributions as the JAX package, different
streams.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from embracenet_tpu_torch import resolve_device
from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.convert import tree_map, tree_to_torch
from embracenet_tpu_torch.ops import losses, metrics, optim
from embracenet_tpu_torch.training import slicing
from embracenet_tpu_torch.training.batching import balanced_plan, eval_plan
from embracenet_tpu_torch.training.modelspec import ModelSpec


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
    if cfg.cnn_full_depth and "cnn_max_depth" in statics:
        from embracenet_tpu_torch.config import CNN_MAX_LAYERS

        statics["cnn_max_depth"] = CNN_MAX_LAYERS
        for k in width_keys:
            statics.pop(k, None)
    if cfg.fused_embrace is not False and spec.name == "EmbraceNetMultimodal":
        statics["fused_embrace"] = True
    return statics


def _device_data(data, spec: ModelSpec, device):
    """The split's arrays as tensors on the device (the JAX engine also pads
    the rows to a bucket of 512 to reuse compiled programs; eager PyTorch
    has none to reuse)."""
    out = {"y": torch.as_tensor(np.asarray(data["y"], np.int64), device=device)}
    if "ffnn" in spec.inputs:
        out["ffnn"] = torch.as_tensor(np.asarray(data["ffnn"], np.float32),
                                      device=device)
    if "cnn" in spec.inputs:
        out["cnn"] = torch.as_tensor(np.asarray(data["cnn"], np.uint8),
                                     device=device)
    return out


def _pad_plan(plan, n_batches: int, width: int):
    """A BatchPlan padded to (n_batches, width): dummy batches are fully
    masked (the train step keeps its state through them) and metric sums
    divide by the real divisor.  The JAX engine also rounds both up to
    buckets (4 batches, 16 rows) to reuse compiled programs; here padding
    only lets per-trial plans of different shapes stack."""
    idx = np.zeros((n_batches, width), np.int64)
    mask = np.zeros((n_batches, width), np.float32)
    idx[:plan.idx.shape[0], :plan.idx.shape[1]] = plan.idx
    mask[:plan.mask.shape[0], :plan.mask.shape[1]] = plan.mask
    return idx, mask


def _stack_plans(ps, device):
    """[P, nb, bw] plan tensors on the device (P = 1 for a shared plan)."""
    nb = max(p.idx.shape[0] for p in ps)
    bw = max(p.idx.shape[1] for p in ps)
    padded = [_pad_plan(p, nb, bw) for p in ps]
    return (torch.as_tensor(np.stack([p[0] for p in padded]), device=device),
            torch.as_tensor(np.stack([p[1] for p in padded]), device=device))


def _gather(data, idx, spec: ModelSpec):
    inputs = {k: data[k][idx] for k in ("ffnn", "cnn") if k in spec.inputs}
    return inputs, data["y"][idx]


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _trial(tree, t: int):
    return tree_map(lambda a: a[t], tree)


def _opt_trial(opt, t: int):
    return {k: (v[t] if isinstance(v, torch.Tensor) else _trial(v, t))
            for k, v in opt.items()}


def _write(stacked, t: int, new, upd):
    """stacked[t] <- new where ``upd`` (a device bool), else unchanged."""
    def one(a, n):
        a[t].copy_(torch.where(upd, n.to(a.dtype), a[t]))
    tree_map(one, stacked, new)


def train_step(spec: ModelSpec, params, bn_state, opt_state, hp, opt_hp,
               inputs, y, mask, seed: int, compute_dtype, statics):
    """One trial's batch step: forward, weighted CE, gradients through
    autograd (the fused kernel's through its Function), optimizer update.
    Returns ``(loss, logits, new_params, new_bn_state, new_opt_state)``;
    the caller decides whether the new state is kept."""
    leaves = [a.detach().requires_grad_(True) for a in _leaves(params)]
    live = _unflatten(params, leaves)
    logits, new_bn = spec.apply(live, bn_state, hp, inputs, True, seed, mask,
                                compute_dtype, statics)
    loss = losses.weighted_cross_entropy(logits, y, mask)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    new_params, new_opt = optim.apply_update(
        params, _unflatten(params, grads), opt_state, opt_hp["optimizer"],
        opt_hp["lr"], opt_hp["weight_decay"])
    return (loss.detach(), logits.detach(), new_params,
            tree_map(torch.Tensor.detach, new_bn), new_opt)


def _auprc_of(cfg, logits, y, mask):
    if cfg.auprc_on_probabilities:
        return metrics.auprc_prob(torch.softmax(logits, -1)[:, 1], y, mask)
    return metrics.auprc_argmax(logits, y, mask)


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
        device=None) -> FitResult:
    """Train a population of trials on one (train, test) split.

    ``hp_list``/``opt_list``: per-trial concrete hyperparameter dicts
    (architecture / {optimizer, lr, weight_decay}).  ``seed`` (default
    ``cfg.seed``) derives the per-trial ``init_seeds`` / ``run_seeds``
    (:func:`seed_streams`) unless they are given.  ``init_params`` /
    ``init_bn_state``: trees stacked over trials (numpy arrays, tensors, or
    a JAX ``FitResult``'s params through numpy).  ``report_fn`` (optional)
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
    ``mesh`` is not ported: ROADMAP.md Queue 1 item 8.
    """
    if mesh is not None:
        raise NotImplementedError("fit(mesh=...) is not ported to PyTorch "
                                  "yet: ROADMAP.md Queue 1 item 8 "
                                  "(multi-device)")
    dev = resolve_device(device)
    n_trials = len(hp_list)
    if train_plans is not None and cfg.eval_reshuffle:
        raise ValueError("per-trial plans and eval_reshuffle are exclusive "
                         "(use the sequential per-fold path for strict "
                         "reference eval-shuffle parity)")
    if (train_plans is None) != (eval_plans is None):
        raise ValueError("train_plans and eval_plans go together")
    s_init, s_run = seed_streams(cfg.seed if seed is None else seed, n_trials)
    init_seeds = s_init if init_seeds is None else np.asarray(init_seeds)
    run_seeds = s_run if run_seeds is None else np.asarray(run_seeds)
    compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    state_dtype = torch.bfloat16 if cfg.optim_dtype == "bfloat16" else None
    use_master = cfg.param_dtype == "bfloat16"
    statics = _resolve_statics(spec, hp_list, cfg)
    shrunk = slicing.has_width_statics(statics)

    # population init: trial by trial from its own generator, on the host
    # (the same numbers on either device), then one copy to the device
    if init_params is None:
        inits = [spec.init_from_fans(torch.Generator().manual_seed(int(s)),
                                     spec.fan_ins(hp))
                 for s, hp in zip(init_seeds, hp_list)]
        params = stack_trials([i[0] for i in inits])
        bn_state = stack_trials([i[1] for i in inits])
    else:
        params, bn_state = init_params, init_bn_state
    params = tree_to_torch(params, "cpu")
    bn_state = tree_to_torch(bn_state or {}, "cpu")
    if shrunk:
        params, bn_state = slicing.shrink(spec.name, params, bn_state, statics)
    params = tree_map(lambda a: a.to(dev, copy=True).contiguous(), params)
    bn_state = tree_map(lambda a: a.to(dev, copy=True).contiguous(), bn_state)
    opt_state = optim.init_state(params, state_dtype, use_master,
                                 lead=(n_trials,))
    if use_master:
        params = tree_map(lambda a: a.to(torch.bfloat16), params)

    opt_hp = {k: torch.as_tensor(np.asarray([o[k] for o in opt_list]),
                                 device=dev)
              for k in ("optimizer", "lr", "weight_decay")}
    opt_hp["lr"] = opt_hp["lr"].float()
    opt_hp["weight_decay"] = opt_hp["weight_decay"].float()

    train_data = _device_data(data_train, spec, dev)
    test_data = _device_data(data_test, spec, dev)
    n_test = len(np.asarray(data_test["y"]))
    if train_plans is None:
        plans = [balanced_plan(np.asarray(data_train["y"]), cfg.batch_size,
                               seed=123)]
        tplans = [eval_plan(n_test, cfg.batch_size * 2, seed=123)]
    else:
        if len(train_plans) != n_trials or len(eval_plans) != n_trials:
            raise ValueError("per-trial plans must match the population size")
        plans, tplans = list(train_plans), list(eval_plans)

    def _div_vec(ps):
        d = np.asarray([p.metric_divisor for p in ps], np.float32)
        return np.broadcast_to(d, (n_trials,)).copy() if len(ps) == 1 else d

    train_div = _div_vec(plans)
    eval_div = _div_vec(tplans)
    eval_div_dev = torch.as_tensor(eval_div, device=dev)

    plan_idx, plan_mask = _stack_plans(plans, dev)
    if cfg.eval_reshuffle:
        # the reference reshuffles its test loader every epoch
        # (training_models.py:477); every epoch's plan goes to the device
        # now, so no chunk waits for a copy
        eval_plans_by_epoch = [_stack_plans([eval_plan(n_test, cfg.batch_size * 2,
                                                       seed=123 + ep)], dev)
                               for ep in range(cfg.num_epochs)]
    else:
        eval_plans_by_epoch = [_stack_plans(tplans, dev)] * cfg.num_epochs
    plan_has_rows = plan_mask.sum(-1) > 0                    # [P, nb]

    run_rngs = [np.random.default_rng(int(s)) for s in run_seeds]
    es = (torch.full((n_trials,), -float("inf"), device=dev),   # best score
          torch.zeros(n_trials, dtype=torch.int32, device=dev),  # counter
          torch.zeros(n_trials, dtype=torch.bool, device=dev),   # stopped
          torch.zeros(n_trials, dtype=torch.int32, device=dev))  # epochs run

    def run_epoch(active, t_idx, t_mask):
        """Train every trial over the plan, then evaluate it: per-trial
        device tensors (loss sum, train AUPRC sum, test AUPRC sum, f1)."""
        loss_sum = [[] for _ in range(n_trials)]
        auprc_sum = [[] for _ in range(n_trials)]
        shared_plan = plan_idx.shape[0] == 1
        for b in range(plan_idx.shape[1]):
            if shared_plan:
                batch = _gather(train_data, plan_idx[0, b], spec)
            for t in range(n_trials):
                p_ = 0 if shared_plan else t
                inputs, y = (batch if shared_plan
                             else _gather(train_data, plan_idx[t, b], spec))
                mask = plan_mask[p_, b]
                seed_tb = int(run_rngs[t].integers(0, 2 ** 31 - 1))
                loss, logits, new_p, new_bn, new_opt = train_step(
                    spec, _trial(params, t), _trial(bn_state, t),
                    _opt_trial(opt_state, t), hp_list[t],
                    {k: v[t] for k, v in opt_hp.items()},
                    inputs, y, mask, seed_tb, compute_dtype, statics)
                # freeze stopped trials and skip fully masked dummy batches
                upd = active[t] & plan_has_rows[p_, b]
                with torch.no_grad():
                    _write(params, t, new_p, upd)
                    _write(bn_state, t, new_bn, upd)
                    _write(opt_state, t, new_opt, upd)
                loss_sum[t].append(loss)
                auprc_sum[t].append(_auprc_of(cfg, logits, y, mask))
        tr_loss = torch.stack([torch.stack(v).sum() for v in loss_sum])
        tr_auprc = torch.stack([torch.stack(v).sum() for v in auprc_sum])
        te_auprc, te_f1 = [], []
        with torch.no_grad():
            for t in range(n_trials):
                p_ = 0 if t_idx.shape[0] == 1 else t
                a_sum, f_sum = [], []
                for b in range(t_idx.shape[1]):
                    inputs, y = _gather(test_data, t_idx[p_, b], spec)
                    mask = t_mask[p_, b]
                    logits, _ = spec.apply(_trial(params, t), _trial(bn_state, t),
                                           hp_list[t], inputs, False, 0, mask,
                                           compute_dtype, statics)
                    a_sum.append(_auprc_of(cfg, logits, y, mask))
                    f_sum.append(metrics.f1_precision_recall(logits, y, mask))
                te_auprc.append(torch.stack(a_sum).sum())
                te_f1.append(torch.stack(f_sum).sum(0))
        return tr_loss, tr_auprc, torch.stack(te_auprc), torch.stack(te_f1)

    def run_chunk(n_ep: int, epoch_lo: int):
        nonlocal es
        outs = []
        for e in range(n_ep):
            t_idx, t_mask = eval_plans_by_epoch[epoch_lo + e]
            active = ~es[2]
            tr_loss, tr_auprc, te_auprc, te_f1 = run_epoch(active, t_idx, t_mask)
            # EarlyStopping parity on the batch-averaged test AUPRC
            es = early_stop_update(es, te_auprc / eval_div_dev, cfg.patience,
                                   cfg.delta)
            outs.append((tr_loss, tr_auprc, te_auprc, te_f1, es[2]))
        return tuple(torch.stack(x, dim=1) for x in zip(*outs))   # [T, n_ep, ...]

    pruned = [False] * n_trials
    hist_train = [[] for _ in range(n_trials)]
    hist_test = [[] for _ in range(n_trials)]
    hist_f1 = [[] for _ in range(n_trials)]
    hist_loss = [[] for _ in range(n_trials)]
    if chunk_callback is not None:
        _wpt = ([float(p.mask.sum()) for p in plans] if len(plans) > 1
                else [float(plans[0].mask.sum())] * n_trials)
    done = [False] * n_trials
    t_state = {"prev_fetch": time.perf_counter()}

    def _process(rec):
        """Fetch one chunk's metrics (the only wait for the device) and run
        the host bookkeeping: history, early exit, pruning, callback."""
        c_idx, n_ep, ep_lo, outs, live0, t_disp = rec
        loss_sum, tr_sum, te_sum, f1_sum, stopped_seq = (
            o.cpu().numpy() for o in outs)
        now = time.perf_counter()
        if chunk_callback is not None:
            # a trial stopping at in-chunk epoch e trained e + 1 epochs
            ss = stopped_seq.astype(bool)
            ep_tr = np.where(ss.any(axis=1), ss.argmax(axis=1) + 1, n_ep)
            prev_stopped = t_state.get("stopped", [False] * n_trials)
            real_windows = sum(w * int(e) for w, e, live, sp
                               in zip(_wpt, ep_tr, live0, prev_stopped)
                               if live and not sp)
            t_state["stopped"] = ss[:, -1].tolist()
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
            for t in range(n_trials):
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
                  f"test AUPRC {auprc_te[:, -1].round(4)} "
                  f"done={sum(done)}/{n_trials}")

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
    return FitResult(params=params, bn_state=bn_state,
                     auprc_train=hist_train, auprc_test=hist_test,
                     f1_precision_recall=hist_f1,
                     epochs_run=[len(h) for h in hist_test],
                     loss_train=hist_loss)
