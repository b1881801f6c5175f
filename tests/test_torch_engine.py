"""The port's training step and ``engine.fit`` against the JAX package.

* One training step, exact: JAX-made params carried over with
  ``convert``, dropout rates 0, availabilities all ones and
  selection_probabilities_FFNN in {0, 1} (where the draw cannot matter):
  the loss, every gradient, the new BN state and the Adam-updated params
  equal JAX's ``value_and_grad`` + ``optim.apply_update`` within 1e-5
  (float32, sums taken in another order), on the fused and unfused paths
  (the JAX fused path cannot run on the CPU, so both are held to its
  unfused path, which computes the same function there).
* Engine behaviour: the early-stopping arithmetic, freezing on fully
  masked batches and for stopped trials, a population equal to its
  single-trial fits bit for bit (with a shared plan, and with per-trial
  plans of different shapes), pipelined chunks, the device rule.
* A fit on learnable data lands within 0.2 of the JAX engine's best test
  AUPRC (different RNG streams, so a band); slow, the JAX fit takes long
  on the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_parity import IN_FEATURES, close, flat_embracenet, t, to_torch

from embracenet_tpu.config import TrainConfig as JTrainConfig
from embracenet_tpu.data.codec import one_hot as j_one_hot
from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.models import embracenet as jem
from embracenet_tpu.ops import losses as jlosses
from embracenet_tpu.ops import optim as joptim
from embracenet_tpu.training import engine as jengine
from embracenet_tpu.training.modelspec import get_spec as jget_spec
from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.convert import tree_map, tree_to_numpy
from embracenet_tpu_torch.data.codec import one_hot as t_one_hot
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.models import embracenet as tem
from embracenet_tpu_torch.ops import losses as tlosses
from embracenet_tpu_torch.ops import optim as toptim
from embracenet_tpu_torch.training import engine, slicing
from embracenet_tpu_torch.training.batching import BatchPlan, eval_plan
from embracenet_tpu_torch.training.modelspec import get_spec

TOL = 1e-5
SPEC = get_spec("EmbraceNetMultimodal", IN_FEATURES)


def _data(rng, n=400, d=IN_FEATURES):
    y = (rng.random(n) < 0.3).astype(np.int64)
    w = rng.normal(size=d)
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, w) * 0.9).astype(np.float32)
    codes = rng.integers(0, 4, size=(n, 256)).astype(np.uint8)
    data = {"ffnn": x, "cnn": codes, "y": y}
    return ({k: v[:300] for k, v in data.items()},
            {k: v[300:] for k, v in data.items()})


def _trial(p_ffnn=0.5, **overrides):
    flat = dict(flat_embracenet(p_ffnn), **overrides)
    return (tspace.params_to_hp("EmbraceNetMultimodal", flat),
            tspace.optimizer_hp(flat), flat)


def _cfg(**kw):
    base = dict(num_epochs=2, epoch_chunk=2, batch_size=100, width_buckets=True)
    base.update(kw)
    return TrainConfig(**base)


def _equal_trees(a, b):
    a, b = tree_to_numpy(a), tree_to_numpy(b)
    jax.tree.map(np.testing.assert_array_equal, a, b)


def _bucketed(params, bn, hps):
    """What a width-bucketed fit returns for untouched params: the regions
    outside the bucket come back as the fill of ``slicing.grow``."""
    statics = engine._resolve_statics(SPEC, hps, _cfg())
    return slicing.grow(SPEC.name, *slicing.shrink(SPEC.name, params, bn, statics),
                        statics)


@pytest.mark.parametrize("p_ffnn", [0.0, 1.0])
def test_one_training_step_equals_jax(rng, p_ffnn):
    flat = flat_embracenet(p_ffnn, n_post=1)
    hp_j = jspace.params_to_hp("EmbraceNetMultimodal", flat)
    hp_t = tspace.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = jax.jit(jem.init_from_fans, static_argnums=2)(
        jax.random.PRNGKey(1), jem.fan_ins(hp_j, IN_FEATURES), IN_FEATURES)
    b = 32
    x = rng.normal(size=(b, IN_FEATURES)).astype(np.float32)
    codes = rng.integers(0, 4, size=(b, 256)).astype(np.uint8)
    y = (rng.random(b) < 0.4).astype(np.int64)
    y[:2] = (0, 1)
    mask = np.ones(b, np.float32)
    mask[-5:] = 0.0
    avail = np.ones((b, 2), np.float32)
    lr, wd = 1e-3, 1e-4

    @jax.jit
    def j_step(params, bn):
        def loss_fn(p):
            logits, new_bn = jem.apply(p, bn, hp_j, x, j_one_hot(codes), train=True,
                                       key=jax.random.PRNGKey(2), row_mask=mask,
                                       availabilities=avail)
            return jlosses.weighted_cross_entropy(logits, y, mask), new_bn

        (loss, new_bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        new_p, _ = joptim.apply_update(params, grads, opt_state, joptim.ADAM, lr, wd)
        return loss, grads, new_bn, new_p

    # the step starts from a seeded mid-training Adam state: at step 1 the
    # update is g / (|g| + eps), whose sign flips for gradients that cancel
    # to ~1e-8 across the batch, so it would test float noise, not the port
    srng = np.random.default_rng(7)
    np_params = jax.tree.map(np.asarray, params)
    opt_state = {"m": jax.tree.map(lambda a: srng.normal(0, 1e-3, a.shape)
                                   .astype(np.float32), np_params),
                 "v": jax.tree.map(lambda a: (srng.normal(0, 1e-3, a.shape) ** 2
                                              + 1e-6).astype(np.float32), np_params),
                 "step": np.float32(10), "m_schedule": np.float32(0.5)}
    want = jax.tree.map(np.asarray, j_step(params, bn))
    for fused in (True, False):
        p = to_torch(params)
        leaves = []
        tree_map(lambda a: leaves.append(a.requires_grad_(True)), p)
        logits, new_bn = tem.apply(p, to_torch(bn), hp_t, t(x), t_one_hot(t(codes)),
                                   train=True, seed=0, row_mask=t(mask),
                                   availabilities=t(avail), fused=fused)
        loss = tlosses.weighted_cross_entropy(logits, t(y), t(mask))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(grads)
        grads = tree_map(lambda a: next(it), p)
        p0 = tree_map(lambda a: a.detach(), p)
        new_p, _ = toptim.apply_update(p0, grads, to_torch(opt_state),
                                       toptim.ADAM, lr, wd)
        assert float(loss.detach()) == pytest.approx(float(want[0]), abs=TOL)
        jax.tree.map(lambda w, g: close(torch.zeros(w.shape) if g is None else g,
                                        w, TOL), want[1], grads,
                     is_leaf=lambda v: v is None)
        jax.tree.map(lambda w, g: close(g, w, TOL), want[2], new_bn)
        jax.tree.map(lambda w, g: close(g, w, TOL), want[3], new_p)


def test_early_stopping_matches_jax():
    scores = np.asarray([[0.50, 0.60, 0.59, 0.61, 0.58, 0.57, 0.70],
                         [0.30, 0.29, 0.28, 0.27, 0.40, 0.41, 0.39],
                         [0.10, 0.20, 0.30, 0.40, 0.50, 0.60, 0.70]], np.float32)
    for patience, delta in ((2, 0.0), (1, 0.015), (3, 0.02)):
        es = (torch.full((3,), -float("inf")), torch.zeros(3, dtype=torch.int32),
              torch.zeros(3, dtype=torch.bool), torch.zeros(3, dtype=torch.int32))
        stopped_seq = []
        for e in range(scores.shape[1]):
            es = engine.early_stop_update(es, t(scores[:, e]), patience, delta)
            stopped_seq.append(es[2].clone())
        stopped_seq = torch.stack(stopped_seq, 1).numpy()
        for trial in range(3):
            ref, port = jengine.EarlyStopping(patience, delta), \
                engine.EarlyStopping(patience, delta)
            want_stop = []
            for s in scores[trial]:
                if not ref.stop:
                    ref(float(s))
                    port(float(s))
                want_stop.append(ref.stop)
                assert (port.best, port.counter, port.stop) == \
                    (ref.best, ref.counter, ref.stop)
            np.testing.assert_array_equal(stopped_seq[trial], want_stop)
            assert int(es[3][trial]) == (want_stop.index(True) + 1 if any(want_stop)
                                         else scores.shape[1])
            assert float(es[0][trial]) == pytest.approx(ref.best)


def test_fully_masked_batches_leave_state_unchanged(rng):
    train, test = _data(rng)
    hp, opt, _ = _trial()
    params, bn = tem.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    params, bn = engine.stack_trials([params]), engine.stack_trials([bn])
    dead = BatchPlan(idx=np.zeros((3, 50), np.int32),
                     mask=np.zeros((3, 50), np.float32), metric_divisor=3)
    res = engine.fit(SPEC, [hp], [opt], train, test, _cfg(), init_params=params,
                     init_bn_state=bn, train_plans=[dead],
                     eval_plans=[eval_plan(100, 200)], device="cpu")
    want_p, want_bn = _bucketed(params, bn, [hp])
    _equal_trees(res.params, want_p)
    _equal_trees(res.bn_state, want_bn)
    assert res.auprc_train[0] == [0.0, 0.0] and res.loss_train[0] == [0.0, 0.0]


def test_stopped_trial_stays_frozen(rng):
    train, test = _data(rng)
    hp, opt, _ = _trial()
    # delta 10: no epoch after the first improves, so patience 1 stops at 2
    short = engine.fit(SPEC, [hp], [opt], train, test,
                       _cfg(patience=1, delta=10.0), device="cpu")
    long = engine.fit(SPEC, [hp], [opt], train, test,
                      _cfg(patience=1, delta=10.0, num_epochs=5, epoch_chunk=5),
                      device="cpu")
    assert short.epochs_run == long.epochs_run == [2]
    _equal_trees(long.params, short.params)
    _equal_trees(long.bn_state, short.bn_state)


def test_population_equals_its_single_trial_fits(rng):
    train, test = _data(rng)
    hp, opt, _ = _trial(0.5, FFNN_dropout_l0=0.3, CNN_dropout_l0=0.2)
    hps = [hp, hp]
    opts = [opt, dict(opt, optimizer=np.int32(toptim.RMSPROP), lr=np.float32(3e-3))]
    init_seeds, run_seeds = engine.seed_streams(5, 2)
    cfg = _cfg(num_epochs=2, epoch_chunk=1)
    pop = engine.fit(SPEC, hps, opts, train, test, cfg, init_seeds=init_seeds,
                     run_seeds=run_seeds, device="cpu")
    assert pop.epochs_run == [2, 2]
    for k in range(2):
        one = engine.fit(SPEC, [hps[k]], [opts[k]], train, test, cfg,
                         init_seeds=init_seeds[k:k + 1],
                         run_seeds=run_seeds[k:k + 1], device="cpu")
        _equal_trees(tree_map(lambda a: a[k:k + 1], pop.params), one.params)
        _equal_trees(tree_map(lambda a: a[k:k + 1], pop.bn_state),
                     one.bn_state)
        assert pop.auprc_test[k] == one.auprc_test[0]
        assert pop.loss_train[k] == one.loss_train[0]
    # and seed=5 derives exactly these streams
    again = engine.fit(SPEC, hps, opts, train, test, cfg, seed=5, device="cpu")
    _equal_trees(again.params, pop.params)


def test_trials_of_padded_per_trial_plans_train_as_alone(rng):
    """Per-trial plans of different shapes (fold-fused CV: 300 and 170
    train rows, 100 and 60 test rows) stack padded; each trial still steps
    through its own batches only and draws at its own width, so it draws
    and computes what a fit with its plan alone does, dropout included,
    where that fit's batches run the stack's rows (``plan_rows``: a stacked
    step runs every trial at the widest plan's rows, and sums over more
    rows sum in another order)."""
    from embracenet_tpu_torch.training.batching import balanced_plan, shift_plan

    (tr_a, te_a), (tr_b, te_b) = _data(rng), _data(rng)
    tr_b = {k: v[:170] for k, v in tr_b.items()}
    te_b = {k: v[:60] for k, v in te_b.items()}
    hp, opt, _ = _trial(0.5, FFNN_dropout_l0=0.3, CNN_dropout_l0=0.2,
                        EMBRACENET_dropout_l0=0.2)
    cfg = _cfg(num_epochs=2, epoch_chunk=1, batch_size=40)
    cat = {k: np.concatenate([tr_a[k], tr_b[k]]) for k in tr_a}
    cat_te = {k: np.concatenate([te_a[k], te_b[k]]) for k in te_a}
    plans = [balanced_plan(tr_a["y"], 40),
             shift_plan(balanced_plan(tr_b["y"], 40), 300)]
    evals = [eval_plan(100, 80), shift_plan(eval_plan(60, 80), 100)]
    assert plans[0].idx.shape != plans[1].idx.shape
    init_seeds, run_seeds = engine.seed_streams(3, 2)
    fused = engine.fit(SPEC, [hp, hp], [opt, opt], cat, cat_te, cfg,
                       train_plans=plans, eval_plans=evals,
                       init_seeds=init_seeds, run_seeds=run_seeds, device="cpu")
    rows = (max(p.idx.shape[1] for p in plans), max(p.idx.shape[1] for p in evals))
    for k, (tr, te) in enumerate(((tr_a, te_a), (tr_b, te_b))):
        one = engine.fit(SPEC, [hp], [opt], tr, te, cfg,
                         init_seeds=init_seeds[k:k + 1],
                         run_seeds=run_seeds[k:k + 1], device="cpu",
                         plan_rows=rows)
        assert fused.auprc_train[k] == one.auprc_train[0]
        assert fused.auprc_test[k] == one.auprc_test[0]
        assert fused.loss_train[k] == one.loss_train[0]
        _equal_trees(tree_map(lambda a: a[k:k + 1], fused.params), one.params)


def test_pipelined_chunks_change_nothing_and_report_windows(rng):
    train, test = _data(rng)
    hp, opt, _ = _trial()
    calls = []
    cfg = _cfg(num_epochs=3, epoch_chunk=1)
    plain = engine.fit(SPEC, [hp], [opt], train, test, cfg, device="cpu")
    piped = engine.fit(SPEC, [hp], [opt], train, test,
                       dataclasses.replace(cfg, pipeline_chunks=True),
                       chunk_callback=lambda *a: calls.append(a), device="cpu")
    _equal_trees(piped.params, plain.params)
    assert piped.auprc_test == plain.auprc_test
    assert [c[0] for c in calls] == [0, 1, 2]
    assert all(c[1] == 1 and c[3] == 300.0 for c in calls)


def test_jax_made_params_carry_across(rng):
    train, test = _data(rng)
    flat = flat_embracenet(0.5)
    hp_j = jspace.params_to_hp("EmbraceNetMultimodal", flat)
    hp, opt, _ = _trial()
    init = jax.jit(jax.vmap(lambda k: jem.init_from_fans(
        k, jem.fan_ins(hp_j, IN_FEATURES), IN_FEATURES)))
    params, bn = jax.tree.map(np.asarray, init(jax.random.split(
        jax.random.PRNGKey(0), 2)))
    res = engine.fit(SPEC, [hp, hp], [opt, opt], train, test, _cfg(num_epochs=0),
                     init_params=params, init_bn_state=bn, device="cpu")
    want_p, want_bn = _bucketed(to_torch(params), to_torch(bn), [hp, hp])
    _equal_trees(res.params, want_p)
    _equal_trees(res.bn_state, want_bn)
    assert res.epochs_run == [0, 0]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_low_precision_options_and_eval_reshuffle(rng, compute_dtype):
    train, test = _data(rng)
    hp, opt, _ = _trial()
    # bf16 live params under float32 compute promote, as JAX promotes them
    res = engine.fit(SPEC, [hp], [opt], train, test,
                     _cfg(compute_dtype=compute_dtype, optim_dtype="bfloat16",
                          param_dtype="bfloat16", eval_reshuffle=True),
                     device="cpu")
    # the float32 master comes back, not the bf16 live copy
    assert res.params["dock1_w"].dtype == torch.float32
    assert res.epochs_run == [2]
    assert np.all(np.isfinite(res.loss_train[0] + res.auprc_test[0]))


@pytest.mark.parametrize("model,flat", [
    ("FFNN", {"n_layers": 2, "n_units_l0": 64, "n_units_l1": 32}),
    ("CNN", {"n_layers": 1, "out_channels_l0": 16, "kernel_size_l0": 5})])
def test_fit_trains_the_unimodal_families(rng, model, flat):
    train, test = _data(rng)
    flat = dict(flat, optimizer="Adam", lr=1e-3, weight_decay=1e-4)
    spec = get_spec(model, IN_FEATURES)
    hp = tspace.params_to_hp(model, flat)
    res = engine.fit(spec, [hp], [tspace.optimizer_hp(flat)], train, test,
                     _cfg(), device="cpu")
    want, _ = spec.init(torch.Generator().manual_seed(0), hp)
    assert {k: tuple(v.shape[1:]) for k, v in res.params.items()
            if not isinstance(v, dict)} == \
        {k: tuple(v.shape) for k, v in want.items() if not isinstance(v, dict)}
    assert res.epochs_run == [2]
    assert np.all(np.isfinite(res.loss_train[0] + res.auprc_test[0]))


def test_fit_needs_the_card_unless_asked_for_the_cpu(rng, monkeypatch):
    train, test = _data(rng)
    hp, opt, _ = _trial()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.fit(SPEC, [hp], [opt], train, test, _cfg())
    # a mesh decides the device; one that contradicts ``device`` raises
    from embracenet_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="contradicts"):
        engine.fit(SPEC, [hp], [opt], train, test, _cfg(),
                   mesh=make_mesh(1, 1, device_type="cpu"), device="cuda")


def test_statics_keep_the_port_rule():
    hp, _, _ = _trial()
    assert engine._resolve_statics(SPEC, [hp], _cfg())["fused_embrace"] is True
    assert "fused_embrace" not in engine._resolve_statics(
        SPEC, [hp], _cfg(fused_embrace=False))
    assert "embrace_max" not in engine._resolve_statics(
        SPEC, [hp], _cfg(width_buckets=False))


@pytest.mark.slow
def test_fit_lands_in_the_jax_auprc_band(rng):
    train, test = _data(rng)
    _, _, flat = _trial(0.5, CNN_n_layers=1)
    kw = dict(num_epochs=8, epoch_chunk=8, batch_size=100)
    j_res = jengine.fit(jget_spec("EmbraceNetMultimodal", IN_FEATURES),
                        [jspace.params_to_hp("EmbraceNetMultimodal", flat)],
                        [jspace.optimizer_hp(flat)], train, test,
                        JTrainConfig(fused_embrace=False, **kw))
    t_res = engine.fit(SPEC, [tspace.params_to_hp("EmbraceNetMultimodal", flat)],
                       [tspace.optimizer_hp(flat)], train, test,
                       TrainConfig(**kw), device="cpu")
    a_j, a_t = max(j_res.auprc_test[0]), max(t_res.auprc_test[0])
    assert np.isfinite(a_t)
    assert abs(a_t - a_j) < 0.2, (a_t, a_j)
