"""A population as one program: the port's trial axis against the JAX
package's ``jax.vmap`` and against each trial trained alone.

* The fused kernel's plain version with a trial axis equals one call per
  trial (``choose`` exactly, ``out`` within 1e-6) and what ``jax.vmap`` of
  the Pallas kernel computes, taken trial by trial in its interpreter
  (``_fused_fwd_raw(interpret=True)``, whose PRNG is stubbed to zeros:
  compared at p0 in {0, 1}, within 1e-5; the interpreter under
  ``jax.vmap`` returns NaN on the CPU).
* A stacked forward of three trials of mixed depth, width, kernel and
  ``n_post`` equals ``jax.vmap(spec.apply)`` over ``stack_trials(hp_list)``
  at selection probability 0 and 1, fused and unfused, within 1e-5 (float32
  sums in another order); the stacked update with mixed optimizers equals
  the vmapped JAX update within 1e-6.
* ``engine.fit`` runs one forward pass a batch for the whole population
  (one kernel call), every trial drawing from its own generator at its own
  shape exactly what it draws alone (``layers.Draws``).  A trial of a mixed
  population equals its fit alone in everything drawn or decided (epochs
  run, test AUPRCs, the fused kernel's choices) and in its values within
  rtol 1e-5 / atol 1e-6: batched products and grouped convolutions of
  different trial counts may sum in another order on the CPU.  A trial of
  a population of one or two equals its fit alone bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_parity import IN_FEATURES, close, flat_embracenet, t, to_torch

from embracenet_tpu.data.codec import one_hot as j_one_hot
from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.models import embracenet as jem
from embracenet_tpu.ops import optim as joptim
from embracenet_tpu.ops.pallas.embrace import _fused_fwd_raw
from embracenet_tpu.training import engine as jengine
from embracenet_tpu.training.modelspec import get_spec as j_get_spec
from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.convert import tree_leaves, tree_map, tree_to_numpy
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.models import layers
from embracenet_tpu_torch.ops import embrace as K
from embracenet_tpu_torch.ops import optim as toptim
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.batching import (balanced_plan, eval_plan,
                                                    shift_plan)
from embracenet_tpu_torch.training.modelspec import get_spec, stack_hps

SPEC = get_spec("EmbraceNetMultimodal", IN_FEATURES)

# three architectures: FFNN depth 1 / 3 / 2, CNN depth 2 / 1 / 3 with other
# channels and kernels, n_post 0 / 2 / 1, embracement 512 / 768 / 1024
MIXED = (dict(FFNN_n_layers=1, CNN_n_layers=2, n_post_layers=0,
              EMBRACENET_embracement_size=512),
         dict(FFNN_n_layers=3, FFNN_n_units_l1=16, CNN_n_layers=1,
              CNN_out_channels_l0=32, CNN_kernel_size_l0=11, n_post_layers=2,
              EMBRACENET_embracement_size=768),
         dict(FFNN_n_layers=2, FFNN_n_units_l0=32, CNN_n_layers=3,
              CNN_kernel_size_l1=15, n_post_layers=1,
              EMBRACENET_embracement_size=1024))


def _flats(ps, **common):
    return [dict(flat_embracenet(p), **m, **common) for p, m in zip(ps, MIXED)]


def _kernel_inputs(rng, n, b=24, d0=32, d1=160, e=256):
    def arr(*s, scale=1.0):
        return (rng.normal(size=s) * scale).astype(np.float32)

    e_mask = np.stack([(np.arange(e) < w).astype(np.float32)
                       for w in (256, 192, 128, 256)[:n]])
    return (arr(n, b, d0), arr(n, b, d1), arr(n, d0, e, scale=0.2),
            arr(n, e, scale=0.1), arr(n, d1, e, scale=0.2),
            arr(n, e, scale=0.1), e_mask)


def test_trial_axis_plain_kernel_equals_one_call_per_trial(rng):
    x0, x1, w0, b0, w1, b1, e_mask = map(t, _kernel_inputs(rng, 3))
    p0 = torch.rand(3, x0.shape[1], generator=torch.Generator().manual_seed(1))
    seeds = torch.tensor([7, 8, 1 << 30])
    out, choose = K.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, seeds)
    assert out.shape == choose.shape == (3, x0.shape[1], w0.shape[2])
    for k in range(3):
        o, c = K.fused_embrace(x0[k], x1[k], w0[k], b0[k], w1[k], b1[k],
                               p0[k], e_mask[k], int(seeds[k]))
        assert torch.equal(c, choose[k])
        close(out[k], o.numpy(), 1e-6)
    # one key for every trial: each trial draws what that key draws alone
    _, same = K.fused_embrace(x0, x1, w0, b0, w1, b1, p0, e_mask, 7)
    _, first = K.fused_embrace(x0[1], x1[1], w0[1], b0[1], w1[1], b1[1],
                               p0[1], e_mask[1], 7)
    assert torch.equal(same[1], first)


@pytest.mark.parametrize("p0_value", [0.0, 1.0])
def test_trial_axis_plain_kernel_matches_vmapped_pallas_interpret(rng,
                                                                  p0_value):
    args = _kernel_inputs(rng, 2)
    x0, x1, w0, b0, w1, b1, e_mask = args
    p0 = np.full(x0.shape[:2], p0_value, np.float32)
    # the interpreter under jax.vmap returns NaN on the CPU, so the vmapped
    # kernel is taken trial by trial
    want = [_fused_fwd_raw(*(a[k] for a in (x0, x1, w0, b0, w1, b1, p0,
                                            e_mask)), 3, interpret=True)
            for k in range(2)]
    want_out = np.stack([np.asarray(w[0]) for w in want])
    want_choose = np.stack([np.asarray(w[1]) for w in want])
    out, choose = K.fused_embrace(*map(t, (x0, x1, w0, b0, w1, b1)), t(p0),
                                  t(e_mask), torch.tensor([3, 4]))
    close(out, np.asarray(want_out), 1e-5)
    np.testing.assert_array_equal(choose.numpy(), np.asarray(want_choose))


def _mixed_case(rng, ps):
    hps_j = [jspace.params_to_hp("EmbraceNetMultimodal", f) for f in _flats(ps)]
    hps_t = [tspace.params_to_hp("EmbraceNetMultimodal", f) for f in _flats(ps)]
    fans = jengine.stack_trials([jem.fan_ins(h, IN_FEATURES) for h in hps_j])
    params, bn = jax.jit(jax.vmap(lambda k, f: jem.init_from_fans(
        k, f, IN_FEATURES)))(jax.random.split(jax.random.PRNGKey(3), 3), fans)
    inputs = {"ffnn": rng.normal(size=(7, IN_FEATURES)).astype(np.float32),
              "cnn": rng.integers(0, 4, size=(7, 256)).astype(np.uint8)}
    return hps_j, hps_t, params, bn, inputs


@pytest.mark.parametrize("ps", [(0.0, 1.0, 0.0), (1.0, 0.0, 1.0)])
@pytest.mark.parametrize("fused", [False, True])
def test_stacked_forward_matches_jax_vmapped_apply(rng, ps, fused):
    hps_j, hps_t, params, bn, inputs = _mixed_case(rng, ps)
    jspec = j_get_spec("EmbraceNetMultimodal", IN_FEATURES)
    st = jspec.statics(hps_j)
    assert SPEC.statics(hps_t) == st

    @jax.jit
    def j_apply(p, b, h):
        return jax.vmap(lambda p_, b_, h_: jspec.apply(
            p_, b_, h_, inputs, False, jax.random.PRNGKey(0), None, None,
            st))(p, b, h)

    l_j, s_j = j_apply(params, bn, jengine.stack_trials(hps_j))
    trials = layers.Trials(hps_t, stack_hps(hps_t))
    l_t, s_t = SPEC.apply_trials(to_torch(params), to_torch(bn), trials,
                                 {k: t(v) for k, v in inputs.items()}, False,
                                 None, None, dict(st, fused_embrace=fused))
    assert l_t.shape == (3, 7, 2)
    close(l_t, np.asarray(l_j), 1e-5)
    jax.tree.map(lambda a, b: close(b, np.asarray(a), 1e-5), s_j, s_t)


def test_stacked_update_with_mixed_optimizers_matches_vmapped_jax(rng):
    # keys in sorted order, as JAX's tree functions return them
    params = {"b": {"c": rng.normal(size=(3, 4)).astype(np.float32)},
              "w": rng.normal(size=(3, 5, 4)).astype(np.float32)}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                          params) for _ in range(4)]
    opt_id = np.asarray([joptim.ADAM, joptim.NADAM, joptim.RMSPROP], np.int32)
    lr = np.asarray([1e-2, 3e-3, 1e-3], np.float32)
    wd = np.asarray([1e-3, 0.0, 1e-4], np.float32)
    # trial 2 frozen at the third step (a stopped trial's select)
    upd = [np.asarray([True, True, s != 2]) for s in range(4)]

    @jax.jit
    def j_run(p, gs):
        s = jax.vmap(joptim.init_state)(p)
        for g, u in zip(gs, upd):
            new_p, new_s = jax.vmap(joptim.apply_update)(p, g, s, opt_id, lr, wd)
            keep = lambda n, o: jax.vmap(  # noqa: E731
                lambda a, b, c: jax.numpy.where(c, a, b))(n, o, u)
            p = jax.tree.map(keep, new_p, p)
            s = jax.tree.map(keep, new_s, s)
        return p, s

    want_p, want_s = j_run(params, grads)
    p = tree_map(t, params)
    s = toptim.init_state(p, lead=(3,))
    for g, u in zip(grads, upd):
        p, s = toptim.apply_update(p, tree_map(t, g), s, t(opt_id), t(lr),
                                   t(wd), t(u))
    for got, want in ((p, want_p), (s["m"], want_s["m"]), (s["v"], want_s["v"])):
        jax.tree.map(lambda w, g: close(g, np.asarray(w), 1e-6), want, got)
    close(s["step"], np.asarray(want_s["step"]), 0)
    close(s["m_schedule"], np.asarray(want_s["m_schedule"]), 1e-6)


def test_a_trial_draws_alone_what_it_draws_in_a_population():
    """``Draws`` gives trial t its generator's draws at its own shape
    (rows, width), zero-padded to the population's, and nothing where it
    does not draw; under a shard, the whole batch's rows cut to the
    shard's."""
    def gens():
        return [torch.Generator().manual_seed(s) for s in (1, 2, 3)]

    d = layers.Draws(gens(), [5, 7, 7], "cpu")
    u = d.rand(7, [(4,), (6,), (3,)], (6,), live=[True, True, False])
    assert torch.equal(u[0, :5, :4], torch.rand((5, 4), generator=gens()[0]))
    assert float(u[0, 5:].abs().sum() + u[0, :, 4:].abs().sum()) == 0.0
    assert torch.equal(u[1], torch.rand((7, 6), generator=gens()[1]))
    assert float(u[2].abs().sum()) == 0.0
    from embracenet_tpu_torch.parallel.mesh import BatchShard

    d = layers.Draws(gens(), [5, 7, 7], "cpu", BatchShard(4, 8, 2, None))
    u = d.rand(4, [(2,)] * 3, (2,))
    whole = torch.rand((5, 2), generator=gens()[0])
    assert torch.equal(u[0, :1], whole[4:]) and float(u[0, 1:].abs().sum()) == 0
    # one trial on a shard draws the whole batch's rows, not the shard's
    one = layers.Draws.one(gens()[1], 4, "cpu", BatchShard(4, 8, 2, None))
    whole = torch.rand((8, 2), generator=gens()[1])
    assert torch.equal(one.rand(4, [(2,)], (2,))[0], whole[4:])


def _data(rng, n=400, d=IN_FEATURES):
    y = (rng.random(n) < 0.3).astype(np.int64)
    w = rng.normal(size=d)
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, w) * 0.9).astype(np.float32)
    codes = rng.integers(0, 4, size=(n, 256)).astype(np.uint8)
    data = {"ffnn": x, "cnn": codes, "y": y}
    return ({k: v[:300] for k, v in data.items()},
            {k: v[300:] for k, v in data.items()})


def _mixed_population(**common):
    flats = _flats((0.5, 0.3, 0.7), FFNN_dropout_l0=0.3, CNN_dropout_l0=0.2,
                   EMBRACENET_dropout_l0=0.2, **common)
    flats[1]["optimizer"], flats[1]["lr"] = "RMSprop", 3e-4
    flats[2]["optimizer"] = "Nadam"
    return ([tspace.params_to_hp("EmbraceNetMultimodal", f) for f in flats],
            [tspace.optimizer_hp(f) for f in flats])


def _assert_trial_as_alone(pop, k, one, exact, params=True):
    """Trial ``k`` of ``pop`` against ``one``, its fit alone: decisions
    exactly, losses and (``params``) parameters bit for bit (``exact``) or
    within rtol 1e-5 / atol 1e-6."""
    # decided and drawn: epochs run and every test AUPRC exactly
    assert pop.epochs_run[k] == one.epochs_run[0]
    assert pop.auprc_test[k] == one.auprc_test[0]
    assert pop.auprc_train[k] == one.auprc_train[0]
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pop.loss_train[k], one.loss_train[0], **tol)
    if params:
        got = tree_to_numpy(tree_map(lambda a: a[k:k + 1], pop.params))
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **tol),
                     got, tree_to_numpy(one.params))


@pytest.mark.parametrize("width_buckets", [False, True])
def test_a_mixed_population_trains_its_trials_as_alone(rng, width_buckets):
    """Three architectures, three optimizers, dropout everywhere, one
    program: each trial's fit alone (its own seeds) draws and decides the
    same, and computes its values within rtol 1e-5 / atol 1e-6.  With
    width buckets a trial's sums run over its population's buckets (zeros
    past its own widths) where its fit alone runs its own: its losses hold
    the tolerance, but Adam and RMSprop turn that rounding in near-zero
    gradients into steps of up to lr (a conv bias before BatchNorm has an
    analytic gradient of 0), so its parameters are compared without
    buckets only."""
    train, test = _data(rng)
    hps, opts = _mixed_population()
    cfg = TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=100,
                      width_buckets=width_buckets)
    init_seeds, run_seeds = engine.seed_streams(7, 3)
    calls, real = [], K.fused_embrace

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    K.fused_embrace = counting
    try:
        pop = engine.fit(SPEC, hps, opts, train, test, cfg,
                         init_seeds=init_seeds, run_seeds=run_seeds,
                         device="cpu")
    finally:
        K.fused_embrace = real
    # one kernel call a population forward pass, every trial in it
    n_tr = balanced_plan(train["y"], 100, seed=123).idx.shape[0]
    n_ev = eval_plan(len(test["y"]), 200, seed=123).idx.shape[0]
    assert len(calls) == n_tr + n_ev and all(s[0] == 3 for s in calls)
    for k in range(3):
        one = engine.fit(SPEC, [hps[k]], [opts[k]], train, test, cfg,
                         init_seeds=init_seeds[k:k + 1],
                         run_seeds=run_seeds[k:k + 1], device="cpu")
        _assert_trial_as_alone(pop, k, one, exact=False,
                               params=not width_buckets)


def test_a_population_of_two_equals_its_fits_alone_bit_for_bit(rng):
    """Mixed architectures and optimizers, two trials: a lone trial's
    products run as one of two (``layers.population_invariant``), so its
    fit sums exactly as the population's."""
    train, test = _data(rng)
    hps, opts = _mixed_population()
    hps, opts = hps[1:], opts[1:]
    cfg = TrainConfig(num_epochs=2, epoch_chunk=1, batch_size=100)
    init_seeds, run_seeds = engine.seed_streams(9, 2)
    pop = engine.fit(SPEC, hps, opts, train, test, cfg, init_seeds=init_seeds,
                     run_seeds=run_seeds, device="cpu")
    for k in range(2):
        one = engine.fit(SPEC, [hps[k]], [opts[k]], train, test, cfg,
                         init_seeds=init_seeds[k:k + 1],
                         run_seeds=run_seeds[k:k + 1], device="cpu")
        _assert_trial_as_alone(pop, k, one, exact=True)


def test_fold_fused_padded_plans_train_each_trial_as_alone(rng):
    """A fold-fused population (two folds of 300 and 170 train rows, the
    mixed trials split over them): each trial steps through its own plan,
    frozen and drawing nothing past it, and equals its fit alone on its
    fold with the stack's rows (``plan_rows``)."""
    (tr_a, te_a), (tr_b, te_b) = _data(rng), _data(rng)
    tr_b = {k: v[:170] for k, v in tr_b.items()}
    te_b = {k: v[:60] for k, v in te_b.items()}
    hps, opts = _mixed_population()
    cfg = TrainConfig(num_epochs=2, epoch_chunk=2, batch_size=40)
    cat = {k: np.concatenate([tr_a[k], tr_b[k]]) for k in tr_a}
    cat_te = {k: np.concatenate([te_a[k], te_b[k]]) for k in te_a}
    plan_of = [balanced_plan(tr_a["y"], 40),
               shift_plan(balanced_plan(tr_b["y"], 40), 300)]
    eval_of = [eval_plan(100, 80), shift_plan(eval_plan(60, 80), 100)]
    fold_of = [0, 1, 1]
    init_seeds, run_seeds = engine.seed_streams(4, 3)
    pop = engine.fit(SPEC, hps, opts, cat, cat_te, cfg,
                     train_plans=[plan_of[f] for f in fold_of],
                     eval_plans=[eval_of[f] for f in fold_of],
                     init_seeds=init_seeds, run_seeds=run_seeds, device="cpu")
    rows = (max(p.idx.shape[1] for p in plan_of),
            max(p.idx.shape[1] for p in eval_of))
    for k, f in enumerate(fold_of):
        tr, te = ((tr_a, te_a), (tr_b, te_b))[f]
        one = engine.fit(SPEC, [hps[k]], [opts[k]], tr, te, cfg,
                         init_seeds=init_seeds[k:k + 1],
                         run_seeds=run_seeds[k:k + 1], device="cpu",
                         plan_rows=rows)
        _assert_trial_as_alone(pop, k, one, exact=False)


def test_a_stacked_step_is_one_program_for_every_trial(rng):
    """``population_step`` takes the whole population: each trial's loss,
    logits and new params are its ``train_step``'s bit for bit (two mixed
    trials; a lone step's products run as one of two), and a frozen trial
    (``upd`` False) keeps its params, BN state and optimizer state."""
    train, _ = _data(rng)
    hps, opts = _mixed_population()
    hps, opts = hps[1:], opts[1:]
    gens = [torch.Generator().manual_seed(s) for s in (11, 12)]
    inits = [SPEC.init(g, h) for g, h in zip(gens, hps)]
    params = engine.stack_trials([i[0] for i in inits])
    bn = engine.stack_trials([i[1] for i in inits])
    state = toptim.init_state(params, lead=(2,))
    opt_hp = {k: torch.as_tensor(np.asarray([o[k] for o in opts]))
              for k in ("optimizer", "lr", "weight_decay")}
    opt_hp["lr"], opt_hp["weight_decay"] = (opt_hp["lr"].float(),
                                            opt_hp["weight_decay"].float())
    idx = torch.as_tensor(balanced_plan(train["y"], 100).idx[0])
    data = engine._device_data(train, SPEC, torch.device("cpu"))
    inputs, y = engine._gather(data, idx, SPEC)
    mask = torch.ones(2, len(idx))
    statics = engine._resolve_statics(SPEC, hps, TrainConfig())
    own = [engine._resolve_statics(SPEC, [h], TrainConfig()) for h in hps]
    trials = layers.Trials(hps, stack_hps(hps), own, layers.Draws(
        [torch.Generator().manual_seed(s) for s in (5, 6)], [len(idx)] * 2,
        "cpu"))
    with layers.population_invariant():
        for upd in ([True, True], [True, False]):
            loss, logits, new_p, new_bn, new_s = engine.population_step(
                SPEC, params, bn, state, trials, opt_hp, inputs, y, mask,
                None, statics, upd=torch.tensor(upd))
            trials = dataclasses.replace(trials, draws=layers.Draws(
                [torch.Generator().manual_seed(s) for s in (5, 6)],
                [len(idx)] * 2, "cpu"))
        for k, s in enumerate((5, 6)):
            one = engine.train_step(SPEC, engine._trial(params, k),
                                    engine._trial(bn, k),
                                    engine._trial(state, k), hps[k],
                                    {k_: v[k] for k_, v in opt_hp.items()},
                                    inputs, y, mask[k], s, None, statics)
            assert float(loss[k]) == float(one[0])
            assert torch.equal(logits[k], one[1])
            if k == 1:   # frozen in the second call
                pairs = (zip(tree_leaves(engine._trial(new_p, k)),
                             tree_leaves(engine._trial(params, k))),
                         zip(tree_leaves(engine._trial(new_bn, k)),
                             tree_leaves(engine._trial(bn, k))))
                assert torch.equal(new_s["step"][k], state["step"][k])
            else:
                pairs = (zip(tree_leaves(engine._trial(new_p, k)),
                             tree_leaves(one[2])),
                         zip(tree_leaves(engine._trial(new_bn, k)),
                             tree_leaves(one[3])))
            for a, b in (ab for pair in pairs for ab in pair):
                assert torch.equal(a, b)


def test_stack_hps_is_the_jax_stack_trials():
    flats = _flats((0.5, 0.3, 0.7))
    got = stack_hps([tspace.params_to_hp("EmbraceNetMultimodal", f)
                     for f in flats])
    want = jengine.stack_trials([jspace.params_to_hp("EmbraceNetMultimodal", f)
                                 for f in flats])
    jax.tree.map(lambda w, g: np.testing.assert_array_equal(g.numpy(),
                                                            np.asarray(w)),
                 want, got)


def test_serving_is_a_population_of_one(rng, tmp_path):
    """A loaded model stacks its hyperparameters once and calls
    ``apply_trials``: its outputs equal ``spec.apply`` of the trial."""
    from embracenet_tpu_torch.models.reload import ReloadedModel

    flat = flat_embracenet(0.4)
    hp = tspace.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = SPEC.init(torch.Generator().manual_seed(0), hp)
    model = ReloadedModel("EmbraceNetMultimodal", params, bn, flat,
                          in_features_ffnn=IN_FEATURES, device="cpu", seed=3)
    model.BATCH = 10           # one micro-batch of the request's 10 rows
    data = {"ffnn": rng.normal(size=(10, IN_FEATURES)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(10, 256)).astype(np.uint8)}
    got = model(data, logits=True)
    want, _ = SPEC.apply(params, bn, hp, {k: t(v) for k, v in data.items()},
                         False, 3, None, None, dict(model.statics))
    np.testing.assert_array_equal(got, want.numpy())
    assert dataclasses.is_dataclass(model.trials) and len(model.trials) == 1


def _module_apply(model, params, bn, hp, inputs, train, seed, mask):
    """One trial through the family module's own ``apply``, its draws from
    a CPU generator seeded with ``seed``."""
    from embracenet_tpu_torch.data import codec
    from embracenet_tpu_torch.models import (cnn, cnn_lstm, concatnet,
                                             embracenet, ffnn)

    gen = torch.Generator().manual_seed(seed)
    x = codec.one_hot(inputs["cnn"]) if "cnn" in inputs else None
    if model == "FFNN":
        return ffnn.apply(params, hp, inputs["ffnn"], train=train,
                          generator=gen), bn
    if model == "CNN":
        return cnn.apply(params, bn, hp, x, train=train, generator=gen,
                         row_mask=mask)
    if model == "CNN_LSTM":
        return cnn_lstm.apply(params, bn, hp, x, train=train, seed=seed,
                              row_mask=mask)
    mod = embracenet if model == "EmbraceNetMultimodal" else concatnet
    return mod.apply(params, bn, hp, inputs["ffnn"], x, train=train,
                     seed=seed, row_mask=mask)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("model", ["FFNN", "CNN", "CNN_LSTM",
                                   "EmbraceNetMultimodal",
                                   "ConcatNetMultimodal"])
def test_spec_apply_is_the_module_apply_and_a_population_of_one(rng, model,
                                                                train):
    """``spec.apply`` is the family module's ``apply`` and its
    ``apply_trials`` of a population of one (stacked here by hand, its
    draws from a generator seeded with the same seed), bit for bit: logits
    and new BatchNorm state."""
    spec = get_spec(model, IN_FEATURES)
    hp = tspace.params_to_hp(model, tspace.sample_params(
        model, np.random.default_rng(4)))
    params, bn = spec.init(torch.Generator().manual_seed(1), hp)
    inputs = {"ffnn": t(rng.normal(size=(12, IN_FEATURES)).astype(np.float32)),
              "cnn": t(rng.integers(0, 4, size=(12, 256)).astype(np.uint8))}
    inputs = {k: v for k, v in inputs.items() if k in spec.inputs}
    mask = torch.ones(12)
    mask[-2:] = 0.0
    seed = 29
    got = spec.apply(params, bn, hp, inputs, train, seed, mask, None)
    mod = _module_apply(model, params, bn, hp, inputs, train, seed, mask)
    draws = layers.Draws.one(torch.Generator().manual_seed(seed), 12,
                             "cpu") if train else None
    stack = lambda tree: tree_map(lambda a: a[None], tree)  # noqa: E731
    logits, new_bn = spec.apply_trials(
        stack(params), stack(bn), layers.Trials([hp], stack_hps([hp]), None,
                                                draws),
        inputs, train, mask[None], None, None, None, seed)
    pop = (logits[0], tree_map(lambda a: a[0], new_bn))
    for other in (mod, pop):
        assert torch.equal(got[0], other[0])
        a, b = tree_leaves(got[1]), tree_leaves(other[1])
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    if train and model != "FFNN":
        # the draws moved the logits: a train forward is not an eval one
        assert not torch.equal(got[0], spec.apply(params, bn, hp, inputs,
                                                  False, seed, mask, None)[0])
