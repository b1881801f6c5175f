"""The port's training ops against the JAX package: losses, the optimizer,
batch plans, width slicing and population bucketing.

Inputs come from seeded numpy and go through both packages; the JAX side
runs jitted.  Tolerances: losses rtol 1e-6 (the same float32 ops); the
optimizer 1e-6 in float32 and 1e-2 where bf16 storage rounds (moments or
live params); plans, slices and groups exactly.  Losses and optimizers are
also held to the committed torch goldens ``tests/goldens/*.npz`` with the
tolerances of ``tests/test_losses_optim.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import IN_FEATURES, close, flat_embracenet, t

from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.models import embracenet as jem
from embracenet_tpu.ops import losses as jlosses
from embracenet_tpu.ops import optim as joptim
from embracenet_tpu.training import batching as jbatching
from embracenet_tpu.training import bucketing as jbucketing
from embracenet_tpu.training import slicing as jslicing
from embracenet_tpu.training.modelspec import get_spec as jget_spec
from embracenet_tpu_torch.convert import tree_map, tree_to_torch
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.ops import losses as tlosses
from embracenet_tpu_torch.ops import optim as toptim
from embracenet_tpu_torch.training import batching as tbatching
from embracenet_tpu_torch.training import bucketing as tbucketing
from embracenet_tpu_torch.training import slicing as tslicing
from embracenet_tpu_torch.training.modelspec import get_spec as tget_spec

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _golden(name):
    return np.load(os.path.join(GOLDENS, f"{name}.npz"))["want"]


@pytest.mark.parametrize("seed", range(4))
def test_losses_match_jax_with_masks(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(40, 2)).astype(np.float32)
    target = (rng.random(40) < 0.3).astype(np.int64)
    target[:2] = (1, 0)
    mask = (rng.random(40) < 0.8).astype(np.float32)
    mask[:2] = 1.0
    want_w = jax.jit(jlosses.ins_weights)(target, mask)
    got_w = tlosses.ins_weights(t(target), t(mask))
    for g, w in zip(got_w, want_w):
        close(g, w, 1e-6)
    want = jax.jit(jlosses.weighted_cross_entropy)(logits, target, mask)
    got = tlosses.weighted_cross_entropy(t(logits), t(target), t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # a fully masked batch has loss 0 in both
    zero = np.zeros(40, np.float32)
    assert float(tlosses.weighted_cross_entropy(t(logits), t(target), t(zero))) == 0.0
    assert float(jlosses.weighted_cross_entropy(logits, target, zero)) == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_weighted_ce_matches_torch_golden(seed):
    # the inputs of tests/test_losses_optim.py::test_weighted_ce_matches_torch
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(32, 2)).astype(np.float32)
    target = (rng.random(32) < 0.3).astype(np.int64)
    target[0], target[1] = 1, 0
    got = float(tlosses.weighted_cross_entropy(t(logits), t(target)))
    assert got == pytest.approx(float(_golden(f"losses_ce_seed{seed}")), rel=1e-5)


def _param_tree(rng):
    return {"w": rng.normal(size=(6, 4)).astype(np.float32),
            "sub": {"b": rng.normal(size=(4,)).astype(np.float32)}}


@pytest.mark.parametrize("state_bf16", [False, True])
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("opt_id", [joptim.ADAM, joptim.NADAM, joptim.RMSPROP])
def test_apply_update_matches_jax(opt_id, master, state_bf16):
    rng = np.random.default_rng(opt_id)
    params = _param_tree(rng)
    grads = [_param_tree(rng) for _ in range(5)]
    lr, wd = 1e-2, 1e-3
    sd_j = jnp.bfloat16 if state_bf16 else None
    sd_t = torch.bfloat16 if state_bf16 else None

    @jax.jit
    def j_run(p, gs):
        s = joptim.init_state(p, sd_j, master)
        if master:
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
        for g in gs:
            p, s = joptim.apply_update(p, g, s, opt_id, lr, wd)
        return p, s

    want_p, want_s = j_run(params, grads)
    p = tree_to_torch(params, "cpu")
    s = toptim.init_state(p, sd_t, master)
    if master:
        p = tree_map(lambda a: a.to(torch.bfloat16), p)
    for g in grads:
        p, s = toptim.apply_update(p, tree_to_torch(g, "cpu"), s, opt_id, lr, wd)
    tol = 1e-2 if (master or state_bf16) else 1e-6

    def check(want, got, tol):
        jax.tree.map(lambda w, g: close(g.float(), np.asarray(w, np.float32), tol),
                     want, got)

    check(want_p, p, tol)
    check(want_s["m"], s["m"], tol)
    check(want_s["v"], s["v"], tol)
    assert float(s["step"]) == float(want_s["step"]) == 5.0
    close(s["m_schedule"], want_s["m_schedule"], 1e-6)
    if master:
        check(want_s["master"], s["master"], 1e-2 if state_bf16 else 1e-6)


@pytest.mark.parametrize("name,opt_id,seed,rtol,atol", [
    ("Adam", toptim.ADAM, 0, 1e-4, 1e-6),
    ("RMSprop", toptim.RMSPROP, 0, 1e-4, 1e-6),
    ("NAdam", toptim.NADAM, 1, 1e-3, 1e-5)])
def test_optimizers_match_torch_goldens(name, opt_id, seed, rtol, atol):
    # the inputs of tests/test_losses_optim.py (7 steps, lr 1e-2, wd 1e-3)
    rng = np.random.default_rng(seed)
    params = {"w": t(rng.normal(size=(5,)).astype(np.float32))}
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(7)]
    state = toptim.init_state(params)
    for g in grads:
        params, state = toptim.apply_update(params, {"w": t(g)}, state, opt_id,
                                            1e-2, 1e-3)
    np.testing.assert_allclose(params["w"].numpy(), _golden(f"optim_{name}"),
                               rtol=rtol, atol=atol)


def test_none_gradient_is_a_zero_gradient():
    p = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    s = toptim.init_state(p)
    with_none, _ = toptim.apply_update(p, {"a": None, "b": None}, s, 0, 0.1, 0.01)
    zeros, _ = toptim.apply_update(p, {"a": torch.zeros(3), "b": torch.zeros(2)},
                                   s, 0, 0.1, 0.01)
    for k in p:
        assert torch.equal(with_none[k], zeros[k])


@pytest.mark.parametrize("n,batch,seed", [(503, 100, 123), (1000, 64, 7),
                                          (37, 10, 0), (250, 250, 9)])
def test_batch_plans_equal_jax(n, batch, seed):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.2).astype(np.int64)
    y[:3] = 1
    for want, got in ((jbatching.balanced_plan(y, batch, seed),
                       tbatching.balanced_plan(y, batch, seed)),
                      (jbatching.eval_plan(n, 2 * batch, seed),
                       tbatching.eval_plan(n, 2 * batch, seed))):
        np.testing.assert_array_equal(got.idx, want.idx)
        np.testing.assert_array_equal(got.mask, want.mask)
        assert got.metric_divisor == want.metric_divisor
    shifted = tbatching.shift_plan(tbatching.eval_plan(n, batch, seed), 1000)
    np.testing.assert_array_equal(
        shifted.idx, jbatching.shift_plan(jbatching.eval_plan(n, batch, seed), 1000).idx)


def _population(seeds):
    flats = [jspace.sample_params("EmbraceNetMultimodal", np.random.default_rng(s))
             for s in seeds]
    return ([jspace.params_to_hp("EmbraceNetMultimodal", f) for f in flats],
            [tspace.params_to_hp("EmbraceNetMultimodal", f) for f in flats])


def test_plan_buckets_equal_jax():
    j_hps, t_hps = _population(range(8))
    for in_f in (16, 566):
        want = jbucketing.plan_buckets(jget_spec("EmbraceNetMultimodal", in_f),
                                       "EmbraceNetMultimodal", j_hps,
                                       in_features=in_f)
        got = tbucketing.plan_buckets(tget_spec("EmbraceNetMultimodal", in_f),
                                      "EmbraceNetMultimodal", t_hps,
                                      in_features=in_f)
        assert got == want
    st = tget_spec("EmbraceNetMultimodal", 16).statics(t_hps[:3])
    assert tbucketing.flops_of_statics("EmbraceNetMultimodal", st, 16) == \
        jbucketing.flops_of_statics("EmbraceNetMultimodal",
                                    jget_spec("EmbraceNetMultimodal", 16)
                                    .statics(j_hps[:3]), 16)


@pytest.mark.parametrize("stacked", [False, True])
def test_shrink_then_grow_equals_jax(stacked):
    flat = flat_embracenet(0.5, n_post=2)
    hp = jspace.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = jax.jit(jem.init_from_fans, static_argnums=2)(
        jax.random.PRNGKey(0), jem.fan_ins(hp, IN_FEATURES), IN_FEATURES)
    params, bn = jax.tree.map(np.asarray, (params, bn))
    if stacked:
        params, bn = jax.tree.map(lambda a: np.stack([a, a + 1]), (params, bn))
    statics = jget_spec("EmbraceNetMultimodal", IN_FEATURES).statics([hp])
    assert tslicing.has_width_statics(statics)
    j_small = jslicing.shrink("EmbraceNetMultimodal", params, bn, statics)
    t_small = tslicing.shrink("EmbraceNetMultimodal", tree_to_torch(params),
                              tree_to_torch(bn), statics)
    j_full = jslicing.grow("EmbraceNetMultimodal", *j_small, statics)
    t_full = tslicing.grow("EmbraceNetMultimodal", *t_small, statics)
    for got, want in ((t_small, j_small), (t_full, j_full)):
        jax.tree.map(lambda w, g: np.testing.assert_array_equal(g.numpy(), np.asarray(w)),
                     want, got)
