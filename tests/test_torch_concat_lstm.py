"""ConcatNetMultimodal and CNN_LSTM in the port against the JAX package, on
the CPU.

* Forward: JAX ``init`` -> numpy -> the port's ``apply`` gives the JAX
  logits and BN state within 1e-5 of their largest magnitude (float32:
  products, convolutions and the LSTM's recurrence summed in another
  order), in eval mode and in train mode at dropout 0, for ConcatNet on
  full, width-bucketed and pre-shrunk parameters, and for CNN_LSTM at 1-2
  conv blocks and 1-2 LSTM layers; under bf16 compute within 2e-2 (both
  round the convolutions to bf16, summed in another order).
* One training step (loss, every gradient, Adam's new params) within 1e-5
  of JAX's ``value_and_grad`` + ``apply_update``.
* Trees with a list subtree (CNN_LSTM's LSTM layers): the engine's per-trial
  slice, the optimizer, stacking and reload walk into the list.
* Serving: a JAX-written checkpoint predicts alike in the port;
  ``models/utils`` equals the JAX module.
* End to end: a ConcatNet CV and a CNN_LSTM CV through ``train(...,
  device="cpu")``, CNN_LSTM through ``run_search``'s grouped branch with
  its real spec.
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import IN_FEATURES, flat_embracenet, t, to_torch

from embracenet_tpu import config as jconfig
from embracenet_tpu.data.codec import one_hot as j_one_hot
from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.models import cnn_lstm as jcl
from embracenet_tpu.models import concatnet as jcat
from embracenet_tpu.models import reload as jreload
from embracenet_tpu.models import utils as jutils
from embracenet_tpu.ops import losses as jlosses
from embracenet_tpu.ops import optim as joptim
from embracenet_tpu.training import slicing as jslicing
from embracenet_tpu.training.checkpoint import save_checkpoint as j_save
from embracenet_tpu.training.modelspec import get_spec as j_get_spec
from embracenet_tpu_torch import api as tapi
from embracenet_tpu_torch import config as tconfig
from embracenet_tpu_torch.config import CVConfig, TrainConfig
from embracenet_tpu_torch.convert import tree_leaves, tree_map, tree_to_numpy
from embracenet_tpu_torch.data.codec import one_hot
from embracenet_tpu_torch.hpo import search as tsearch
from embracenet_tpu_torch.hpo import space as tspace
from embracenet_tpu_torch.hpo.samplers import ReplaySampler
from embracenet_tpu_torch.models import cnn_lstm as tcl
from embracenet_tpu_torch.models import concatnet as tcat
from embracenet_tpu_torch.models import reload as treload
from embracenet_tpu_torch.models import utils as tutils
from embracenet_tpu_torch.ops import losses as tlosses
from embracenet_tpu_torch.ops import optim as toptim
from embracenet_tpu_torch.training import cv as tcv
from embracenet_tpu_torch.training import engine as tengine
from embracenet_tpu_torch.training import slicing as tslicing
from embracenet_tpu_torch.training.modelspec import get_spec as t_get_spec

TOL = 1e-5
BF16_TOL = 2e-2
CAT = "ConcatNetMultimodal"
LSTM = "CNN_LSTM"
_CAT_STATICS = ("cnn_max_depth", "cnn_max_channels", "cnn_max_kernels",
                "ffnn_max_width", "post_max")

j_cat_init = jax.jit(jcat.init_from_fans, static_argnums=2)
j_cat_apply = jax.jit(jcat.apply, static_argnames=_CAT_STATICS + (
    "train", "compute_dtype"))


def close_rel(got, want, rel):
    """|got - want| <= rel * (|want| + max|want|), element by element."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def flat_concat(n_post=2, cnn_layers=2, ffnn_layers=2, widths=(512, 64, 32),
                dropout=0.0):
    flat = {k: v for k, v in flat_embracenet(0.5, cnn_layers=cnn_layers,
                                             ffnn_layers=ffnn_layers).items()
            if not k.startswith(("EMBRACENET", "n_post", "selection"))}
    flat["CONCATNET_n_post_layers"] = n_post
    for i, w in enumerate(widths):
        flat[f"CONCATNET_n_units_l{i}"] = w
        flat[f"CONCATNET_dropout_l{i}"] = dropout
    return flat


def flat_lstm(n_layers=1, lstm_layers=1, channels=(16, 32), hidden=32):
    flat = {"n_layers": n_layers, "LSTM_hidden_layer_size": hidden,
            "LSTM_n_layers": lstm_layers,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    for i, (c, k) in enumerate(zip(channels, (5, 11))):
        flat[f"out_channels_l{i}"] = c
        flat[f"kernel_size_l{i}"] = k
        flat[f"dropout_l{i}"] = 0.0
    return flat


def _inputs(rng, b=6, d=IN_FEATURES):
    return {"ffnn": rng.normal(size=(b, d)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(b, 256)).astype(np.uint8)}


def _concat_case(rng, seed=2, **kw):
    hp = jspace.params_to_hp(CAT, flat_concat(**kw))
    params, bn = j_cat_init(jax.random.PRNGKey(seed),
                            jcat.fan_ins(hp, IN_FEATURES), IN_FEATURES)
    return hp, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bn), \
        _inputs(rng)


def _lstm_case(rng, seed=3, **kw):
    hp = jspace.params_to_hp(LSTM, flat_lstm(**kw))
    params, bn = jax.jit(lambda k: jcl.init(k, hp))(jax.random.PRNGKey(seed))
    return hp, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bn), \
        _inputs(rng)


# ---------------------------------------------------------------------------
# forward parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("layout", ["full", "bucketed", "shrunk"])
def test_concatnet_apply_matches_jax(rng, layout, train):
    hp, params, bn, inputs = _concat_case(rng, n_post=3 if train else 2)
    st = j_get_spec(CAT, IN_FEATURES).statics([hp])
    assert t_get_spec(CAT, IN_FEATURES).statics([hp]) == st
    if layout == "full":
        st = {}
    j_params, j_bn = params, bn
    t_params, t_bn = to_torch(params), to_torch(bn)
    if layout == "shrunk":
        j_params, j_bn = jslicing.shrink(CAT, params, bn, st)
        t_params, t_bn = tslicing.shrink(CAT, t_params, t_bn, st)
        assert t_params["post_w0"].shape == j_params["post_w0"].shape
        assert t_params["post_w0"].shape[0] < tcat.CONCAT_DIM
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(b.numpy(), a),
                     jax.tree.map(np.asarray, (j_params, j_bn)), (t_params, t_bn))
    mask = np.asarray([1, 1, 1, 1, 0, 1], np.float32)
    kw = dict(train=train, row_mask=mask if train else None)
    l_j, s_j = j_cat_apply(j_params, j_bn, hp, inputs["ffnn"],
                           j_one_hot(inputs["cnn"]), key=jax.random.PRNGKey(0),
                           **kw, **st)
    l_t, s_t = tcat.apply(t_params, t_bn, hp, t(inputs["ffnn"]),
                          one_hot(t(inputs["cnn"])), seed=0,
                          train=train, row_mask=t(mask) if train else None, **st)
    close_rel(l_t, l_j, TOL)
    jax.tree.map(lambda a, b: close_rel(b, a, TOL), s_j, s_t)


def test_concatnet_bf16_and_spec_match_jax(rng):
    hp, params, bn, inputs = _concat_case(rng, n_post=1)
    st = j_get_spec(CAT, IN_FEATURES).statics([hp])
    l_j, _ = j_cat_apply(params, bn, hp, inputs["ffnn"],
                         j_one_hot(inputs["cnn"], dtype=jax.numpy.bfloat16),
                         compute_dtype=jax.numpy.bfloat16, **st)
    tspec = t_get_spec(CAT, IN_FEATURES)
    l_t, _ = tspec.apply(to_torch(params), to_torch(bn), hp,
                         {k: t(v) for k, v in inputs.items()}, False, 0, None,
                         torch.bfloat16, st)
    close_rel(l_t, l_j, BF16_TOL)
    # init: the same shapes and fan-ins as the JAX package
    fans = tcat.fan_ins(hp, IN_FEATURES)
    jax.tree.map(np.testing.assert_array_equal, fans,
                 jcat.fan_ins(hp, IN_FEATURES))
    p_t, bn_t = tcat.init_from_fans(torch.Generator().manual_seed(0), fans,
                                    IN_FEATURES)
    assert jax.tree.map(lambda a: tuple(a.shape), (p_t, bn_t)) == \
        jax.tree.map(lambda a: tuple(np.shape(a)), (params, bn))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("n_layers,lstm_layers,channels,hidden", [
    (1, 1, (16, 32), 32), (2, 2, (32, 32), 64)])
def test_cnn_lstm_apply_matches_jax(rng, n_layers, lstm_layers, channels,
                                    hidden, train):
    hp, params, bn, inputs = _lstm_case(rng, n_layers=n_layers,
                                        lstm_layers=lstm_layers,
                                        channels=channels, hidden=hidden)
    assert isinstance(params["lstm"], list) and len(params["lstm"]) == lstm_layers
    assert params["w_fc1"].shape[0] == tcl.timesteps(hp) * hidden
    mask = np.asarray([1, 1, 0, 1, 1, 1], np.float32)
    l_j, s_j = jax.jit(lambda p, b, x: jcl.apply(
        p, b, hp, x, train=train, row_mask=mask if train else None))(
        params, bn, j_one_hot(inputs["cnn"]))
    l_t, s_t = tcl.apply(to_torch(params), to_torch(bn), hp,
                         one_hot(t(inputs["cnn"])), train=train,
                         row_mask=t(mask) if train else None)
    close_rel(l_t, l_j, TOL)
    jax.tree.map(lambda a, b: close_rel(b, a, TOL), s_j, s_t)


def test_cnn_lstm_bf16_casts_only_the_convolutions(rng):
    hp, params, bn, inputs = _lstm_case(rng, n_layers=2, lstm_layers=1,
                                        channels=(16, 32))
    l_j, _ = jax.jit(lambda p, b, x: jcl.apply(
        p, b, hp, x, compute_dtype=jax.numpy.bfloat16))(
        params, bn, j_one_hot(inputs["cnn"], dtype=jax.numpy.bfloat16))
    tspec = t_get_spec(LSTM)
    l_t, _ = tspec.apply(to_torch(params), to_torch(bn), hp,
                         {"cnn": t(inputs["cnn"])}, False, 0, None,
                         torch.bfloat16, tspec.statics([hp]))
    assert l_t.dtype == torch.float32
    close_rel(l_t, l_j, BF16_TOL)


def test_lstm_hidden_menu_matches_jax():
    assert tcl.LSTM_HIDDEN_MENU == jcl.LSTM_HIDDEN_MENU == jconfig.CNN_LSTM_HIDDEN_MENU
    assert tcl.LSTM_HIDDEN_MENU == tconfig.CNN_LSTM_HIDDEN_MENU


def test_cnn_lstm_reshape_flattens_ncw_as_jax():
    """Step s of the LSTM's input is elements 4s..4s+3 of the channel-major
    flatten of [C, L]: a trial of one 16-channel block gives 496 steps."""
    hp = tspace.params_to_hp(LSTM, flat_lstm())
    assert tcl.timesteps(hp) == jcl.timesteps(hp) == 16 * 124 // 4
    widest = tspace.params_to_hp(LSTM, flat_lstm(channels=(64, 96), hidden=128))
    assert tcl.timesteps(widest) == 1984
    h = torch.arange(2 * 16 * 124, dtype=torch.float32).reshape(2, 16, 124)
    seq = h.contiguous().reshape(2, -1, 4)
    np.testing.assert_array_equal(seq.numpy(),
                                  np.asarray(h.numpy()).reshape(2, -1, 4))


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

def _opt_state(np_params):
    srng = np.random.default_rng(7)
    return {"m": jax.tree.map(lambda a: srng.normal(0, 1e-3, a.shape)
                              .astype(np.float32), np_params),
            "v": jax.tree.map(lambda a: (srng.normal(0, 1e-3, a.shape) ** 2
                                         + 1e-6).astype(np.float32), np_params),
            "step": np.float32(10), "m_schedule": np.float32(0.5)}


@pytest.mark.parametrize("case", ["concat", "concat_shrunk", "lstm"])
def test_one_training_step_equals_jax(rng, case):
    if case == "lstm":
        model, (hp, params, bn, inputs) = LSTM, _lstm_case(
            rng, n_layers=1, lstm_layers=2, channels=(16, 32))
        st = {}

        def j_fwd(p, b, x_f, x_c, mask):
            return jcl.apply(p, b, hp, x_c, train=True, row_mask=mask)
    else:
        model, (hp, params, bn, inputs) = CAT, _concat_case(rng, n_post=2)
        st = j_get_spec(CAT, IN_FEATURES).statics([hp]) \
            if case == "concat_shrunk" else {}
        if st:
            params, bn = jax.tree.map(np.asarray, jslicing.shrink(CAT, params,
                                                                  bn, st))

        def j_fwd(p, b, x_f, x_c, mask):
            return jcat.apply(p, b, hp, x_f, x_c, train=True, row_mask=mask,
                              **st)
    b = len(inputs["cnn"])
    y = np.asarray([0, 1, 0, 1, 1, 0], np.int64)
    mask = np.asarray([1, 1, 1, 1, 1, 0], np.float32)
    opt_state = _opt_state(params)
    lr, wd = 1e-3, 1e-4

    @jax.jit
    def j_step(params, bn):
        def loss_fn(p):
            logits, new_bn = j_fwd(p, bn, inputs["ffnn"],
                                   j_one_hot(inputs["cnn"]), mask)
            return jlosses.weighted_cross_entropy(logits, y, mask), new_bn

        (loss, new_bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        new_p, _ = joptim.apply_update(params, grads, opt_state, joptim.ADAM,
                                       lr, wd)
        return loss, grads, new_bn, new_p

    want = jax.tree.map(np.asarray, j_step(params, bn))
    tspec = t_get_spec(model, IN_FEATURES)
    t_inputs = {k: t(v)[:b] for k, v in inputs.items()}
    loss, logits, new_p, new_bn, _ = tengine.train_step(
        tspec, to_torch(params), to_torch(bn), to_torch(opt_state), hp,
        {"optimizer": toptim.ADAM, "lr": lr, "weight_decay": wd}, t_inputs,
        t(y), t(mask), 0, None, dict(tspec.statics([hp]), **st) if st else {})
    assert float(loss) == pytest.approx(float(want[0]), abs=TOL)
    jax.tree.map(lambda w, g: close_rel(g, w, TOL), want[2], new_bn)
    jax.tree.map(lambda w, g: close_rel(g, w, TOL), want[3], new_p)


# ---------------------------------------------------------------------------
# trees with a list subtree
# ---------------------------------------------------------------------------

def test_trees_with_a_list_subtree_are_walked_leaf_by_leaf():
    """CNN_LSTM keeps its LSTM layers in a list.  The per-trial slice of a
    stacked population must slice every leaf (a tree_map that stopped at
    the list returned trial t's *layer* in place of its slice), and the
    optimizer, stacking and the reloaded model's buffers must keep the
    list's structure."""
    gen = torch.Generator().manual_seed(0)
    hp = tspace.params_to_hp(LSTM, flat_lstm(lstm_layers=2))
    trials = [tcl.init(gen, hp) for _ in range(3)]
    stacked = tengine.stack_trials([p for p, _ in trials])
    assert isinstance(stacked["lstm"], list) and len(stacked["lstm"]) == 2
    for tt in range(3):
        sliced = tengine._trial(stacked, tt)
        assert isinstance(sliced["lstm"], list) and len(sliced["lstm"]) == 2
        for layer in range(2):
            for name, leaf in trials[tt][0]["lstm"][layer].items():
                assert torch.equal(sliced["lstm"][layer][name], leaf)
    assert len(tree_leaves(stacked)) == 10 + 4 * 2
    grads = tree_map(torch.ones_like, stacked)
    state = toptim.init_state(stacked)
    new_p, new_state = toptim.apply_update(stacked, grads, state, toptim.ADAM,
                                           1e-2, 0.0)
    assert isinstance(new_state["m"]["lstm"], list)
    for a, b in zip(tree_leaves(new_p), tree_leaves(stacked)):
        assert a.shape == b.shape and not torch.equal(a, b)
    model = treload.ReloadedModel(LSTM, trials[0][0], trials[0][1],
                                  flat_lstm(lstm_layers=2), device="cpu")
    assert isinstance(model.params["lstm"], list)
    assert torch.equal(model.params["lstm"][1]["w_hh"],
                       trials[0][0]["lstm"][1]["w_hh"])


def test_weight_reset_refreshes_the_lstm_and_keeps_batchnorm():
    spec = t_get_spec(LSTM)
    hp = tspace.params_to_hp(LSTM, flat_lstm(lstm_layers=2))
    old_p, old_bn = spec.init(torch.Generator().manual_seed(1), hp)
    new_p, new_bn = tengine.weight_reset(5, spec, hp, old_p, old_bn)
    assert new_bn is old_bn and new_p["bn0"] is old_p["bn0"]
    for layer in range(2):
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            assert not torch.equal(new_p["lstm"][layer][name],
                                   old_p["lstm"][layer][name])


# ---------------------------------------------------------------------------
# specs, slicing, utils, serving
# ---------------------------------------------------------------------------

def test_specs_match_the_jax_package():
    hps = [jspace.params_to_hp(CAT, flat_concat(widths=w, cnn_layers=c))
           for w, c in (((512, 64, 32), 2), ((1024, 128, 16), 1))]
    st = j_get_spec(CAT, IN_FEATURES).statics(hps)
    assert t_get_spec(CAT, IN_FEATURES).statics(hps) == st
    tspec, jspec = t_get_spec(LSTM), j_get_spec(LSTM)
    assert tspec.vmappable is jspec.vmappable is False
    assert tspec.inputs == jspec.inputs == ("cnn",)
    one = jspace.params_to_hp(LSTM, flat_lstm())
    assert tspec.statics([one, one]) == jspec.statics([one, one])
    other = jspace.params_to_hp(LSTM, flat_lstm(hidden=64))
    for spec in (tspec, jspec):
        with pytest.raises(ValueError, match="one architecture"):
            spec.statics([one, other])


def test_concatnet_slicing_matches_the_jax_package(rng):
    hp, params, bn, _ = _concat_case(rng)
    st = j_get_spec(CAT, IN_FEATURES).statics([hp])
    j_small = jax.tree.map(np.asarray, jslicing.shrink(CAT, params, bn, st))
    t_small = tslicing.shrink(CAT, to_torch(params), to_torch(bn), st)
    jax.tree.map(np.testing.assert_array_equal, tree_to_numpy(t_small), j_small)
    j_big = jax.tree.map(np.asarray, jslicing.grow(CAT, *j_small, st))
    t_big = tslicing.grow(CAT, *t_small, st)
    jax.tree.map(np.testing.assert_array_equal, tree_to_numpy(t_big), j_big)
    assert t_big[0]["post_w0"].shape == params["post_w0"].shape


def test_model_utils_match_the_jax_package():
    results = {"K562": {"t": {"FFNN": {"average_CV_AUPRC": 0.4},
                              "CNN": {"average_CV_AUPRC": 0.7}}}}
    np.testing.assert_array_equal(
        tutils.selection_probabilities(results, "K562", "t", 3),
        jutils.selection_probabilities(results, "K562", "t", 3))
    params = {"ffnn": {"w0": 1}, "cnn": {"conv_w0": 2}, "w_head": 3, "w0": 4}
    assert tutils.get_single_model_params(params) == \
        jutils.get_single_model_params(params)
    assert tutils.drop_last_layers(params, "FFNN") == \
        jutils.drop_last_layers(params, "FFNN")
    for mod in (tutils, jutils):
        with pytest.raises(ValueError):
            mod.drop_last_layers(params, "LSTM")
    text = ("Trial 3 finished\n  Params:\n    n_layers: 2\n    lr: 0.001\n"
            "    optimizer: Adam\n\nValue: 0.5\n")
    assert tutils.parse_printed_params(text) == \
        jutils.parse_printed_params(text) == \
        {"n_layers": 2, "lr": 0.001, "optimizer": "Adam"}


@pytest.mark.parametrize("model", [CAT, LSTM])
def test_a_jax_checkpoint_predicts_alike_in_the_port(rng, tmp_path,
                                                     monkeypatch, model):
    monkeypatch.setattr(jreload.ReloadedModel, "BATCH", 64)
    monkeypatch.setattr(treload.ReloadedModel, "BATCH", 64)
    if model == CAT:
        flat = flat_concat(n_post=3)
        hp, params, bn, _ = _concat_case(rng, n_post=3)
    else:
        flat = flat_lstm(n_layers=2, lstm_layers=2, channels=(16, 32))
        hp, params, bn, _ = _lstm_case(rng, n_layers=2, lstm_layers=2,
                                       channels=(16, 32))
    path = str(tmp_path / "ck")
    j_save(path, {"params": params, "bn_state": bn},
           {"model": model, "model_params": flat})
    data = dict(_inputs(rng, b=100), y=(rng.random(100) < 0.3).astype(np.int64))
    want = jreload.load_model(path)(data, logits=True)
    got = tapi.predict(path, data, device="cpu")
    loaded = treload.load_model(path, device="cpu")
    close_rel(loaded(data, logits=True), want, TOL)
    np.testing.assert_allclose(got, np.asarray(jax.nn.softmax(want)), atol=TOL)
    metrics = tapi.evaluate(path, data, device="cpu")
    assert np.isfinite(metrics["AUPRC"]) and 0 <= metrics["accuracy"] <= 1


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

def _learnable(rng, n=120, d=8):
    y = (rng.random(n) < 0.35).astype(np.int64)
    w = rng.normal(size=d)
    x = (rng.normal(size=(n, d)) + np.outer(y * 2 - 1, w)).astype(np.float32)
    return {"ffnn": x, "cnn": rng.integers(0, 4, size=(n, 256)).astype(np.uint8),
            "y": y}


def test_train_runs_concatnet_cv_on_the_cpu(rng, tmp_path):
    data = _learnable(rng)
    draw = dict(flat_concat(n_post=1, cnn_layers=1, ffnn_layers=1,
                            widths=(512, 32, 16)),
                CNN_out_channels_l0=16, FFNN_n_units_l0=32)
    draws = [draw, dict(draw, lr=2e-3, CONCATNET_n_post_layers=2)] * 2
    scores = tapi.train(
        CAT, "K562", "t", data=data,
        cv_cfg=CVConfig(n_folds=2, n_trials=2, sampler=ReplaySampler(draws)),
        train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=40,
                              width_buckets=True),
        storage=str(tmp_path / "cat.db"), checkpoint_dir=str(tmp_path),
        device="cpu")
    assert len(scores["final_test_AUPRC_scores"]) == 2
    assert all(np.isfinite(scores["final_test_AUPRC_scores"]))
    ck = str(tmp_path / tcv.checkpoint_name("K562", CAT, "t", 0))
    model = treload.load_model(ck, device="cpu")
    # the bucketed fit grew its parameters back to the supernet's shapes
    assert tuple(model.params["post_w0"].shape) == (tcat.CONCAT_DIM, tcat.P)
    probs = model(data)
    assert probs.shape == (len(data["y"]), 2) and np.isfinite(probs).all()


def test_train_runs_cnn_lstm_cv_through_the_grouped_search(rng, tmp_path,
                                                          monkeypatch):
    data = _learnable(rng)
    small = flat_lstm()
    deeper = flat_lstm(n_layers=2, channels=(16, 32))
    draws = [small, deeper, small, dict(small, lr=2e-3)]
    fits = []
    real_fit = tengine.fit

    def counting_fit(spec, hps, *a, **kw):
        fits.append((spec.name, [int(h["n_layers"]) for h in hps],
                     bool(kw.get("report_fn"))))
        return real_fit(spec, hps, *a, **kw)

    monkeypatch.setattr(tengine, "fit", counting_fit)
    scores = tapi.train(
        LSTM, "K562", "t", data=data,
        cv_cfg=CVConfig(n_folds=2, n_trials=2, sampler=ReplaySampler(draws)),
        train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=40),
        storage=str(tmp_path / "lstm.db"), checkpoint_dir=str(tmp_path),
        device="cpu")
    # fold 1 draws two architectures: one fit each; fold 2 draws one
    # architecture twice: one fit of both; a retrain after each search
    assert [f for f in fits if f[2]] == [(LSTM, [1], True), (LSTM, [2], True),
                                         (LSTM, [1, 1], True)]
    assert len([f for f in fits if not f[2]]) == 2
    assert all(np.isfinite(scores["final_test_AUPRC_scores"]))
    ck = str(tmp_path / tcv.checkpoint_name("K562", LSTM, "t", 0))
    probs = tapi.predict(ck, data, device="cpu")
    assert probs.shape == (len(data["y"]), 2) and np.isfinite(probs).all()
    assert isinstance(treload.load_model(ck, device="cpu").params["lstm"], list)


def test_run_search_groups_cnn_lstm_trials_by_architecture(rng, tmp_path,
                                                          monkeypatch):
    data = _learnable(rng, n=100)
    tr = {k: v[:70] for k, v in data.items()}
    va = {k: v[70:] for k, v in data.items()}
    a, b = flat_lstm(), flat_lstm(hidden=64)
    seeds = []
    real_fit = tengine.fit

    def counting_fit(spec, hps, *args, **kw):
        seeds.append(([int(h["lstm_hidden"]) for h in hps], kw["seed"]))
        return real_fit(spec, hps, *args, **kw)

    monkeypatch.setattr(tengine, "fit", counting_fit)
    res = tsearch.run_search(t_get_spec(LSTM), LSTM, tr, va, "s",
                             storage=str(tmp_path / "s.db"),
                             sampler=ReplaySampler([a, b, dict(a, lr=2e-3)]),
                             n_trials=3,
                             train_cfg=TrainConfig(num_epochs=1, batch_size=35),
                             checkpoint_dir=str(tmp_path), seed=5,
                             device="cpu")
    assert seeds == [([32, 32], 5), ([64], 5 + 7919)]
    assert res.n_complete == 3 and res.best_model is not None
