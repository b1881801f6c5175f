"""Port model families vs the JAX package on the same weights (CPU, eval
mode unless stated).  Weights come from the JAX ``init`` and cross as numpy
arrays; logits and BN state must agree at rtol = atol = 1e-4 (float32
products and convolutions summed in another order through several
layers)."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import IN_FEATURES, close, flat_embracenet, hp_cnn, hp_ffnn, t, to_torch

from embracenet_tpu.data.codec import one_hot as j_one_hot
from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.models import cnn as jcnn
from embracenet_tpu.models import embracenet as jem
from embracenet_tpu.models import ffnn as jffnn
from embracenet_tpu.training.modelspec import get_spec as j_get_spec
from embracenet_tpu_torch.data.codec import one_hot
from embracenet_tpu_torch.models import cnn as tcnn
from embracenet_tpu_torch.models import embracenet as tem
from embracenet_tpu_torch.models import ffnn as tffnn
from embracenet_tpu_torch.training.modelspec import get_spec as t_get_spec

TOL = 1e-4

# the JAX side runs jitted: one compile per program instead of one per
# eager op keeps this file within seconds on the CPU
_BUCKETS = ("max_depth", "max_channels", "max_kernels")
j_ffnn_init = jax.jit(jffnn.init_from_fans, static_argnums=2)
j_ffnn_features = jax.jit(jffnn.features, static_argnames="max_width")
j_ffnn_apply = jax.jit(jffnn.apply, static_argnames="max_width")
j_cnn_init = jax.jit(jcnn.init_from_fans)
j_cnn_features = jax.jit(jcnn.features, static_argnames=_BUCKETS)
j_cnn_apply = jax.jit(jcnn.apply, static_argnames=_BUCKETS + ("train",))
j_em_init = jax.jit(jem.init_from_fans, static_argnums=2)
j_em_apply = jax.jit(jem.apply, static_argnames=(
    "cnn_max_depth", "cnn_max_channels", "cnn_max_kernels", "ffnn_max_width",
    "embrace_max", "post_max"))


@pytest.mark.parametrize("n_layers,widths,bucket", [
    (1, [128, 16, 4, 4], None),
    (2, [64, 32, 4, 4], 64),
    (3, [32, 64, 16, 4], None),
    (4, [32, 128, 64, 16], 128),
])
def test_ffnn_features_and_apply(rng, n_layers, widths, bucket):
    hp = hp_ffnn(n_layers, widths)
    params = j_ffnn_init(jax.random.PRNGKey(n_layers),
                         jffnn.fan_ins(hp, IN_FEATURES), IN_FEATURES)
    x = rng.normal(size=(7, IN_FEATURES)).astype(np.float32)
    tp = to_torch(params)
    h_j, m_j = j_ffnn_features(params, hp, x, max_width=bucket)
    h_t, m_t = tffnn.features(tp, hp, t(x), max_width=bucket)
    close(h_t, h_j, TOL)
    close(m_t, m_j, 0)
    close(tffnn.apply(tp, hp, t(x), max_width=bucket),
          j_ffnn_apply(params, hp, x, max_width=bucket), TOL)
    np.testing.assert_array_equal(tffnn.fan_ins(hp, IN_FEATURES),
                                  jffnn.fan_ins(hp, IN_FEATURES))


@pytest.mark.parametrize("n_layers,channels,kernels,bucketed", [
    (1, [16, 32, 64, 128], [5, 5, 5, 5], False),
    (2, [32, 96, 64, 128], [11, 15, 5, 5], True),
    (3, [16, 32, 96, 128], [15, 5, 11, 5], True),
    (4, [16, 32, 64, 128], [5, 11, 15, 5], False),
])
def test_cnn_features_and_apply(rng, n_layers, channels, kernels, bucketed):
    from embracenet_tpu.training.modelspec import _cnn_statics
    from embracenet_tpu_torch.training.modelspec import _cnn_statics as t_statics

    hp = hp_cnn(n_layers, channels, kernels)
    params, bn = j_cnn_init(jax.random.PRNGKey(n_layers), jcnn.fan_ins(hp))
    codes = rng.integers(0, 4, size=(3, 256)).astype(np.uint8)
    st = _cnn_statics([hp], key=None)
    assert t_statics([hp], key=None) == st
    kw = dict(max_depth=st["cnn_max_depth"],
              max_channels=st["cnn_max_channels"],
              max_kernels=st["cnn_max_kernels"]) if bucketed else {}
    tp, tbn = to_torch(params), to_torch(bn)
    x_j, x_t = j_one_hot(codes), one_hot(t(codes))
    f_j, m_j, _ = j_cnn_features(params, bn, hp, x_j, **kw)
    f_t, m_t, _ = tcnn.features(tp, tbn, hp, x_t, **kw)
    close(f_t, f_j, TOL)
    close(m_t, m_j, 0)
    l_j, s_j = j_cnn_apply(params, bn, hp, x_j, **kw)
    l_t, s_t = tcnn.apply(tp, tbn, hp, x_t, **kw)
    close(l_t, l_j, TOL)
    jax.tree.map(lambda a, b: close(b, a, TOL), s_j, s_t)
    np.testing.assert_array_equal(tcnn.fan_ins(hp), jcnn.fan_ins(hp))


def test_cnn_train_bn_state_with_row_mask(rng):
    """Train mode at dropout 0: the row-masked batch statistics and the
    new running state follow the JAX package."""
    hp = hp_cnn(2, [32, 64, 64, 128], [5, 11, 5, 5])
    params, bn = j_cnn_init(jax.random.PRNGKey(1), jcnn.fan_ins(hp))
    codes = rng.integers(0, 4, size=(5, 256)).astype(np.uint8)
    row_mask = np.asarray([1, 1, 1, 0, 0], np.float32)
    l_j, s_j = j_cnn_apply(params, bn, hp, j_one_hot(codes), train=True,
                           key=jax.random.PRNGKey(0), row_mask=row_mask)
    l_t, s_t = tcnn.apply(to_torch(params), to_torch(bn), hp,
                          one_hot(t(codes)), train=True,
                          generator=torch.Generator().manual_seed(0),
                          row_mask=t(row_mask))
    close(l_t, l_j, TOL)
    jax.tree.map(lambda a, b: close(b, a, TOL), s_j, s_t)


def _embracenet_case(rng, p_ffnn, n_post):
    flat = flat_embracenet(p_ffnn, n_post=n_post)
    hp = jspace.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = j_em_init(jax.random.PRNGKey(2),
                           jem.fan_ins(hp, IN_FEATURES), IN_FEATURES)
    b = 6
    inputs = {"ffnn": rng.normal(size=(b, IN_FEATURES)).astype(np.float32),
              "cnn": rng.integers(0, 4, size=(b, 256)).astype(np.uint8)}
    return hp, params, bn, inputs


@pytest.mark.parametrize("p_ffnn,n_post", [(0.3, 1), (0.7, 2), (0.5, 0)])
def test_embracenet_unfused_with_jax_uniforms(rng, p_ffnn, n_post):
    hp, params, bn, inputs = _embracenet_case(rng, p_ffnn, n_post)
    st = j_get_spec("EmbraceNetMultimodal", IN_FEATURES).statics([hp])
    assert t_get_spec("EmbraceNetMultimodal", IN_FEATURES).statics([hp]) == st
    key = jax.random.PRNGKey(9)
    l_j, s_j = j_em_apply(params, bn, hp, inputs["ffnn"],
                          j_one_hot(inputs["cnn"]), key=key, **st)
    # apply splits its key into (ffnn, cnn, coin, target, embrace, post)
    u = jax.random.uniform(jax.random.split(key, 6)[4], (len(inputs["ffnn"]), tem.E))
    kw = {k: v for k, v in st.items() if k.startswith("cnn_")}
    l_t, s_t = tem.apply(to_torch(params), to_torch(bn), hp, t(inputs["ffnn"]),
                         one_hot(t(inputs["cnn"])), u=t(u),
                         ffnn_max_width=st["ffnn_max_width"],
                         embrace_max=st["embrace_max"],
                         post_max=st["post_max"], **kw)
    close(l_t, l_j, TOL)
    jax.tree.map(lambda a, b: close(b, a, TOL), s_j, s_t)


@pytest.mark.parametrize("p_ffnn", [0.0, 1.0])
@pytest.mark.parametrize("fused", [False, True])
def test_embracenet_spec_apply_at_probability_extremes(rng, p_ffnn, fused):
    """Through the spec, as serving calls it: at p in {0, 1} the draw
    cannot matter, so the fused and unfused paths both equal JAX."""
    hp, params, bn, inputs = _embracenet_case(rng, p_ffnn, 1)
    st = j_get_spec("EmbraceNetMultimodal", IN_FEATURES).statics([hp])
    l_j, _ = j_em_apply(params, bn, hp, inputs["ffnn"],
                        j_one_hot(inputs["cnn"]), key=jax.random.PRNGKey(0),
                        **st)
    tspec = t_get_spec("EmbraceNetMultimodal", IN_FEATURES)
    l_t, _ = tspec.apply(to_torch(params), to_torch(bn), hp,
                         {k: t(v) for k, v in inputs.items()}, False, 0, None,
                         None, dict(st, fused_embrace=fused))
    close(l_t, l_j, TOL)


def test_embracenet_init_shapes_and_fans():
    flat = flat_embracenet(0.5, n_post=2)
    hp = jspace.params_to_hp("EmbraceNetMultimodal", flat)
    params_j, bn_j = j_em_init(jax.random.PRNGKey(0),
                               jem.fan_ins(hp, IN_FEATURES), IN_FEATURES)
    params_t, bn_t = tem.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    shapes = jax.tree.map(lambda a: tuple(np.shape(a)), (params_j, bn_j))
    assert jax.tree.map(lambda a: tuple(a.shape), (params_t, bn_t)) == shapes
    fans_j = jem.fan_ins(hp, IN_FEATURES)
    jax.tree.map(np.testing.assert_array_equal, tem.fan_ins(hp, IN_FEATURES),
                 fans_j)
    # torch-uniform fan semantics: every weight within 1/sqrt(fan_in)
    bound = 1 / np.sqrt(fans_j["dock"][1])
    w = params_t["dock1_w"]
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.99 * bound


@pytest.mark.parametrize("fused", [False, True])
def test_embracenet_training_draws_do_not_depend_on_the_population_depth(rng, fused):
    """A one-block CNN trial trains alike whether its population's deepest
    trial has 1 or 3 blocks: the blocks beyond its depth draw no dropout,
    so modality dropout, the embracement and the post layers draw the same
    numbers from the step's generator (what fold-fused CV relies on)."""
    flat = dict(flat_embracenet(0.5, cnn_layers=1), CNN_dropout_l0=0.2,
                CNN_dropout_l1=0.4, CNN_dropout_l2=0.4, EMBRACENET_dropout_l0=0.3)
    hp = jspace.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = tem.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    x = t(rng.normal(size=(9, IN_FEATURES)).astype(np.float32))
    codes = one_hot(t(rng.integers(0, 4, size=(9, 256)).astype(np.uint8)))
    out = [tem.apply(params, bn, hp, x, codes, train=True, seed=3,
                     cnn_max_depth=depth, fused=fused)[0] for depth in (1, 3)]
    close(out[1], out[0], 1e-6)
