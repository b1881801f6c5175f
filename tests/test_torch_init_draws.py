"""The generator contract that drawing a population's init on the card
rests on (``ops/mt19937.py``, ``csrc/mt19937.cu``), held on the CPU:

  * ``torch.rand`` on a CPU generator seeded with s is MT19937 seeded with
    ``init_genrand(s & 0xffffffff)`` (numpy's ``MT19937._legacy_seeding``),
    each word's low 24 bits times 2^-24, one stream across consecutive
    calls;
  * the kernel's twist (three phases, thread i computing words i, i + 227
    and i + 454, written out below in numpy) gives that stream;
  * ``torch_uniform_init`` is ``(u * 2 - 1) * bound`` in float32, the bound
    rounded to float32;
  * each family's recorded draw plan (``layers.InitPlan``) draws its leaves
    in the order, at the shapes and with the bounds its host init draws
    them, and ``engine.init_population`` stacks them as the host init does.

CPU only, no JAX; the kernel itself is held to the host draws by
``tests/test_torch_cuda.py`` on the card.
"""

import numpy as np
import pytest
import torch

from embracenet_tpu_torch.convert import tree_leaves
from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.models.layers import InitPlan, torch_uniform_init
from embracenet_tpu_torch.ops import mt19937
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.modelspec import MODEL_FAMILIES, get_spec
from embracenet_tpu_torch.utils import profiling

N, M = 624, 397
LANES, LAST = N - M, N - 2 * (N - M)      # 227, 170
SEEDS = [0, 1, 123, 2**31 - 1, 987654321, 2**32 + 5, 2**40 + 2**31 + 3]
#: consecutive leaves that end inside, at and across 624-word blocks
LENGTHS = [1, 622, 1, 624, 625, 1247, 2, 5000]


def _numpy_words(seed, n):
    bitgen = np.random.MT19937(0)
    bitgen._legacy_seeding(seed & 0xFFFFFFFF)
    return bitgen.random_raw(n).astype(np.uint32)


def _uniforms(words):
    return (words & 0xFFFFFF).astype(np.float32) * np.float32(2.0 ** -24)


def _values(words, bound):
    """``torch_uniform_init``'s float32 arithmetic, one rounding a step."""
    x = _uniforms(words) * np.float32(2.0) - np.float32(1.0)
    return x * np.float32(bound)


def _seeded(seed):
    """The kernel's seeding, ``init_genrand(seed & 0xffffffff)``."""
    s = [seed & 0xFFFFFFFF]
    for j in range(1, N):
        s.append((1812433253 * (s[-1] ^ (s[-1] >> 30)) + j) & 0xFFFFFFFF)
    return np.asarray(s, np.uint32)


def _twist(u, v):
    return (((u & np.uint32(0x80000000)) | (v & np.uint32(0x7FFFFFFF)))
            >> np.uint32(1)) ^ np.where(v & np.uint32(1),
                                        np.uint32(0x9908B0DF), np.uint32(0))


def _temper(y):
    y = y ^ (y >> np.uint32(11))
    y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
    y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
    return y ^ (y >> np.uint32(18))


def _twist_as_the_kernel(old):
    """One twist as ``mt19937_uniform_init_kernel`` takes it: lane i of
    phase 1 from the old state alone, of phases 2 and 3 from its own word
    of the phase before; word 623 from new[0], computed again."""
    i = np.arange(LANES)
    n0 = old[i + M] ^ _twist(old[i], old[i + 1])
    n1 = n0 ^ _twist(old[i + LANES], old[i + LANES + 1])
    j = np.arange(LAST - 1)
    n2 = n1[j] ^ _twist(old[j + 2 * LANES], old[j + 2 * LANES + 1])
    first = old[M:M + 1] ^ _twist(old[0:1], old[1:2])
    last = n1[LAST - 1:LAST] ^ _twist(old[N - 1:N], first)
    return np.concatenate([n0, n1, n2, last])


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_rand_is_the_mt19937_stream_masked_to_24_bits(seed):
    gen = torch.Generator().manual_seed(seed)
    got = np.concatenate([torch.rand(n, generator=gen).numpy()
                          for n in LENGTHS])
    want = _uniforms(_numpy_words(seed, sum(LENGTHS)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 2**31 - 1, 2**32 + 5])
def test_the_kernels_twist_gives_the_generators_words(seed):
    state, words = _seeded(seed), []
    for _ in range(3):
        state = _twist_as_the_kernel(state)
        words.append(_temper(state))
    np.testing.assert_array_equal(np.concatenate(words),
                                  _numpy_words(seed, 3 * N))


@pytest.mark.parametrize("fan_in", [0, 1, 3.0, np.float32(566), 60, 7936,
                                    np.float32(126976)])
def test_torch_uniform_init_is_the_float32_affine_of_the_stream(fan_in):
    seed = 2**32 + 77
    got = torch_uniform_init(torch.Generator().manual_seed(seed), (31, 43),
                             fan_in)
    plan = InitPlan()
    leaf = torch_uniform_init(plan, (31, 43), fan_in)
    assert plan.shapes == [(31, 43)] and plan.leaves == [leaf]
    assert leaf.device.type == "meta" and leaf.shape == (31, 43)
    want = _values(_numpy_words(seed, 31 * 43), plan.bounds[0])
    np.testing.assert_array_equal(got.numpy(), want.reshape(31, 43))


def _population(model, n_trials):
    """Trials of ``model`` as a search samples them (CNN_LSTM: one
    architecture, since a population of it shares one)."""
    return [space.params_to_hp(model, space.sample_params(
        model, np.random.default_rng(0 if model == "CNN_LSTM" else i)))
        for i in range(n_trials)]


@pytest.mark.parametrize("model", MODEL_FAMILIES)
def test_the_recorded_plan_draws_every_family_as_its_host_init(model):
    spec = get_spec(model, 16)
    hps = _population(model, 2)
    seeds = [2**32 + 11, 987654321]
    host = engine.host_init(spec, hps, seeds)
    # the plan: the host init's drawn leaves, in draw order, from one stream
    plan = InitPlan()
    tree = spec.init(plan, hps[1])
    drawn = {id(leaf): k for k, leaf in enumerate(plan.leaves)}
    leaves, host_leaves = tree_leaves(tree), tree_leaves(
        (host[0], host[1]))
    assert sorted(drawn.get(id(a), -1) for a in leaves if a.is_meta) == list(
        range(len(plan.leaves)))
    words = _numpy_words(seeds[1], sum(int(np.prod(s)) for s in plan.shapes))
    start = 0
    for k, (shape, bound) in enumerate(zip(plan.shapes, plan.bounds)):
        n = int(np.prod(shape))
        want = _values(words[start:start + n], bound).reshape(shape)
        start += n
        got = host_leaves[[id(a) for a in leaves].index(id(plan.leaves[k]))]
        np.testing.assert_array_equal(got[1].numpy(), want)
    # every leaf the init does not draw is a constant, not a placeholder
    assert all(not a.is_meta for a in leaves if id(a) not in drawn)
    # and the population, stacked through the plan, is the host's
    for got, want in zip(tree_leaves(engine.init_population(
            spec, hps, seeds, "cpu")), host_leaves):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("n_trials", [1, 3])
def test_one_trial_and_a_padded_population_draw_as_the_host(n_trials):
    """T = 1, and a population padded as a mesh pads it (copies of its
    last trial, seed and all)."""
    spec = get_spec("EmbraceNetMultimodal", 16)
    hps = _population("EmbraceNetMultimodal", n_trials)
    seeds = list(range(5, 5 + n_trials))
    (hps, seeds), _ = engine._pad_population(2, (hps, seeds), ())
    got = engine.init_population(spec, hps, seeds, "cpu")
    want = engine.host_init(spec, hps, seeds)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))


def test_init_population_counts_its_draws_and_copies_only_constants():
    spec = get_spec("CNN", 16)
    hps = _population("CNN", 2)
    profiling.reset_counters()
    params, bn_state = engine.init_population(spec, hps, [3, 4], "cpu")
    plan = InitPlan()
    spec.init(plan, hps[0])
    c = profiling.counters()
    assert c["engine.init_device_draws"] == 2 * sum(int(np.prod(s))
                                                    for s in plan.shapes)
    constants = [params[k] for k in params if k.startswith("bn")]
    assert c["engine.to_device_bytes"] == sum(
        a.nbytes for a in tree_leaves((constants, bn_state)))
    profiling.reset_counters()


@pytest.mark.parametrize("width_buckets", [False, True])
def test_a_cpu_fit_without_trees_starts_from_the_host_init(width_buckets,
                                                           monkeypatch):
    """``engine.fit`` on the CPU draws its population as on the card
    (``init_population``): the params its first step takes are
    ``host_init``'s bit for bit (cut to the width buckets where the fit
    cuts them), and ``engine.init_device_draws`` counts every drawn
    number."""
    from embracenet_tpu_torch.config import TrainConfig
    from embracenet_tpu_torch.convert import tree_map
    from embracenet_tpu_torch.training import slicing

    spec = get_spec("EmbraceNetMultimodal", 16)
    flats = [space.sample_params("EmbraceNetMultimodal",
                                 np.random.default_rng(i)) for i in range(2)]
    hps = [space.params_to_hp("EmbraceNetMultimodal", f) for f in flats]
    opts = [space.optimizer_hp(f) for f in flats]
    rng = np.random.default_rng(1)
    data = {"ffnn": rng.normal(size=(60, 16)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(60, 256), dtype=np.uint8),
            "y": (rng.random(60) < 0.3).astype(np.int64)}
    first = []
    step = engine.population_step

    def spy(spec_, params, *args, **kw):
        if not first:
            first.append(tree_map(lambda a: a.detach().clone(), params))
        return step(spec_, params, *args, **kw)

    monkeypatch.setattr(engine, "population_step", spy)
    cfg = TrainConfig(num_epochs=1, batch_size=40, seed=2**31 + 7,
                      width_buckets=width_buckets)
    profiling.reset_counters()
    engine.fit(spec, hps, opts, data, data, cfg, device="cpu")
    c = profiling.counters()
    profiling.reset_counters()
    seeds, _ = engine.seed_streams(cfg.seed, 2)
    params, bn_state = engine.host_init(spec, hps, seeds)
    statics = engine._resolve_statics(spec, hps, cfg)
    if width_buckets:
        params, bn_state = slicing.shrink(spec.name, params, bn_state,
                                          statics)
    got, want = tree_leaves(first[0]), tree_leaves(params)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plan = InitPlan()
    spec.init(plan, hps[0])
    assert c["engine.init_device_draws"] == 2 * sum(int(np.prod(s))
                                                    for s in plan.shapes)
    assert "mt19937.launches" not in c


def test_trials_of_different_shapes_are_refused():
    spec = get_spec("CNN_LSTM")
    hps = [space.params_to_hp("CNN_LSTM", space.sample_params(
        "CNN_LSTM", np.random.default_rng(i))) for i in (0, 1)]
    with pytest.raises(ValueError, match="different"):
        engine.init_population(spec, hps, [1, 2], "cpu")


def test_uniform_init_takes_only_the_cpu_and_the_card():
    with pytest.raises(ValueError, match="unsupported device"):
        mt19937.uniform_init([(2, 3)], [[0.5]], [1], "meta")
