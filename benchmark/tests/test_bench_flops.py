"""The frozen yardstick against hand counts and against the port's own
copies of what it froze."""

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.frozen import arch as A
from benchmark.frozen import flops as FL
from benchmark.frozen.data import make_data
from benchmark.frozen.philox import philox_uniform
from benchmark.frozen.plans import balanced_plan
from benchmark.frozen.seeds import seed_streams, step_seeds

F = 566


def _widest(model):
    """The widest model of the search space: every menu's maximum."""
    flat = dict(R.cell("embracenet-hepg2.train-pop8-f32")["config"]["widest"])
    if model == A.CONCATNET:
        flat = {k: v for k, v in flat.items() if not k.startswith(
            ("EMBRACENET", "n_post", "selection"))}
        flat.update(CONCATNET_n_post_layers=3, CONCATNET_n_units_l0=1024,
                    CONCATNET_n_units_l1=512, CONCATNET_n_units_l2=256)
    return A.arch(model, flat)


def test_widest_embracenet_forward_by_hand():
    ffnn = 2 * (566 * 256 + 256 * 128 + 128 * 64 + 64 * 32)
    cnn = 2 * (4 * 64 * 15 * 256 + 64 * 96 * 15 * 124 + 96 * 256 * 15 * 58
               + 256 * 512 * 15 * 25)
    dock = 2 * (32 + 512 * 8) * 1024
    post = 2 * (1024 * 512 + 512 * 256) + 2 * 256 * 2
    assert FL.fwd_flops(_widest(A.EMBRACENET), F) == ffnn + cnn + dock + post
    assert 170e6 < ffnn + cnn + dock + post < 180e6


def test_widest_concatnet_forward_by_hand():
    ffnn = 2 * (566 * 256 + 256 * 128 + 128 * 64 + 64 * 32)
    cnn = 2 * (4 * 64 * 15 * 256 + 64 * 96 * 15 * 124 + 96 * 256 * 15 * 58
               + 256 * 512 * 15 * 25)
    post = 2 * ((32 + 4096) * 1024 + 1024 * 512 + 512 * 256) + 2 * 256 * 2
    assert FL.fwd_flops(_widest(A.CONCATNET), F) == ffnn + cnn + post


def test_train_flops_are_three_forwards_and_one_a_validation_window():
    a = _widest(A.EMBRACENET)
    f = FL.fwd_flops(a, F)
    assert FL.train_flops(a, F, 7000, 3500, 2) == 2 * (3 * f * 7000 + f * 3500)


@pytest.mark.parametrize("args, ms, by", [
    ((1, 4096, 256, 7936, 1024, "float32"), 1.0257, "operations"),
    ((1, 4096, 256, 7936, 1024, "bfloat16"), 0.0695, "operations"),
    ((8, 100, 256, 7936, 1024, "bfloat16"), 0.0452, "bytes"),
    ((8, 100, 256, 7936, 1024, "float32"), 0.2003, "operations"),
])
def test_bound_at_the_shapes_perf_md_reports(args, ms, by):
    seconds, what = FL.bound(*args)
    assert seconds * 1e3 == pytest.approx(ms, rel=1e-3) and what == by


def test_bound_against_the_port_benchkit():
    from embracenet_tpu_torch.benchkit import bound

    for dt in (torch.float32, torch.bfloat16):
        ref = bound(333, 200, 3968, 768, dt)[0] / 1e3
        name = "float32" if dt == torch.float32 else "bfloat16"
        assert FL.bound(1, 333, 200, 3968, 768, name)[0] == pytest.approx(ref)


def test_lengths_and_buckets():
    assert A.CNN_LENGTHS == (124, 58, 25, 8) and A.FLAT_MAX == 7936
    a = _widest(A.EMBRACENET)
    assert A.buckets([a], False) == A.buckets([a], True) | {"D1": 7936}


def test_frozen_copies_equal_the_port():
    from embracenet_tpu_torch.benchkit import make_data as port_data
    from embracenet_tpu_torch.training.batching import balanced_plan as port_plan
    from embracenet_tpu_torch.training.engine import seed_streams as port_seeds

    a = make_data(500, 31, np.random.default_rng(4))
    b = port_data(500, 31, np.random.default_rng(4))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    idx, mask = balanced_plan(a["y"], 100)
    p = port_plan(a["y"], 100)
    assert np.array_equal(idx, p.idx) and np.array_equal(mask, p.mask)
    for s in (0, 789, 3000000101):
        assert all(np.array_equal(x, y) for x, y in
                   zip(seed_streams(s, 5), port_seeds(s, 5)))
    rng = np.random.default_rng(17)
    assert step_seeds(17, 3) == [int(rng.integers(0, 2 ** 31 - 1))
                                 for _ in range(3)]


def test_philox_known_answer():
    # Random123's known answer: key (0, 0), counter 0 -> word 0 0x6627e8d5
    assert philox_uniform(0, 1, 1)[0, 0] == np.float32(0x6627e8 / 2 ** 24)


@pytest.mark.card
def test_the_kernel_draws_the_frozen_philox(card):
    """The fused kernel keeps modality 0 exactly where the frozen draw is
    below p0 (the choose the reference works out)."""
    from embracenet_tpu_torch.ops.embrace import fused_embrace

    g = torch.Generator(card).manual_seed(0)
    B, D0, D1, E = 300, 64, 128, 256
    x0, x1 = (torch.rand(B, d, generator=g, device=card) for d in (D0, D1))
    w0, w1 = (torch.rand(d, E, generator=g, device=card) for d in (D0, D1))
    b = torch.zeros(E, device=card)
    p0 = torch.rand(B, generator=g, device=card)
    out, choose = fused_embrace(x0, x1, w0, b, w1, b, p0,
                                torch.ones(E, device=card), 12345)
    u = torch.from_numpy(philox_uniform(12345, B, E)).to(card)
    assert torch.equal(choose.bool(), u < p0[:, None])
