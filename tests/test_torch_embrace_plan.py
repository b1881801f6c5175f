"""The fused embrace kernel's launch plan and TMA layout rules, on the CPU.

The tiled kernel (``embracenet_tpu_torch/csrc/embrace.cu``) runs only on
the card; what the wrapper decides before it launches is plain Python and
is checked here: ``launch_plan`` (output tiles, the cluster's split of K),
``fulle_plan`` (the full-E kernel's clusters spanning E), the TMA
alignment rule ``tma_problem`` on both entries, and ``tma_x0``'s zero
padding of a bf16 x0 whose rows are 8 bytes.  The padded case must give the plain
version's output exactly: its inputs are small integers, so every sum is
exact in any order.
"""

import contextlib

import numpy as np
import pytest
import torch

from embracenet_tpu_torch.ops import embrace as K

SM = 132   # an H100 SXM
SHAPES = [(1, 4, 1024, 512), (63, 16, 3200, 768), (65, 64, 1000, 768),
          (100, 256, 7936, 1024), (200, 256, 7936, 1024),
          (4096, 256, 7936, 1024), (100, 200, 5568, 768), (1280, 256, 7936, 1024),
          (800, 256, 7936, 1024), (1024, 256, 7936, 1024),
          (2048, 256, 7936, 1024), (3, 8, 8, 8)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,D0,D1,E", SHAPES)
def test_plan_covers_every_tile_and_k_tile_once(B, D0, D1, E, dtype):
    plan = K.launch_plan(B, E, D0, D1, dtype, SM)
    assert plan.bm in (64, 128) and plan.bn == K.TILE_N
    # every rank of a cluster gets at least one of x1 @ w1's K tiles
    k1_tiles = -(-D1 // K.TILE_K[dtype])
    assert 1 <= plan.split <= K.MAX_SPLIT and plan.split <= k1_tiles
    # output tiles: the grid covers [0, B) x [0, E) and no tile lies wholly past it
    assert (plan.row_tiles - 1) * plan.bm < B <= plan.row_tiles * plan.bm
    assert (plan.col_tiles - 1) * plan.bn < E <= plan.col_tiles * plan.bn
    assert plan.ctas <= max(SM, plan.row_tiles * plan.col_tiles)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [100, 200])
def test_training_batches_fill_the_card(B, dtype):
    plan = K.launch_plan(B, 1024, 256, 7936, dtype, SM)
    assert plan.ctas >= 100 and plan.split > 1


# clusters of one float32 64-row tile an H100 80GB HBM3 holds at once, by
# split (the occupancy query on the card): its GPCs fit 15 clusters of 8
# but 17 of 6
H100_F32_CLUSTERS = {8: 15, 7: 15, 6: 17, 5: 22, 4: 30, 3: 39, 2: 66}


@pytest.mark.parametrize("B,split", [(100, 6), (200, 3), (65, 6), (1, 8)])
def test_plan_keeps_the_grid_in_one_wave(B, split):
    def fits(bm, s):
        assert bm == 64
        return H100_F32_CLUSTERS[s]

    plan = K.launch_plan(B, 1024, 256, 7936, torch.float32, SM, fits)
    assert plan.split == split
    assert plan.row_tiles * plan.col_tiles <= fits(plan.bm, plan.split)


@pytest.mark.parametrize("dtype", DTYPES)
def test_serving_batch_needs_no_split(dtype):
    plan = K.launch_plan(4096, 1024, 256, 7936, dtype, SM)
    assert plan.split == 1 and plan.bm == 128 and plan.ctas == 256


# engine_bench's train and eval batches (800, 2048) and a batch of 1024: too
# few 128-row tiles to fill the card, enough 64-row ones that no split is
# needed
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [800, 1024, 2048])
def test_bench_batches_take_unsplit_64_row_tiles(B, dtype):
    plan = K.launch_plan(B, 1024, 256, 7936, dtype, SM)
    assert plan.split == 1 and plan.bm == 64 and plan.ctas == -(-B // 64) * 8


def test_failed_occupancy_query_raises(monkeypatch):
    class Lib:
        @staticmethod
        def embrace_fused_fwd_clusters(*args):
            return -1                   # what the C entry returns on an error

    monkeypatch.setattr(K, "_load", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    K.clusters_at_once.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="occupancy query failed"):
            K.clusters_at_once(torch.bfloat16, 64, 8, 0)
    finally:
        K.clusters_at_once.cache_clear()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,D0,D1,E", SHAPES)
def test_fulle_plan_covers_every_tile_once(B, D0, D1, E, dtype):
    plan = K.fulle_plan(B, E, D0, D1, dtype, SM)
    assert plan.bm in (64, 128) and plan.bn == K.TILE_N
    assert (plan.row_tiles - 1) * plan.bm < B <= plan.row_tiles * plan.bm
    assert (plan.col_tiles - 1) * plan.bn < E <= plan.col_tiles * plan.bn
    # a cluster spans whole column tiles of one row tile
    assert 1 <= plan.cluster <= K.MAX_SPLIT and plan.col_tiles % plan.cluster == 0
    assert plan.clusters * plan.cluster == plan.row_tiles * plan.col_tiles
    # the tiled kernel's tile rows, so both run the same tiles
    assert plan.bm == K.launch_plan(B, E, D0, D1, dtype, SM).bm


def _h100_clusters(dtype, bm, c):
    """The stub occupancy table: a one-CTA-an-SM tile by
    :data:`H100_F32_CLUSTERS` (the query measured on the card), a bf16
    64-row tile twice as many (two CTAs an SM)."""
    one = {**H100_F32_CLUSTERS, 1: SM}
    return one[c] * (2 if dtype == torch.bfloat16 and bm == 64 else 1)


F32, BF16 = DTYPES


@pytest.mark.parametrize("B,dtype,waves,cluster", [
    (4096, F32, 2, 2), (4096, BF16, 2, 2),
    (2048, F32, 2, 2),        # 256 one-CTA-an-SM tiles: 2 waves at best
    (2048, BF16, 1, 2), (800, F32, 1, 8), (800, BF16, 1, 8),
    (100, F32, 1, 8), (100, BF16, 1, 8)])
def test_fulle_plan_takes_the_fewest_waves_then_the_widest_cluster(
        B, dtype, waves, cluster):
    """At B = 4096 a cluster of 8 (32 clusters, 15 at once) or 4 (64, 30
    at once) would take 3 waves where 2 (128, 66 at once) takes 2."""
    plan = K.fulle_plan(B, 1024, 256, 7936, dtype, SM,
                        lambda bm, c: _h100_clusters(dtype, bm, c))
    at_once = _h100_clusters(dtype, plan.bm, plan.cluster)
    assert plan.cluster == cluster
    assert -(-plan.clusters // at_once) == waves
    for c in (1, 2, 4, 8):   # no cluster width takes fewer waves
        assert -(-plan.ctas // c // _h100_clusters(dtype, plan.bm, c)) >= waves


def test_failed_fulle_occupancy_query_raises(monkeypatch):
    asked = []

    class Lib:
        @staticmethod
        def embrace_fused_fwd_clusters(*args):
            asked.append(args)
            return -1                   # what the C entry returns on an error

    monkeypatch.setattr(K, "_load", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    K.clusters_at_once.cache_clear()
    try:
        with pytest.raises(RuntimeError,
                           match="occupancy query failed for the full-E kernel"):
            K.clusters_at_once(torch.bfloat16, 128, 4, 0, fulle=True)
    finally:
        K.clusters_at_once.cache_clear()
    # the full-E kernel's query, on a grid of one cluster of 4 column tiles
    assert asked == [(1, 1, 128, 4 * K.TILE_N, 128, 4)]


@pytest.mark.parametrize("entry", ["embrace_fused_fwd", "embrace_fused_fwd_fulle"])
def test_both_entries_refuse_what_tma_cannot_read(entry, monkeypatch):
    def no_card(*args):
        raise AssertionError("the TMA check must come before the card's plan")

    monkeypatch.setattr(K, "card_plan", no_card)
    monkeypatch.setattr(K, "card_fulle_plan", no_card)
    x1 = torch.zeros(8, 40, dtype=torch.bfloat16)[:, 1:33]   # base 2 bytes off
    ok = torch.zeros(8, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA cannot read x1"):
        K._launch_args(entry, ok, x1, w, w)


@pytest.mark.parametrize("entry,plan", [
    ("embrace_fused_fwd", K.LaunchPlan(64, K.TILE_N, 8, 1, 1)),
    ("embrace_fused_fwd_fulle", K.FullEPlan(64, K.TILE_N, 1, 1, 1))])
def test_both_entries_pad_a_narrow_bf16_x0_and_pass_their_plan(entry, plan,
                                                              monkeypatch):
    monkeypatch.setattr(K, "card_plan", lambda *a: plan)
    monkeypatch.setattr(K, "card_fulle_plan", lambda *a: plan)
    x0 = torch.ones(8, 4, dtype=torch.bfloat16)
    x1 = torch.zeros(8, 32, dtype=torch.bfloat16)
    w0, w1 = torch.zeros(4, 16, dtype=torch.bfloat16), torch.zeros(32, 16, dtype=torch.bfloat16)
    x0_tma, args = K._launch_args(entry, x0, x1, w0, w1)
    assert x0_tma.shape == (8, 8) and torch.equal(x0_tma[:, :4], x0)
    assert args == (plan.bm, plan[2])


@pytest.mark.parametrize("shape,strides,item,address,ok", [
    ((100, 7936), (7936, 1), 2, 0, True),
    ((256, 1024), (1280, 1), 4, 4096, True),        # a row-strided weight view
    ((100, 4), (4, 1), 2, 0, False),                # 8-byte rows: x0 of width 4, bf16
    ((100, 4), (4, 1), 4, 0, True),                 # 16-byte rows in float32
    ((1, 4), (4, 1), 2, 0, True),                   # one row: its stride is never used
    ((100, 1000), (1000, 1), 2, 0, True),           # ragged K, 2,000-byte rows
    ((100, 1000), (1001, 1), 4, 0, False),
    ((100, 64), (64, 1), 2, 8, False),              # base not 16-byte aligned
    ((100, 64), (1, 100), 4, 0, False),             # transposed
    ((100, 64), (32, 1), 4, 0, False),              # rows overlap
])
def test_tma_rule(shape, strides, item, address, ok):
    assert (K.tma_problem(shape, strides, item, address) is None) == ok


def test_wrapper_refuses_what_tma_cannot_read():
    x1 = torch.zeros(8, 40, dtype=torch.bfloat16)[:, 1:33]   # base 2 bytes off
    ok = torch.zeros(8, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA cannot read x1"):
        K._check_tma(ok, x1, w, w)
    K._check_tma(ok, ok, w, w)


def test_x0_padding_for_tma_changes_no_output():
    rng = np.random.default_rng(0)
    B, D0, D1, E = 12, 4, 16, 24

    def ints(*shape):
        return torch.as_tensor(rng.integers(-3, 4, size=shape).astype(np.float32))

    x0, x1, w0, w1 = ints(B, D0), ints(B, D1), ints(D0, E), ints(D1, E)
    b0, b1 = ints(E), ints(E)
    p0 = torch.full((B,), 0.5)
    e_mask = torch.ones(E)
    u = torch.as_tensor(rng.random((B, E)).astype(np.float32))
    padded = K.tma_x0(x0.bfloat16())
    assert padded.shape == (B, 8) and padded.stride(0) * 2 % 16 == 0
    assert torch.equal(padded[:, :D0].float(), x0)
    assert float(padded[:, D0:].abs().sum()) == 0.0
    assert K.tma_x0(x0) is x0                      # float32 rows of 16 bytes
    w0_padded = torch.cat([w0, torch.zeros(8 - D0, E)])
    want, want_ch = K.fused_embrace_reference(x0, x1, w0, b0, w1, b1, p0, e_mask, u)
    got, got_ch = K.fused_embrace_reference(padded.float(), x1, w0_padded, b0, w1,
                                            b1, p0, e_mask, u)
    assert float((got - want).abs().max()) == 0.0
    assert torch.equal(got_ch, want_ch)
