"""What the fused optimizer update's wrapper (``ops/optim.fused_update``)
builds on the host for ``csrc/optim_update.cu``: each leaf's start in the
output buffers, the chunks a launch walks, the new leaves as views of the
buffers; and that a CPU update never loads the kernel's library.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.models.layers import InitPlan
from embracenet_tpu_torch.ops import optim
from embracenet_tpu_torch.training.modelspec import get_spec
from embracenet_tpu_torch.convert import tree_leaves
from embracenet_tpu_torch.utils import profiling

# odd sizes, sizes around a chunk and an alignment unit, and an empty leaf
ODD = [1, 7, 255, 256, 257, 8191, 8192, 8193, 0, 20000, 3]


def _pop8_shapes():
    """The 34 leaf shapes of the supernet population's params (one
    trial), from the init's plan: nothing drawn."""
    flat = space.sample_params("EmbraceNetMultimodal",
                               np.random.default_rng(0))
    params, _ = get_spec("EmbraceNetMultimodal", 566).init(
        InitPlan(), space.params_to_hp("EmbraceNetMultimodal", flat))
    return [tuple(p.shape) for p in tree_leaves(params)]


@pytest.mark.parametrize("n_trials", [1, 3, 8])
@pytest.mark.parametrize("kind", ["pop8", "odd"])
def test_every_leaf_starts_on_a_16_byte_boundary(n_trials, kind):
    per_trial = ([int(np.prod(s)) for s in _pop8_shapes()] if kind == "pop8"
                 else ODD)
    sizes = [n * n_trials for n in per_trial]
    offsets, total = optim.leaf_offsets(sizes)
    assert len(offsets) == len(sizes)
    assert offsets[0] == 0 and np.all(offsets % optim.ALIGN == 0)
    for esize in (4, 2):   # float32 and bf16 buffers
        assert np.all(offsets * esize % 16 == 0)
    ends = offsets + np.asarray(sizes)
    assert np.all(ends[:-1] <= offsets[1:]), "two leaves overlap"
    assert ends[-1] <= total < ends[-1] + optim.ALIGN


@pytest.mark.parametrize("n_trials", [1, 2, 8])
@pytest.mark.parametrize("kind", ["pop8", "odd"])
def test_each_chunk_holds_one_trial_of_one_leaf(n_trials, kind):
    """Decoded as the kernel decodes it (the last leaf whose first chunk is
    at or before c, then trial and start by division), every chunk holds
    at most CHUNK elements of one trial of one leaf, and the chunks cover
    every element of every trial once."""
    per_trial = ([int(np.prod(s)) for s in _pop8_shapes()] if kind == "pop8"
                 else [n for n in ODD if n])
    first, n_chunks = optim.first_chunks(per_trial, n_trials)
    assert first[0] == 0 and np.all(np.diff(first) > 0)
    covered = [np.zeros((n_trials, n), np.int64) for n in per_trial]
    for c in range(n_chunks):
        leaf = int(np.searchsorted(first, c, side="right")) - 1
        n = per_trial[leaf]
        k = -(-n // optim.CHUNK)
        trial, j = divmod(c - int(first[leaf]), k)
        assert 0 <= trial < n_trials
        start = j * optim.CHUNK
        length = min(optim.CHUNK, n - start)
        assert 0 < length <= optim.CHUNK
        covered[leaf][trial, start:start + length] += 1
    assert all(np.all(cov == 1) for cov in covered)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_new_leaves_are_contiguous_views_of_one_buffer(dtype):
    like = [torch.empty(3, *s) for s in [(7, 5), (1,), (256,), (2, 0), (4,)]]
    offsets, total = optim.leaf_offsets([t.numel() for t in like])
    buf = torch.zeros(total, dtype=dtype)
    views = optim.leaf_views(buf, like)
    esize = buf.element_size()
    for v, t, o in zip(views, like, offsets):
        assert v.shape == t.shape and v.dtype == dtype and v.is_contiguous()
        assert (v.untyped_storage().data_ptr()
                == buf.untyped_storage().data_ptr())
        if t.numel():    # an empty view points nowhere
            assert v.data_ptr() - buf.data_ptr() == o * esize
            assert (v.data_ptr() - buf.data_ptr()) % 16 == 0
        v.fill_(1.0)
    assert int(buf.sum()) == sum(t.numel() for t in like)


def test_a_cpu_update_never_loads_the_library(monkeypatch):
    """On the CPU the plain version runs: the kernel is neither built nor
    loaded nor counted."""
    def refuse(*_a, **_kw):
        raise AssertionError("the CPU update reached the kernel's library")

    monkeypatch.setattr(optim.embrace, "build", refuse)
    monkeypatch.setattr(optim, "_load", refuse)
    monkeypatch.setattr(optim, "fused_update", refuse)
    params = {"a": torch.randn(2, 5, 3), "b": torch.randn(2, 4)}
    state = optim.init_state(params, lead=(2,))
    before = profiling.counters().get("optim.launches", 0)
    new_p, new_s = optim.apply_update(
        params, {"a": torch.randn(2, 5, 3), "b": None}, state,
        torch.tensor([0, 2]), torch.tensor([1e-3, 1e-2]),
        torch.tensor([0.0, 1e-4]))
    assert new_p["a"].shape == (2, 5, 3) and not torch.equal(new_p["a"],
                                                            params["a"])
    assert profiling.counters().get("optim.launches", 0) == before


def test_the_kernel_refuses_cpu_tensors():
    leaves = [torch.zeros(2, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        optim.fused_update(leaves, [None], leaves, leaves, None,
                           {k: torch.zeros(2) for k in optim.TRIAL_KEYS},
                           None)
