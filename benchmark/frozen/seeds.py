"""The seeds a population fit derives, a copy of the port's
``engine.seed_streams`` and of how ``engine.fit`` and ``hpo/search.py``
use them: group g of a search fits with ``seed + 7919 g``; trial t of a fit
inits from a CPU ``torch.Generator`` seeded with ``init[t]`` and draws
step k's randomness from a generator on the fit's device seeded with the
k-th ``integers(0, 2**31 - 1)`` of ``numpy.random.default_rng(run[t])``."""

from __future__ import annotations

import numpy as np


def group_seed(seed: int, g: int) -> int:
    return seed if g == 0 else seed + 7919 * g


def seed_streams(seed: int, n_trials: int):
    """-> ``(init_seeds [T], run_seeds [T])`` as uint32 arrays."""
    children = np.random.SeedSequence(int(seed)).spawn(n_trials + 1)
    init = [c.generate_state(1)[0] for c in children[1:]]
    run = [c.generate_state(1)[0] for c in children[0].spawn(n_trials)]
    return np.asarray(init, np.uint32), np.asarray(run, np.uint32)


def step_seeds(run_seed: int, n_steps: int) -> list:
    """The seeds of a trial's first ``n_steps`` step generators."""
    rng = np.random.default_rng(int(run_seed))
    return [int(rng.integers(0, 2 ** 31 - 1)) for _ in range(n_steps)]
