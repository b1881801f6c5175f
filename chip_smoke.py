"""Chip smoke test of the PyTorch/CUDA port (``embracenet_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result,
without them.  It

1. builds the fused embrace kernel (``embracenet_tpu_torch/csrc/embrace.cu``),
   the MT19937 init kernel (``csrc/mt19937.cu``) and the fused optimizer
   update (``csrc/optim_update.cu``) with nvcc for sm_90a
   and prints each one's build time and its own ptxas report;
2. kernel phase: holds the kernel against its plain PyTorch version at the
   serving path's shape (B=4096, D0=256, D1=7936, E=1024), at a ragged
   shape (B=100, D0=200, D1=5568, E=768 with e_mask live on 512), at the
   train phase's shapes (B=100 and, for evaluation, B=200, with D0=256,
   D1=7936, E=1024), at the bench phase's (B=800 and 2048, which
   ``engine_bench`` drives, and 1024, on unsplit 64-row tiles) and at
   three edge shapes (B=1, D0=4, D1=1024, E=512:
   x0 padded for TMA in bf16; B=63, D0=16, D1=3200, E=768; B=65, D0=64,
   D1=1000, E=768: ragged K; B straddles the 64-row tile), in float32 and
   bf16 operands: p0 = 1 and p0 = 0 give the plain version's d0 / d1, a
   per-row p0 spread over [0, 1] gives exactly ``where(choose, d0, d1)``
   (tolerance: float32 rtol = atol = 1e-4, the K-sum taken in another
   order; bf16 1e-2 against the plain version on the same bf16 operands),
   the full-E kernel chooses exactly as the tiled one, each row's choose
   frequency lies within 0.01 of its p0, masked columns are exactly 0, and
   a seed repeats bit for bit while the next seed differs.  It prints the
   launch plan (tile, cluster split, CTAs, clusters the card holds at
   once) and times, with CUDA events, the kernel and the plain version
   (``ms``, ``plain_ms``: through the Python wrapper, eagerly, as a
   training step calls them; ``device_ms``, ``plain_device_ms``: device
   time of 20 calls replayed from a CUDA graph, without the host's time)
   and ``products_ms``, the device time of the two docking products alone
   through ``torch.matmul`` in the operand type (a yardstick the port
   never calls).  No single PyTorch call computes this
   function, so there is no library time: ``library_ms`` is null.  Then
   both kernels at ``row_base = r`` on rows [r, r + b) of the train and
   eval batches (B = 100, 200: both halves and a 37-row tail) choose as
   the whole launch does for those rows, bit for bit, with ``out`` within
   the tolerance, and ``row_base = 0`` is the launch without it, bit for
   bit.  Then the trial axis (``trial_case``): T = 2 and 8 trials at
   B = 100 and 200 in both operand types, each trial with its own weights,
   p0, live width and seed, in one launch of each kernel: every trial's
   ``choose`` and ``out`` equal its single launch's bit for bit, ``out``
   the plain version's within the tolerance, the full-E kernel chooses as
   the tiled one; at T = 8, B = 100 it times the launch, the 8 single
   launches, the plain version and the batched ``torch.matmul`` products
   against 8 times one trial's bound;
3. serve phase: builds the widest EmbraceNetMultimodal of the search space
   (FFNN 256/128/64/32, CNN 64/96/256/512 with 15-tap kernels, embracement
   1024, post layers 512/256, 566 tabular features as HEPG2) from a seeded
   generator, saves it as a checkpoint, and answers 3 ``predict`` requests
   of 10,000 windows on the card through ``load_model``; the kernel must
   have been launched 3 * ceil(10000 / 4096) = 9 times.  Then the
   checkpoint's second backend (``checkpoint_case``): the same trees, moved
   to the card, saved with ``save_checkpoint_orbax`` from the CUDA tensors
   and loaded back (every leaf and the meta as saved), a ``ReloadedModel``
   of the loaded trees answers one more request of 10,000 windows with
   ceil(10000 / 4096) = 3 counted launches, its probabilities equal bit for
   bit those of ``load_model`` on the npz checkpoint of the same trees; it
   prints both backends' save and load walls and bytes on disk.  Then it
   checks ``evaluate``, the fused path against the unfused one at
   selection_probabilities_FFNN in {0, 1}, and the card against the port on
   the CPU on 64 windows;
4. kernel-fulle phase: holds the full-E kernel (``fused_embrace_fulle``)
   to the same checks at the same ten shapes in both operand types, and
   requires its ``choose`` to equal ``fused_embrace``'s bit for bit for the
   same seed and its ``out`` to equal it bit for bit where both plans give
   the same tile rows and the tiled one splits no K (the same tiles in the
   same K order), within 1e-4 (float32) / 1e-2 (bf16) elsewhere.  It
   prints the full-E plan (tile, cluster width, CTAs, clusters the card
   holds at once) and times it as the kernel phase does (``ms``,
   ``device_ms``, ``plain_ms``, ``products_ms``), with the tiled kernel's
   device time on the same inputs beside it;
5. gradient phase: at the serving shape and at the training batch (B=100)
   in float32, the fused Function's dx0, dx1, dw0, db0, dw1, db1 equal
   autograd through the unfused path at p0 = 1 and p0 = 0 within
   1e-4 x max|grad|; times forward + backward of both;
5b. init-draws phase: ``tools/torch_init_draws_bench.py``'s cases for
   the pop8 population (8 trials, one launch) and CNN_LSTM's longest
   stream (trial 1, ~127.1 M words): the MT19937 kernel's leaves equal the
   CPU generators' bit for bit; its device ms and words/s a stream beside
   the host draw's seconds.  From the serve phase to the mesh phase every
   ``engine.fit`` is watched (:class:`InitDraws`, and each mesh rank's
   counters): one on the card without ``init_params`` launches the kernel
   once, any other fit never, and the kernel's row in the ``kernels`` line
   counts those launches;
5c. update phase: ``tools/torch_optim_bench.py``'s cases at the pop8
   population (8 trials, 34 leaves, 95.66 M numbers) in float32, with bf16
   m and v, and with bf16 params over a float32 master: three chained
   steps of the fused optimizer update (``csrc/optim_update.cu``) equal
   the plain version bit for bit, leave their inputs as they were and
   launch once a call; its device ms beside its bound (the bytes it must
   move at 3.35 TB/s) and the plain version's ms.  Every watched fit on
   the card launches it once a train step (``optim.launches`` against
   ``engine.train_steps``, each mesh rank's too), a fit on the CPU never;
6. train phase: ``engine.fit`` on the card for the widest
   EmbraceNetMultimodal (566 features, Adam lr 1e-3, batch 100, float32,
   fused kernel on) over learnable synthetic data from seed 0 (3,000 train
   and 1,000 test windows, as ``bench.py``'s ``make_data``), 3 epochs in one
   chunk: finite losses and AUPRCs, 3 epochs run, parameters that moved,
   and exactly one kernel launch per forward pass the plans call for.  Then
   a population of 8 trials drawn as ``bench.py`` draws them (seeds 0-7),
   split by ``plan_buckets``, bf16, 1 epoch: each group one population
   program, one launch per population forward pass (not per trial), its
   launches per train step and train windows/s;
7. bench phase: ``tools/torch_embrace_bench.py``'s ``block_bench`` at
   B=4096 (few iterations) and ``engine_bench(True)``, the entry point that
   reaches the full-E kernel; then its ``train_profile`` of the train
   phase's 8-trial population under ``torch.profiler``: CUDA kernels a
   train step, the card's busy share and train windows/s;
8. CV phase: ``embracenet_tpu_torch.train`` of EmbraceNetMultimodal on
   4,000 learnable windows at 566 features and 5 % positives (about 20:1,
   so SMOTE and reverse-strand rebalancing run in every fold): 3 folds x 3
   TPE trials over the full search space, 2 epochs, batch 100, float32,
   fused kernel on, studies and checkpoints in a temporary directory under
   ``embracenet_tpu_torch/_build/``.  The sequential run must leave 3
   finished rows in each fold's study, every trial's, fold's and the
   fold-best checkpoint, ``average_CV_AUPRC`` = round(mean of the fold
   scores, 5), finite scores, the results JSON entry and its baseline, and
   in every fold's search and every retrain one kernel launch per
   population forward pass (``FitLog``, as in the data, sweep and CLI
   phases: epochs run x (train + eval batches), whatever the trials).  The
   fold-fused run (``CVConfig(fuse_folds=True)``, fresh storage) must
   sample the same params per study and trial number and train each trial
   as the sequential run did: every trial's train-loss history and every
   array of every checkpoint within 1e-6 of the sequential run's (the
   test-AUPRC histories within 0.05, a second check; the sequential fits
   run the fused stack's batch rows, ``plan_rows``), with fewer launches
   than the sequential run (a fused search or retrain is one population
   program); repeating the
   sequential call resumes every fold with no launch and the same scores;
   ``predict`` on the fold-best checkpoint launches the kernel and gives
   rows that sum to 1.  It prints each run's wall, train windows/s and
   launches;
9. models phase, for ConcatNetMultimodal and CNN_LSTM: the widest trial
   of the search space from seed 0 (ConcatNet: the FFNN and CNN branches
   of the serve phase's model, 3 post layers of 1024 / 512 / 256; CNN_LSTM:
   one conv block of 64 channels with 15 taps, an LSTM of 2 layers of
   hidden size 128, so 1,984 timesteps and a 253,952 x 1000 first FC
   layer) at 566 features, saved as a checkpoint: its eval forward through
   ``load_model`` on 512 windows on the card equals the CPU's within
   1e-4 x max|logit| (float32 products and cuDNN convolutions and LSTM
   with TF32 off, summed in another order), ``evaluate`` gives finite
   metrics; one ``engine.fit`` of it (float32, batch 100, 1 epoch on
   ``make_data``'s 3,000 train and 1,000 test windows): finite history,
   parameters that moved, and its train windows/s; then
   ``embracenet_tpu_torch.train`` with 2 folds x 2 TPE trials x 1 epoch
   on 2,000 windows, finite scores, and ``predict`` of the fold-best
   checkpoint on 512 windows, card against ``device="cpu"`` within 1e-4.
   These families have no kernel of their own;
10. data phase: writes a raw data tree under ``_build/``
    (``benchkit.write_raw_dataset``: enhancers and promoters of 5,000
    regions each, HEPG2 with 566 feature columns and K562 with 52, some
    cells missing, sequences with upper-case bases and ``n``), requires the
    native runtime (``runtime.available()``), runs ``preprocess`` twice
    (the second from its cache, equal arrays), then
    ``train("EmbraceNetMultimodal", "HEPG2", task, pipeline=...)`` with 2
    folds x 2 TPE trials x 1 epoch: finite scores and kernel launches in
    every fit; ``predict`` on the fold-best checkpoint.  It prints the
    ``Pipeline`` wall by stage (load, scale, impute, select, cache) and
    the CV wall;
11. sweep phase: ``sweep.run_sweep`` on the card over ``make_data``'s
    4,000 windows at 566 features and 5 % positives from seed 0 (HEPG2,
    ``active_E_vs_inactive_E``, the five default models, 2 folds x 2 TPE
    trials x 1 epoch, batch 100).  At 5 % positives the FFNN
    smote-vs-double contest runs: the results must hold ``FFNN_smote``,
    ``FFNN_double``, ``FFNN`` (a copy of the winner), ``CNN``,
    ``ConcatNetMultimodal``, ``EmbraceNetMultimodal`` and
    ``EmbraceNetMultimodal_augmentation`` with finite scores,
    ``best_augmentation == "double"`` and the baseline, the results JSON
    must reload equal, the canonical FFNN checkpoint copies must exist, and
    the kernel must launch in every fit of both EmbraceNet variants and in
    no other.  It prints each variant's wall and train windows/s;
12. report phase, over the sweep's output: ``get_average_auprc_df`` and
    ``get_standard_dev_df`` equal the results' numbers,
    ``compare_model_overall_performance`` gives finite p-values, and
    ``CompareModelsResult(n_folds=1)`` over the four default families'
    fold-best checkpoints runs on the card inside
    ``profiling.device_trace`` and ``annotate("compare_models")``: p-values
    in [0, 1], a bool ``different``, a kernel launch, a trace that names
    ``embrace_fused_fwd_kernel`` and ``compare_models``; the same
    comparison again without the trace (the profiler's cost); FFNN, CNN
    and ConcatNet predict on 512 windows as on the CPU within 1e-4; and
    ``save_pval_dict`` round-trips with the reference's nesting;
13. CLI phase, in the data phase's raw tree and cache: ``main(argv)`` of
    ``python -m embracenet_tpu_torch`` in-process for ``preprocess`` (from
    the cache, equal to the data phase's ``Pipeline``), ``train`` of
    EmbraceNet (2 folds x 2 trials x 1 epoch, kernel launches),
    ``evaluate`` on its fold-best checkpoint, ``sweep`` of FFNN and CNN and
    ``parity`` against ``BASELINE.md`` (HEPG2's rows for the task); then
    ``python -m embracenet_tpu_torch preprocess`` and
    ``examples/torch_quickstart.py --epochs 1`` (in a temporary directory)
    as subprocesses that must exit with 0;
14. mesh phase (multi-device training, ``parallel/mesh.py``): two trials
    of the widest EmbraceNetMultimodal (dropout 0.1, p = 0.5) on 2,000 of
    ``make_data``'s windows, 1 epoch, meshless, on a 1 x 1 mesh through
    ``init_distributed`` with NCCL (bit for bit), and in two processes on
    the card under gloo (``chip_smoke.py --mesh-worker DIR``, killed after
    240 s): a 2 x 1 trial mesh (bit for bit) and a 1 x 2 data mesh (its
    first step against the whole batch's, its epoch beside a 1-ulp change
    of the init); launches (one per population forward pass: 19 in every
    fit, meshless or each rank's) and ``row_base`` per rank, aggregate
    train windows/s, the data mesh's ms per step, all-reduces a step and
    their share (see :func:`mesh_phase`); after the trial mesh's fit both
    ranks save its population trees with ``save_checkpoint_orbax(...,
    mesh=mesh)`` into one directory, which must hold ``.metadata`` and one
    part per rank, and each rank's ``load_checkpoint_orbax`` must equal the
    meshless fit's npz checkpoint bit for bit;
15. path-shape phase: while the serve, train, CV, data, sweep, report,
    CLI and mesh phases run (and in each mesh worker),
    ``ShapeLog`` stands in for ``fused_embrace`` and keeps the inputs and
    output of the first call at each distinct layout the paths give the
    kernel, trial axis included (balanced train batches of 93-97 rows,
    eval batches, the bf16 population's width buckets, the selected HEPG2
    features, populations of 1 to 9 trials; a trial without width buckets
    docks at the search space's widest D0, D1 and E).  After them the kernel is replayed at each: the same output bit
    for bit, and the plain version's ``where(choose, d0, d1)``, d0 at
    p0 = 1 and d1 at p0 = 0 within the kernel phase's tolerance; each pair
    of the data mesh's shards (48 + 48 rows of a 95-row train batch padded
    to 96, 100 + 100 eval rows) is launched again on its rows together:
    the same ``choose`` bit for bit;
16. prints the card's name and power limit, the ``{"kernels": [...]}`` line
    and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero without the last line.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

import embracenet_tpu_torch as et
from embracenet_tpu_torch import api
from embracenet_tpu_torch.benchkit import (IN_FEATURES, bound, cuda_ms,
                                           graph_ms, make_data, nvidia_smi,
                                           widest_concat_flat_params,
                                           widest_flat_params,
                                           widest_lstm_flat_params,
                                           write_raw_dataset)
from embracenet_tpu_torch.config import CVConfig, TrainConfig
from embracenet_tpu_torch.convert import (tree_leaves, tree_map, tree_to_numpy,
                                          tree_to_torch)
from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.hpo.study import Study
from embracenet_tpu_torch.models import embracenet
from embracenet_tpu_torch.models.layers import _highest_matmul_precision
from embracenet_tpu_torch.models.reload import ReloadedModel, load_model
from embracenet_tpu_torch.ops import embrace as K
from embracenet_tpu_torch.ops import mt19937, optim
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.batching import balanced_plan, eval_plan
from embracenet_tpu_torch.training.bucketing import plan_buckets
from embracenet_tpu_torch.parallel.mesh import (free_port, init_distributed,
                                                launch_local, make_mesh)
from embracenet_tpu_torch.training.checkpoint import (load_checkpoint,
                                                      load_checkpoint_orbax,
                                                      save_checkpoint,
                                                      save_checkpoint_orbax)
from embracenet_tpu_torch.training.cv import checkpoint_name
from embracenet_tpu_torch.training.modelspec import get_spec
from embracenet_tpu_torch.training.results import ResultsDict
from embracenet_tpu_torch.utils.profiling import counters, reset_counters

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_embrace_bench as bench  # noqa: E402
import torch_init_draws_bench as init_draws  # noqa: E402
import torch_optim_bench as optim_bench  # noqa: E402

MAIN = dict(B=4096, D0=256, D1=7936, E=1024, live=1024)
RAGGED = dict(B=100, D0=200, D1=5568, E=768, live=512)
# the train phase's shapes: a training batch of 100, an eval batch of 200
TRAIN = dict(B=100, D0=256, D1=7936, E=1024, live=1024)
EVAL = dict(B=200, D0=256, D1=7936, E=1024, live=1024)
# the trial-axis cases: populations of 2 and of 8 (bench.py's) at the
# train and eval batches
TRIALS = (2, 8)
SHAPES = (MAIN, RAGGED, TRAIN, EVAL)
# the bench phase's engine_bench batches (batch_size 1024: balanced train
# batches of 800 and an eval batch of 2048) and a batch of 1024: unsplit
# 64-row tiles
BENCH = tuple(dict(B=b, D0=256, D1=7936, E=1024, live=1024)
              for b in (800, 1024, 2048))
# edge shapes of the tiled kernel: x0 rows of 8 bytes in bf16 (padded for
# TMA), B around the 64-row tile, ragged K
EDGES = (dict(B=1, D0=4, D1=1024, E=512, live=512),
         dict(B=63, D0=16, D1=3200, E=768, live=768),
         dict(B=65, D0=64, D1=1000, E=768, live=640))
N_WINDOWS = 10_000
N_REQUESTS = 3
# the CV phase: HEPG2's width at about the reference's worst imbalance
CV_WINDOWS, CV_PREVALENCE = 4000, 0.05
CV_MODEL, CV_CELL, CV_TASK = "EmbraceNetMultimodal", "HEPG2", "active_E_vs_inactive_E"


def require(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def fused_launches(name="embrace.launches"):
    """Launches of a fused kernel since the counters were last reset."""
    return counters().get(name, 0)


class InitDraws:
    """Wraps ``engine.fit`` over the main-path phases: a fit on the card
    without ``init_params`` draws its init there, one launch of the MT19937
    kernel (``mt19937.launches``); a fit on the CPU or given its init
    launches none.  Counts those fits and launches, in all and per phase
    (:meth:`lap`).  Each fit on the card also updates through the fused
    optimizer kernel, one launch a train step (``optim.launches`` against
    ``engine.train_steps``), and a fit on the CPU never: those launches are
    :attr:`update_launches`."""

    def __init__(self):
        import inspect

        self.real = engine.fit
        self.signature = inspect.signature(engine.fit)
        self.fits = self.launches = self.update_launches = 0
        self.phases, self._lap = {}, (0, 0)

    def __call__(self, *args, **kw):
        bound_args = self.signature.bind(*args, **kw).arguments
        mesh = bound_args.get("mesh")
        dev = (mesh.device if mesh is not None
               else et.resolve_device(bound_args.get("device")))
        on_card = (torch.device(dev).type == "cuda"
                   and bound_args.get("init_params") is None)
        names = ("mt19937.launches", "optim.launches", "engine.train_steps")
        before = [counters().get(k, 0) for k in names]
        res = self.real(*args, **kw)
        launched, updates, steps = (counters().get(k, 0) - b
                                    for k, b in zip(names, before))
        card = torch.device(dev).type == "cuda"
        require(updates == (steps if card else 0),
                f"update: a fit on {dev} launched the fused optimizer update "
                f"{updates} times in {steps} train steps")
        self.update_launches += updates
        require(launched == int(on_card), f"init draws: a fit on {dev} "
                f"{'without' if bound_args.get('init_params') is None else 'with'}"
                f" init_params launched the MT19937 kernel {launched} times, "
                f"expected {int(on_card)}")
        self.fits += int(on_card)
        self.launches += launched
        return res

    def lap(self, phase):
        """File the fits and launches since the last lap under ``phase``."""
        now = (self.fits, self.launches)
        self.phases[phase] = {"card_fits": now[0] - self._lap[0],
                              "launches": now[1] - self._lap[1]}
        self._lap = now


def case_inputs(shape, dtype, dev, gen):
    """x0, x1, w0, b0, w1, b1, e_mask at ``shape``; the weights are views
    w[:D, :E] of wider tensors, as the model's bucket slices of dock*_w
    are."""
    B, D0, D1, E, live = (shape[k] for k in ("B", "D0", "D1", "E", "live"))

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    x0 = torch.relu(randn(B, D0)).to(dtype)
    x1 = torch.relu(randn(B, D1)).to(dtype)
    w0 = randn(D0 + 56, E + 256, scale=D0 ** -0.5).to(dtype)[:D0, :E]
    w1 = randn(D1, E + 256, scale=D1 ** -0.5).to(dtype)[:, :E]
    b0, b1 = randn(E, scale=0.1), randn(E, scale=0.1)
    e_mask = (torch.arange(E, device=dev) < live).float()
    return (x0, x1, w0, b0, w1, b1), e_mask


def kernel_case(shape, dtype, dev, gen):
    B, D0, D1, E, live = (shape[k] for k in ("B", "D0", "D1", "E", "live"))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    args, e_mask = case_inputs(shape, dtype, dev, gen)
    ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)

    d0, _ = K.fused_embrace_reference(*args, ones, e_mask, torch.zeros(B, E, device=dev))
    d1, _ = K.fused_embrace_reference(*args, zeros, e_mask, torch.zeros(B, E, device=dev))
    out, ch = K.fused_embrace(*args, ones, e_mask, 1)
    torch.testing.assert_close(out, d0, rtol=tol, atol=tol)
    require(bool((ch == 1).all()), "p0 = 1 must always choose modality 0")
    out, ch = K.fused_embrace(*args, zeros, e_mask, 1)
    torch.testing.assert_close(out, d1, rtol=tol, atol=tol)
    require(bool((ch == 0).all()), "p0 = 0 must never choose modality 0")

    p0 = spread_p0(B, dev)
    out, ch = K.fused_embrace(*args, p0, e_mask, 7)
    want = torch.where(ch.bool(), d0, d1)
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    max_err = float((out - want).abs().max())
    require(bool((out[:, live:] == 0).all()), "masked columns must be 0")
    again, ch_again = K.fused_embrace(*args, p0, e_mask, 7)
    require(torch.equal(out, again) and torch.equal(ch, ch_again),
            "the same seed must repeat bit for bit")
    _, ch_next = K.fused_embrace(*args, p0, e_mask, 8)
    require(not torch.equal(ch, ch_next), "seed + 1 must draw anew")
    _, ch_fulle = K.fused_embrace_fulle(*args, p0, e_mask, 7)
    require(torch.equal(ch, ch_fulle),
            "the full-E kernel must choose as fused_embrace for the same seed")

    seeds = 128 if B > 1000 else 256
    hits = torch.zeros(B, device=dev)
    for s in range(seeds):
        hits += K.fused_embrace(*args, p0, e_mask, 1000 + s)[1].sum(1)
    freq_err = float((hits / (seeds * E) - p0).abs().max())
    require(freq_err < 0.01, f"choose frequency off p0 by {freq_err}")

    u = torch.rand(B, E, generator=gen, device=dev)
    x0, x1, w0, _, w1, _ = args

    def products():
        with _highest_matmul_precision():
            return x0 @ w0, x1 @ w1

    plan = K.card_plan(B, E, D0, D1, dtype, torch.cuda.current_device())
    ms = cuda_ms(lambda: K.fused_embrace(*args, p0, e_mask, 3))
    device_ms = graph_ms(lambda: K.fused_embrace(*args, p0, e_mask, 3))
    plain_ms = cuda_ms(lambda: K.fused_embrace_reference(*args, p0, e_mask, u))
    plain_device_ms = graph_ms(
        lambda: K.fused_embrace_reference(*args, p0, e_mask, u))
    products_ms = graph_ms(products)
    bound_ms, bound_by, flops, nbytes = bound(B, D0, D1, E, dtype)
    return {"shape": [B, D0, D1, E], "dtype": str(dtype).split(".")[-1],
            "plan": {"tile": [plan.bm, plan.bn], "split": plan.split,
                     "ctas": plan.ctas,
                     "clusters_at_once": K.clusters_at_once(dtype, plan.bm,
                                                            plan.split)},
            "max_abs_err": max_err, "freq_err": freq_err, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "plain_device_ms": plain_device_ms,
            "products_ms": products_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "tflops": flops / device_ms / 1e9,
            "library_ms": None, "library": "none: no single PyTorch call "
            "docks two modalities and selects between them"}


def spread_p0(B, dev):
    """Per-row p0 spread over [0, 1] (0.5 for a single row)."""
    if B == 1:
        return torch.full((1,), 0.5, device=dev)
    return torch.linspace(0, 1, B, device=dev)


def row_base_case(kernel, shape, dtype, dev, gen):
    """``kernel`` (``fused_embrace`` or ``fused_embrace_fulle``) on rows
    [r, r + b) at ``row_base = r`` against the launch on the whole batch:
    the data mesh's halves and a ragged tail.  ``choose`` bit for bit, out
    within the kernel phase's tolerance (the shard's plan may sum K in
    another order); at ``row_base = 0`` on the whole batch, the launch
    without the argument bit for bit."""
    B = shape["B"]
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    fn = getattr(K, kernel)
    args, e_mask = case_inputs(shape, dtype, dev, gen)
    p0 = spread_p0(B, dev)
    out, ch = fn(*args, p0, e_mask, 7)
    out0, ch0 = fn(*args, p0, e_mask, 7, row_base=0)
    require(torch.equal(out, out0) and torch.equal(ch, ch0),
            f"{kernel}: row_base=0 must be the launch without it")
    err = 0.0
    for lo, hi in ((0, B // 2), (B // 2, B), (B - 37, B)):
        part = [a[lo:hi] for a in args[:2]] + list(args[2:])
        o, c = fn(*part, p0[lo:hi], e_mask, 7, row_base=lo)
        require(torch.equal(c, ch[lo:hi]), f"{kernel} at row_base={lo}: "
                "choose differs from the whole launch's rows")
        torch.testing.assert_close(o, out[lo:hi], rtol=tol, atol=tol)
        err = max(err, float((o - out[lo:hi]).abs().max()))
    return {"kernel": kernel, "shape": [B, shape["D0"], shape["D1"], shape["E"]],
            "dtype": str(dtype).split(".")[-1], "shards": [[0, B // 2], [B // 2, B],
                                                            [B - 37, B]],
            "max_abs_err_vs_whole": err}


def fulle_case(shape, dtype, dev, gen):
    """The full-E kernel held to the tiled kernel's checks, plus: the same
    choose bit for bit as ``fused_embrace`` and out within ``tol``."""
    B, D0, D1, E, live = (shape[k] for k in ("B", "D0", "D1", "E", "live"))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    args, e_mask = case_inputs(shape, dtype, dev, gen)
    ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    u0 = torch.zeros(B, E, device=dev)
    d0, _ = K.fused_embrace_reference(*args, ones, e_mask, u0)
    d1, _ = K.fused_embrace_reference(*args, zeros, e_mask, u0)
    out, ch = K.fused_embrace_fulle(*args, ones, e_mask, 1)
    torch.testing.assert_close(out, d0, rtol=tol, atol=tol)
    require(bool((ch == 1).all()), "fulle: p0 = 1 must always choose modality 0")
    out, ch = K.fused_embrace_fulle(*args, zeros, e_mask, 1)
    torch.testing.assert_close(out, d1, rtol=tol, atol=tol)
    require(bool((ch == 0).all()), "fulle: p0 = 0 must never choose modality 0")

    p0 = spread_p0(B, dev)
    out, ch = K.fused_embrace_fulle(*args, p0, e_mask, 7)
    want = torch.where(ch.bool(), d0, d1)
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    max_err = float((out - want).abs().max())
    require(bool((out[:, live:] == 0).all()), "fulle: masked columns must be 0")
    tiled, ch_tiled = K.fused_embrace(*args, p0, e_mask, 7)
    require(torch.equal(ch, ch_tiled),
            "fulle must choose as fused_embrace for the same seed")
    torch.testing.assert_close(out, tiled, rtol=tol, atol=tol)
    vs_tiled = float((out - tiled).abs().max())
    index = torch.cuda.current_device()
    plan = K.card_fulle_plan(B, E, D0, D1, dtype, index)
    tiled_plan = K.card_plan(B, E, D0, D1, dtype, index)
    bit_equal = torch.equal(out, tiled)
    same_tiles = plan.bm == tiled_plan.bm and tiled_plan.split == 1
    require(bit_equal or not same_tiles, "fulle: out must equal the tiled "
            "kernel's bit for bit where both run the same tiles in one K order")
    again, ch_again = K.fused_embrace_fulle(*args, p0, e_mask, 7)
    require(torch.equal(out, again) and torch.equal(ch, ch_again),
            "fulle: the same seed must repeat bit for bit")
    seeds = 128 if B > 1000 else 256
    hits = torch.zeros(B, device=dev)
    for s in range(seeds):
        hits += K.fused_embrace_fulle(*args, p0, e_mask, 1000 + s)[1].sum(1)
    freq_err = float((hits / (seeds * E) - p0).abs().max())
    require(freq_err < 0.01, f"fulle: choose frequency off p0 by {freq_err}")

    u = torch.rand(B, E, generator=gen, device=dev)
    x0, x1, w0, _, w1, _ = args

    def products():
        with _highest_matmul_precision():
            return x0 @ w0, x1 @ w1

    ms = cuda_ms(lambda: K.fused_embrace_fulle(*args, p0, e_mask, 3))
    device_ms = graph_ms(lambda: K.fused_embrace_fulle(*args, p0, e_mask, 3))
    tiled_device_ms = graph_ms(lambda: K.fused_embrace(*args, p0, e_mask, 3))
    plain_ms = cuda_ms(lambda: K.fused_embrace_reference(*args, p0, e_mask, u))
    products_ms = graph_ms(products)
    bound_ms, bound_by, flops, nbytes = bound(B, D0, D1, E, dtype)
    return {"shape": [B, D0, D1, E], "dtype": str(dtype).split(".")[-1],
            "plan": {"tile": [plan.bm, plan.bn], "cluster": plan.cluster,
                     "ctas": plan.ctas,
                     "clusters_at_once": K.clusters_at_once(
                         dtype, plan.bm, plan.cluster, fulle=True)},
            "tiled_plan": {"tile": [tiled_plan.bm, tiled_plan.bn],
                           "split": tiled_plan.split},
            "bit_equal_to_tiled": bit_equal, "same_tiles_as_tiled": same_tiles,
            "max_abs_err": max_err, "max_abs_vs_tiled": vs_tiled,
            "freq_err": freq_err, "ms": ms, "device_ms": device_ms,
            "tiled_device_ms": tiled_device_ms, "plain_ms": plain_ms,
            "products_ms": products_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "tflops": flops / device_ms / 1e9,
            "library_ms": None, "library": "none: no single PyTorch call "
            "docks two modalities and selects between them"}


def trial_case(n_trials, shape, dtype, dev, gen, timed=False):
    """Both kernels with a trial axis: ``n_trials`` trials at ``shape``,
    each with its own weights (views of wider tensors, as the population's
    ``dock*_w[:, :D, :E]``), biases, per-row p0, live width and seed.  Each
    trial's ``out`` and ``choose`` equal its single launch's bit for bit
    (the plan is one trial's, so its sums run in the same order); ``out``
    is the plain version's ``where(choose, d0, d1)`` within the kernel
    phase's tolerance, d0 / d1 at p0 = 1 / 0; the full-E kernel chooses as
    the tiled one.  ``timed``: device ms of the trial-axis launch, of the
    T single launches, of the plain version and of the two docking
    products as batched ``torch.matmul`` calls (the library's batched
    products, a yardstick), against T times one trial's bound."""
    B, D0, D1, E, live = (shape[k] for k in ("B", "D0", "D1", "E", "live"))
    T = n_trials
    tol = 1e-4 if dtype == torch.float32 else 1e-2

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    x0 = torch.relu(randn(T, B, D0)).to(dtype)
    x1 = torch.relu(randn(T, B, D1)).to(dtype)
    w0 = randn(T, D0 + 56, E + 256, scale=D0 ** -0.5).to(dtype)[:, :D0, :E]
    w1 = randn(T, D1, E + 256, scale=D1 ** -0.5).to(dtype)[:, :, :E]
    b0, b1 = randn(T, E, scale=0.1), randn(T, E, scale=0.1)
    lives = [max(1, live - 128 * (t % 3)) for t in range(T)]
    e_mask = torch.stack([(torch.arange(E, device=dev) < n).float()
                          for n in lives])
    args = (x0, x1, w0, b0, w1, b1)
    p0 = torch.rand(T, B, generator=gen, device=dev)
    seeds = torch.randint(0, 2 ** 31 - 1, (T,), generator=gen, device=dev)
    out, ch = K.fused_embrace(*args, p0, e_mask, seeds)
    for t in range(T):
        o1, c1 = K.fused_embrace(*(a[t] for a in args), p0[t], e_mask[t],
                                 seeds[t])
        require(torch.equal(c1, ch[t]) and torch.equal(o1, out[t]),
                f"trial axis {T} x {shape}: trial {t} differs from its "
                "single launch")
    ones, zeros = torch.ones(T, B, device=dev), torch.zeros(T, B, device=dev)
    u0 = torch.zeros(T, B, E, device=dev)
    d0, _ = K.fused_embrace_reference(*args, ones, e_mask, u0)
    d1, _ = K.fused_embrace_reference(*args, zeros, e_mask, u0)
    want = torch.where(ch.bool(), d0, d1)
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    for p, d, c in ((ones, d0, 1), (zeros, d1, 0)):
        o, chp = K.fused_embrace(*args, p, e_mask, seeds)
        torch.testing.assert_close(o, d, rtol=tol, atol=tol)
        require(bool((chp == c).all()), f"trial axis: p0 = {c} must choose "
                f"modality {1 - c} never")
    fo, fch = K.fused_embrace_fulle(*args, p0, e_mask, seeds)
    require(torch.equal(fch, ch), "trial axis: the full-E kernel must choose "
            "as the tiled one")
    torch.testing.assert_close(fo, want, rtol=tol, atol=tol)
    case = {"trials": T, "shape": [B, D0, D1, E], "lives": lives,
            "dtype": str(dtype).split(".")[-1],
            "max_abs_err": float((out - want).abs().max()),
            "fulle_max_abs_err": float((fo - want).abs().max())}
    if timed:
        u = torch.rand(T, B, E, generator=gen, device=dev)

        def singles():
            for t in range(T):
                K.fused_embrace(*(a[t] for a in args), p0[t], e_mask[t],
                                seeds[t])

        def products():
            with _highest_matmul_precision():
                return torch.matmul(x0, w0), torch.matmul(x1, w1)

        bound_ms, bound_by, flops, nbytes = bound(B, D0, D1, E, dtype)
        case.update({
            "ms": cuda_ms(lambda: K.fused_embrace(*args, p0, e_mask, seeds)),
            "device_ms": graph_ms(lambda: K.fused_embrace(*args, p0, e_mask,
                                                          seeds)),
            "singles_device_ms": graph_ms(singles),
            "fulle_device_ms": graph_ms(lambda: K.fused_embrace_fulle(
                *args, p0, e_mask, seeds)),
            "plain_ms": cuda_ms(lambda: K.fused_embrace_reference(
                *args, p0, e_mask, u)),
            "batched_products_ms": graph_ms(products),
            "bound_ms": T * bound_ms, "bound_by": bound_by,
            "tflops": T * flops / graph_ms(lambda: K.fused_embrace(
                *args, p0, e_mask, seeds)) / 1e9,
            "library_ms": None})
    return case


def grad_phase(shape, dev, gen):
    """The fused Function's gradients against autograd through the unfused
    path (the plain version, differentiated by torch) at p0 in {1, 0}, at
    ``shape`` in float32."""
    B, E = shape["B"], shape["E"]
    (x0, x1, w0, b0, w1, b1), e_mask = case_inputs(shape, torch.float32, dev, gen)
    g_out = torch.randn(B, E, generator=gen, device=dev)
    u = torch.zeros(B, E, device=dev)
    out = {"shape": [B, shape["D0"], shape["D1"], E]}

    def leaves():
        return [t.detach().clone().requires_grad_(True)
                for t in (x0, x1, w0, b0, w1, b1)]

    def fused(p0):
        ins = leaves()
        o, _ = K.fused_embrace(*ins, p0, e_mask, 5)
        return torch.autograd.grad((o * g_out).sum(), ins)

    def unfused(p0):
        ins = leaves()
        o, _ = K.fused_embrace_reference(*ins, p0, e_mask, u)
        return torch.autograd.grad((o * g_out).sum(), ins)

    names = ("dx0", "dx1", "dw0", "db0", "dw1", "db1")
    for label, p0 in (("p0=1", torch.ones(B, device=dev)),
                      ("p0=0", torch.zeros(B, device=dev))):
        errs = {}
        for name, gf, gu in zip(names, fused(p0), unfused(p0)):
            scale = max(float(gu.abs().max()), 1e-30)
            err = float((gf - gu).abs().max())
            require(err <= 1e-4 * scale,
                    f"{name} at {label}: fused vs unfused {err} > 1e-4 x {scale}")
            errs[name] = err / scale
        out[label] = errs
    p0 = torch.full((B,), 0.5, device=dev)
    out["fwd_bwd_fused_ms"] = cuda_ms(lambda: fused(p0), iters=10)
    out["fwd_bwd_unfused_ms"] = cuda_ms(lambda: unfused(p0), iters=10)
    return out


def train_phase():
    data = make_data(4000, IN_FEATURES, np.random.default_rng(0))
    train = {k: v[:3000] for k, v in data.items()}
    test = {k: v[3000:] for k, v in data.items()}
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=IN_FEATURES)
    flat = widest_flat_params(0.5)
    hp = space.params_to_hp("EmbraceNetMultimodal", flat)
    opt = space.optimizer_hp(flat)
    params, bn = embracenet.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    init = {k: v.numpy().copy() for k, v in params.items() if not isinstance(v, dict)}
    epochs, batch = 3, 100
    cfg = TrainConfig(num_epochs=epochs, epoch_chunk=epochs, batch_size=batch)

    # -- the main path: engine.fit on the card, fused kernel on (default) --
    reset_counters()
    t0 = time.perf_counter()
    res = engine.fit(spec, [hp], [opt], train, test, cfg,
                     init_params=engine.stack_trials([params]),
                     init_bn_state=engine.stack_trials([bn]))
    wall = time.perf_counter() - t0
    launches = fused_launches()
    n_fwd = epochs * (balanced_plan(train["y"], batch, seed=123).idx.shape[0]
                      + eval_plan(len(test["y"]), 2 * batch, seed=123).idx.shape[0])
    require(launches == n_fwd, f"train: {launches} kernel launches, expected "
            f"{n_fwd} (one per forward pass)")
    require(res.epochs_run == [epochs], f"epochs run {res.epochs_run}")
    hist = res.loss_train[0] + res.auprc_train[0] + res.auprc_test[0]
    require(all(math.isfinite(v) for v in hist), f"train: not finite {hist}")
    trained = tree_to_numpy(res.params)
    moved = {k: float(np.abs(trained[k][0] - v).max()) for k, v in init.items()}
    for k in ("dock0_w", "dock1_w", "dock0_b", "dock1_b", "head_w"):
        require(moved[k] > 0, f"train: {k} did not move")

    # -- a population of 8 trials as bench.py draws them, bf16, 1 epoch --
    flats = [space.sample_params("EmbraceNetMultimodal", np.random.default_rng(i))
             for i in range(8)]
    hps = [space.params_to_hp("EmbraceNetMultimodal", f) for f in flats]
    opts = [space.optimizer_hp(f) for f in flats]
    groups = plan_buckets(spec, "EmbraceNetMultimodal", hps, in_features=IN_FEATURES)
    pcfg = TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=batch,
                       compute_dtype="bfloat16", patience=10_000,
                       width_buckets=True)
    pop_launches0 = fused_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idxs in groups:
        engine.fit(spec, [hps[i] for i in idxs], [opts[i] for i in idxs],
                   train, test, pcfg)
    pop_wall = time.perf_counter() - t0
    pop_launches = fused_launches() - pop_launches0
    n_tr = balanced_plan(train["y"], batch, seed=123).idx.shape[0]
    n_ev = eval_plan(len(test["y"]), 2 * batch, seed=123).idx.shape[0]
    want = len(groups) * (n_tr + n_ev)
    require(pop_launches == want, f"population: {pop_launches} kernel "
            f"launches, expected {want} (one per population forward pass "
            f"of each of its {len(groups)} fits)")
    return {"launches": launches + pop_launches, "single": {
        "launches": launches, "expected_launches": n_fwd, "wall_s": wall,
        "train_windows_per_s": epochs * len(train["y"]) / wall,
        "loss_train": res.loss_train[0], "auprc_train": res.auprc_train[0],
        "auprc_test": res.auprc_test[0], "max_param_move": moved},
        "population": {"trials": 8, "groups": groups, "launches": pop_launches,
                       "expected_launches": want,
                       "launches_per_train_step": pop_launches
                       / (len(groups) * n_tr),
                       "wall_s": pop_wall,
                       "train_windows_per_s": 8 * len(train["y"]) / pop_wall}}


def bench_phase():
    reset_counters()
    row = bench.block_bench(4096, iters=5)
    launches = fused_launches("embrace.launches_fulle")
    require(launches > 0, "bench: the full-E kernel was never launched")
    eng = bench.engine_bench(True)
    require(eng["kernel_launches"] > 0, "bench: engine_bench(True) launched "
            "no fused kernel")
    # the 8-trial bf16 population of the train phase under torch.profiler:
    # kernels a train step and the card's busy share
    pop = bench.train_profile(True, "bfloat16", population=8)
    require(pop["fused_launches"] == pop["expected_launches"],
            f"bench: the population profile launched {pop['fused_launches']}"
            f" fused kernels, expected {pop['expected_launches']}")
    return {"launches_fulle": launches, "block": row, "engine_fused": eng,
            "population_profile": pop}


def serve_phase(workdir):
    rng = np.random.default_rng(0)
    hp = space.params_to_hp("EmbraceNetMultimodal", widest_flat_params(0.5))
    params, bn = embracenet.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    paths = {}
    for p in (0.5, 0.0, 1.0):
        paths[p] = os.path.join(workdir, f"embracenet_p{p}")
        save_checkpoint(paths[p], {"params": params, "bn_state": bn},
                        {"model": "EmbraceNetMultimodal",
                         "model_params": widest_flat_params(p)})
    requests = [{"ffnn": rng.normal(size=(N_WINDOWS, IN_FEATURES)).astype(np.float32),
                 "cnn": rng.integers(0, 4, size=(N_WINDOWS, 256), dtype=np.uint8),
                 "y": (rng.random(N_WINDOWS) < 0.3).astype(np.int64)}
                for _ in range(N_REQUESTS)]

    # -- the main path: predict requests through load_model, on the card --
    reset_counters()
    walls = []
    for data in requests:
        t0 = time.perf_counter()
        probs = et.predict(paths[0.5], data)
        walls.append(time.perf_counter() - t0)
        require(probs.shape == (N_WINDOWS, 2), f"probs shape {probs.shape}")
        require(bool(np.isfinite(probs).all()), "probabilities must be finite")
        require(bool(np.abs(probs.sum(1) - 1).max() <= 1e-5),
                "probability rows must sum to 1")
    launches = fused_launches()
    want = N_REQUESTS * math.ceil(N_WINDOWS / 4096)
    require(launches == want, f"{launches} kernel launches, expected {want}")
    ckpt = checkpoint_case({"params": params, "bn_state": bn},
                           {"model": "EmbraceNetMultimodal",
                            "model_params": widest_flat_params(0.5)},
                           requests[0], workdir)
    launches += ckpt["launches"]

    # -- checks and measurements after the counted run --
    model = load_model(paths[0.5])
    model(requests[0])  # returns numpy: the device has finished
    t0 = time.perf_counter()
    model(requests[1])
    steady = time.perf_counter() - t0
    metrics = et.evaluate(paths[0.5], requests[2])
    require(set(metrics) >= {"AUPRC", "AUROC", "F1", "accuracy"},
            f"evaluate keys {sorted(metrics)}")
    require(all(math.isfinite(v) for v in metrics.values()), "metrics finite")

    small = {k: v[:4096] for k, v in requests[0].items()}
    cpu_rows = 64
    extremes = {}
    for p in (0.0, 1.0):
        fused = load_model(paths[p])(small, logits=True)
        unfused = load_model(paths[p], fused_embrace=False)(small, logits=True)
        np.testing.assert_allclose(fused, unfused, rtol=1e-4, atol=1e-4)
        cpu_model = load_model(paths[p], device="cpu")
        cpu_model.BATCH = cpu_rows
        cpu = cpu_model({k: v[:cpu_rows] for k, v in small.items()}, logits=True)
        np.testing.assert_allclose(fused[:cpu_rows], cpu, rtol=1e-4, atol=1e-4)
        extremes[p] = {"fused_vs_unfused": float(np.abs(fused - unfused).max()),
                       "card_vs_cpu": float(np.abs(fused[:cpu_rows] - cpu).max())}
    return {"launches": launches, "request_s": walls, "checkpoint": ckpt,
            "windows_per_s_request": [N_WINDOWS / w for w in walls],
            "windows_per_s_model_call": N_WINDOWS / steady,
            "evaluate": metrics, "extremes": extremes}


def tree_bytes(path) -> int:
    """Bytes on disk of a file, or of every file in a directory."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def same_trees(got, want) -> bool:
    """The same nesting, and at every leaf the same dtype, shape and values."""
    def layout(tree):
        return tree_map(lambda a: (np.asarray(a).dtype.str, np.shape(a)), tree)
    return (layout(got) == layout(want)
            and all(np.array_equal(g, w) for g, w in
                    zip(tree_leaves(got), tree_leaves(want))))


def checkpoint_case(trees, meta, data, workdir):
    """The checkpoint's second backend on the serving path: ``trees`` moved
    to the card, saved with ``save_checkpoint_orbax`` from the CUDA
    tensors and loaded back (every leaf and the meta as saved); a
    ``ReloadedModel`` of the loaded trees answers ``data`` with
    ceil(N / 4096) launches of the tiled kernel (counted), and its
    probabilities equal bit for bit those of ``load_model`` on the npz
    checkpoint of the same trees.  The DCP import's wall, and both
    backends' save walls (twice: the second overwrites the first), load
    wall and bytes on disk."""
    card = tree_to_torch(trees, "cuda")
    want = tree_to_numpy(card)
    path = os.path.join(workdir, "widest")
    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401  (the backend's import)
    loads, walls = {}, {"dcp_import_s": time.perf_counter() - t0}
    for name, save, load, suffix in (
            ("dcp", save_checkpoint_orbax, load_checkpoint_orbax, ".orbax"),
            ("npz", save_checkpoint, load_checkpoint, ".npz")):
        saves = []
        for _ in range(2):          # the second save overwrites the first
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(path, card, meta)
            saves.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        loads[name] = load(path)
        walls[name] = {"save_s": saves, "load_s": time.perf_counter() - t0,
                       "bytes": tree_bytes(path + suffix)}
    loaded, loaded_meta = loads["dcp"]
    require(loaded_meta == meta and same_trees(loaded, want),
            "checkpoint: the DCP backend's load differs from what was saved")
    n_rows = len(data["y"])
    reset_counters()
    model = ReloadedModel(loaded_meta["model"], loaded["params"],
                          loaded.get("bn_state", {}), loaded_meta["model_params"],
                          in_features_ffnn=IN_FEATURES)
    probs = model(data)
    launches = fused_launches()
    expect = math.ceil(n_rows / ReloadedModel.BATCH)
    require(launches == expect, f"checkpoint: the reloaded model launched "
            f"{launches} kernels, expected {expect}")
    ref = load_model(path)(data)
    require(np.array_equal(probs, ref), "checkpoint: the DCP-loaded model's "
            "probabilities differ from the npz checkpoint's "
            f"(max {float(np.abs(probs - ref).max())})")
    out = {"launches": launches, "windows": n_rows, **walls}
    print(json.dumps({"checkpoint_backends": out}), flush=True)
    return out


def strided_copy(w):
    """A copy of the weight view ``w`` with its strides (the model hands
    the kernel ``dock*_w[:, :D, :E]`` of the full-width parameter)."""
    extent = 1 + sum((n - 1) * st for n, st in zip(w.shape, w.stride()))
    base = torch.empty(extent, dtype=w.dtype, device=w.device)
    view = base.as_strided(w.shape, w.stride())
    view.copy_(w)
    return view


class ShapeLog:
    """Stands in for ``ops.embrace.fused_embrace`` (``models.embracenet``
    looks it up at each call) while the counted phases run.  At each
    distinct operand layout (B, D0, D1, E, dtype, the weights' row strides,
    row_base, T trials) it keeps the first call's inputs and outputs with a
    trial axis (a call without one is a population of one), copied on the
    stream right after the launch; it launches no kernel and syncs
    nothing."""

    def __init__(self):
        self.seen = {}
        self.real = K.fused_embrace

    def __call__(self, x0, x1, w0, b0, w1, b1, p0, e_mask, seed, row_base=0):
        out, choose = self.real(x0, x1, w0, b0, w1, b1, p0, e_mask, seed,
                                row_base=row_base)
        if x0.is_cuda:
            if x0.dim() == 2:   # one trial: the trial axis as a view
                x0, x1, w0, b0, w1, b1, p0, e_mask = (
                    t[None] for t in (x0, x1, w0, b0, w1, b1, p0, e_mask))
                o, c = out[None], choose[None]
            else:
                o, c = out, choose
            key = (x0.shape[1], w0.shape[1], w1.shape[1], w0.shape[2],
                   str(x0.dtype).split(".")[-1], w0.stride(1), w1.stride(1),
                   int(row_base), x0.shape[0])
            if key not in self.seen:
                with torch.no_grad():
                    self.seen[key] = {"calls": 0, "args": (
                        x0.clone(), x1.clone(), strided_copy(w0), b0.clone(),
                        strided_copy(w1), b1.clone(), p0.clone(),
                        e_mask.clone(),
                        seed.clone() if isinstance(seed, torch.Tensor) else seed),
                        "out": o.detach().clone(), "choose": c.clone()}
            self.seen[key]["calls"] += 1
        return out, choose


def path_case(key, rec, dev):
    """The kernel replayed on one layout the main paths gave it (at its
    row_base): the same outputs bit for bit as on the path,
    ``where(choose, d0, d1)`` of the plain version within the kernel
    phase's tolerance, d0 / d1 at p0 = 1 / 0, masked columns 0."""
    B, D0, D1, E, dtype, s0, s1, row_base, T = key
    tol = 1e-4 if dtype == "float32" else 1e-2
    x0, x1, w0, b0, w1, b1, p0, e_mask, seed = rec["args"]
    args = (x0, x1, w0, b0, w1, b1)
    ones, zeros = torch.ones(T, B, device=dev), torch.zeros(T, B, device=dev)
    u0 = torch.zeros(T, B, E, device=dev)
    d0, _ = K.fused_embrace_reference(*args, ones, e_mask, u0)
    d1, _ = K.fused_embrace_reference(*args, zeros, e_mask, u0)
    out, ch = K.fused_embrace(*args, p0, e_mask, seed, row_base=row_base)
    require(torch.equal(out, rec["out"]) and torch.equal(ch, rec["choose"]),
            f"path shape {key}: the replay differs from the output the path "
            "got")
    want = torch.where(ch.bool(), d0, d1)
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    require(bool((out.masked_select((e_mask == 0)[:, None, :]) == 0).all()),
            f"path shape {key}: masked columns must be 0")
    out1, ch1 = K.fused_embrace(*args, ones, e_mask, 1)
    torch.testing.assert_close(out1, d0, rtol=tol, atol=tol)
    out0, ch0 = K.fused_embrace(*args, zeros, e_mask, 1)
    torch.testing.assert_close(out0, d1, rtol=tol, atol=tol)
    require(bool((ch1 == 1).all()) and bool((ch0 == 0).all()),
            f"path shape {key}: p0 = 1 / 0 must choose modality 0 / 1")
    return {"shape": [B, D0, D1, E], "trials": T, "dtype": dtype,
            "w_row_strides": [s0, s1], "row_base": row_base,
            "live": int(e_mask.sum()), "calls": rec["calls"],
            "max_abs_err": max(float((out - want).abs().max()),
                               float((out1 - d0).abs().max()),
                               float((out0 - d1).abs().max())),
            # trained activations grow: the error's scale
            "max_abs_plain": max(float(d0.abs().max()), float(d1.abs().max()))}


def population_launches(spec, data_train, data_test, cfg, epochs, **kw):
    """The fused-kernel launches of a fit whose population ran ``epochs``
    epochs: one a population forward pass, ``epochs`` x (its train batches
    + its eval batches) for an EmbraceNetMultimodal fit with the fused
    kernel on, whatever its number of trials; 0 for any other fit."""
    if spec.name != "EmbraceNetMultimodal" or cfg.fused_embrace is False:
        return 0
    tp, ep = kw.get("train_plans"), kw.get("eval_plans")
    nb_train = (max(p.idx.shape[0] for p in tp) if tp else balanced_plan(
        np.asarray(data_train["y"]), cfg.batch_size, seed=123).idx.shape[0])
    nb_eval = (max(p.idx.shape[0] for p in ep) if ep else eval_plan(
        len(np.asarray(data_test["y"])), 2 * cfg.batch_size,
        seed=123).idx.shape[0])
    return epochs * (nb_train + nb_eval)


class FitLog:
    """Wraps ``engine.fit`` (which ``hpo.search`` and ``training.cv`` call
    through the module) to log, per fit, its kind (a search reports each
    epoch, a retrain does not), its wall, its kernel launches, the windows
    its trials trained (the fit's own ``chunk_callback`` count) and each
    trial's train-loss history.  Every fit must launch the fused kernel
    once per population forward pass (:func:`population_launches` of the
    epochs its chunks ran)."""

    def __init__(self):
        self.fits = []
        self.real = engine.fit

    def __call__(self, spec, hps, opts, data_train, data_test, cfg, **kw):
        entry = {"kind": "search" if kw.get("report_fn") else "retrain",
                 "trials": len(hps), "windows": 0.0, "epochs": 0}

        def count(_chunk, n_ep, _wall, windows_per_epoch):
            entry["windows"] += windows_per_epoch * n_ep
            entry["epochs"] += n_ep

        launches0 = fused_launches()
        t0 = time.perf_counter()
        res = self.real(spec, hps, opts, data_train, data_test, cfg,
                        chunk_callback=count, **kw)
        entry["wall_s"] = time.perf_counter() - t0   # fit() ends with a fetch
        entry["launches"] = fused_launches() - launches0
        entry["expected_launches"] = population_launches(
            spec, data_train, data_test, cfg, entry["epochs"], **kw)
        require(entry["launches"] == entry["expected_launches"],
                f"a fit of {len(hps)} trials launched {entry['launches']} "
                f"kernels, expected {entry['expected_launches']} (one per "
                "population forward pass)")
        entry["loss_train"] = res.loss_train
        self.fits.append(entry)
        return res


def trial_reads(name, array, hp):
    """The part of checkpoint array ``name`` that its trial's forward reads:
    all of it but the BatchNorm running statistics of CNN blocks beyond the
    trial's depth and of channels beyond its width.  A training step
    updates those in every block up to the population's deepest trial, as
    the JAX package's ``cnn.features`` does, so they depend on which trials
    share the population; nothing of the trial reads them."""
    parts = name.split("|")
    if parts[0] != "bn_state":
        return array
    block = int(parts[1][len("bn"):])
    if block >= int(hp["cnn"]["n_layers"]):
        return array[:0]
    return array[:int(hp["cnn"]["channels"][block])]


def fused_vs_sequential(seq_fits, fus_fits, seq_dir, fus_dir):
    """Largest difference between the fold-fused and the sequential run in
    each trial's train-loss history (the fused search population is the
    folds' searches in fold order, the fused retrain the folds' retrains)
    and in every checkpoint both wrote, in what its trial reads
    (:func:`trial_reads`)."""
    loss = 0.0
    for kind in ("search", "retrain"):
        seq = [h for f in seq_fits if f["kind"] == kind for h in f["loss_train"]]
        fus = [h for f in fus_fits if f["kind"] == kind for h in f["loss_train"]]
        require(len(seq) == len(fus) and all(len(a) == len(b)
                                             for a, b in zip(seq, fus)),
                f"cv: {kind} loss histories differ in length")
        loss = max([loss] + [abs(x - y) for a, b in zip(seq, fus)
                             for x, y in zip(a, b)])
    files = sorted(f for f in os.listdir(seq_dir) if f.endswith(".npz"))
    require(files and files == sorted(f for f in os.listdir(fus_dir)
                                      if f.endswith(".npz")),
            "cv: fused and sequential wrote other checkpoints")
    params, meta_equal = 0.0, True
    for name in files:
        with np.load(os.path.join(seq_dir, name)) as a, \
                np.load(os.path.join(fus_dir, name)) as b:
            keys = [k for k in a.files if k != "__meta__"]
            require(keys == [k for k in b.files if k != "__meta__"],
                    f"cv: {name} holds other arrays fused than sequential")
            meta_equal = meta_equal and bytes(a["__meta__"]) == bytes(b["__meta__"])
            meta = json.loads(bytes(a["__meta__"]).decode())
            hp = space.params_to_hp(CV_MODEL, meta["model_params"])
            params = max([params] + [float(np.abs(
                trial_reads(k, a[k], hp).astype(np.float64)
                - trial_reads(k, b[k], hp)).max(initial=0.0)) for k in keys])
    return {"loss_train_max_abs": loss, "checkpoint_max_abs": params,
            "checkpoints": len(files), "metadata_equal": meta_equal}


def cv_run(data, workdir, name, log, fuse=False):
    """One ``embracenet_tpu_torch.train`` call of the CV phase on the card
    -> (scores, its fits, wall s, kernel launches, storage, checkpoints)."""
    storage = os.path.join(workdir, f"{name}.db")
    ckdir = os.path.join(workdir, name)
    results = ResultsDict(os.path.join(workdir, f"{name}_results.json"))
    first = len(log.fits)
    reset_counters()
    t0 = time.perf_counter()
    scores = et.train(CV_MODEL, CV_CELL, CV_TASK, data=data,
                      cv_cfg=CVConfig(n_folds=3, n_trials=3, sampler="TPE",
                                      fuse_folds=fuse),
                      train_cfg=TrainConfig(num_epochs=2, epoch_chunk=2,
                                            batch_size=100),
                      results=results, storage=storage, checkpoint_dir=ckdir)
    wall = time.perf_counter() - t0
    return scores, log.fits[first:], wall, fused_launches(), storage, ckdir


def study_rows(storage):
    """{fold: [(number, state, params, intermediate), ...]} of a CV run."""
    out = {}
    for fold in (1, 2, 3):
        st = Study(f"{CV_CELL}_{CV_TASK}_{CV_MODEL}_{fold}", storage)
        out[fold] = [(t.number, t.state, t.params, t.intermediate)
                     for t in st.trials]
        st.close()
    return out


def check_cv_run(scores, rows, ckdir, results_path):
    study = f"{CV_CELL}_{CV_TASK}_{CV_MODEL}"
    for fold, trials in rows.items():
        require(len(trials) == 3 and all(t[1] in ("COMPLETE", "PRUNED")
                                         for t in trials),
                f"cv: fold {fold}'s study rows {[t[:2] for t in trials]}")
        for number, state, _, _ in trials:
            if state == "COMPLETE":
                path = os.path.join(ckdir, f"{study}_{fold}{number}.npz")
                require(os.path.exists(path), f"cv: missing {path}")
        path = os.path.join(ckdir, f"{study}_fold{fold}_result.npz")
        require(os.path.exists(path), f"cv: missing {path}")
        it = scores[f"iteration_n_{fold}"]
        values = (it["AUPRC_train"] + it["AUPRC_test"]
                  + [v for f1 in it["F1_precision_recall"] for v in f1])
        require(values and all(math.isfinite(v) for v in values),
                f"cv: fold {fold} scores not finite")
    best = os.path.join(ckdir, checkpoint_name(CV_CELL, CV_MODEL, CV_TASK, 0)
                        + ".npz")
    require(os.path.exists(best), f"cv: missing the fold-best {best}")
    finals = scores["final_test_AUPRC_scores"]
    require(len(finals) == 3 and all(math.isfinite(v) for v in finals)
            and all(math.isfinite(v) for v in scores["final_train_AUPRC_scores"]),
            f"cv: final scores {finals}")
    require(scores["average_CV_AUPRC"] == float(np.round(sum(finals) / 3, 5)),
            f"cv: average_CV_AUPRC {scores['average_CV_AUPRC']} of {finals}")
    with open(results_path) as fh:
        saved = json.load(fh)[CV_CELL][CV_TASK]
    require(saved[CV_MODEL]["average_CV_AUPRC"] == scores["average_CV_AUPRC"]
            and "baseline_AUPRC" in saved, "cv: results JSON lacks the entry")
    return best


def cv_phase(workdir):
    data = make_data(CV_WINDOWS, IN_FEATURES, np.random.default_rng(0),
                     prevalence=CV_PREVALENCE)
    log = FitLog()
    engine.fit = log
    try:
        # -- the main path: K-fold CV with a search per fold, sequential --
        seq, seq_fits, seq_wall, seq_launches, seq_db, seq_dir = cv_run(
            data, workdir, "seq", log)
        seq_rows = study_rows(seq_db)
        best = check_cv_run(seq, seq_rows, seq_dir,
                            os.path.join(workdir, "seq_results.json"))
        kinds = [f["kind"] for f in seq_fits]
        require(kinds == ["search", "retrain"] * 3,
                f"cv: sequential fits {kinds}, expected a search and a "
                "retrain per fold")
        require(all(f["launches"] > 0 for f in seq_fits),
                f"cv: a fit launched no kernel: {seq_fits}")

        # -- the same CV fold-fused: one search population, one retrain --
        fus, fus_fits, fus_wall, fus_launches, fus_db, fus_dir = cv_run(
            data, workdir, "fused", log, fuse=True)
        fus_rows = study_rows(fus_db)
        check_cv_run(fus, fus_rows, fus_dir,
                     os.path.join(workdir, "fused_results.json"))
        require([f["kind"] for f in fus_fits] == ["search", "retrain"]
                 and all(f["launches"] > 0 for f in fus_fits),
                 f"cv: fused fits {fus_fits}")
        require(fus_launches < seq_launches, f"cv: the fold-fused run "
                f"launched {fus_launches} kernels, the sequential one "
                f"{seq_launches}")
        # each trial must train as in the sequential run: the same losses
        # and the same parameters in every checkpoint
        exact = fused_vs_sequential(seq_fits, fus_fits, seq_dir, fus_dir)
        print(json.dumps({"cv_fused_vs_sequential": exact}), flush=True)
        require(exact["loss_train_max_abs"] <= 1e-6
                and exact["checkpoint_max_abs"] <= 1e-6
                and exact["metadata_equal"],
                f"cv: fused training differs from sequential: {exact}")
        diffs = []
        for fold in (1, 2, 3):
            for a, b in zip(seq_rows[fold], fus_rows[fold]):
                require(a[0] == b[0] and a[2] == b[2],
                        f"cv: fold {fold} trial {a[0]}: fused sampled "
                        "other params than sequential")
                diffs += [abs(a[3][e] - b[3][e]) for e in a[3] if e in b[3]]
            diffs += [abs(x - y) for x, y in zip(
                seq[f"iteration_n_{fold}"]["AUPRC_test"],
                fus[f"iteration_n_{fold}"]["AUPRC_test"])]
        fused_vs_seq = max(diffs)
        print(json.dumps({"cv_fused_vs_sequential_max_abs": fused_vs_seq}),
              flush=True)
        require(fused_vs_seq <= 0.05, f"cv: fused test-AUPRC histories off "
                f"the sequential ones by {fused_vs_seq}")

        # -- resume: every fold comes from its checkpoint --
        again, again_fits, again_wall, again_launches, _, _ = cv_run(
            data, workdir, "seq", log)
        require(again_launches == 0 and not again_fits,
                f"cv: resume launched {again_launches} kernels, fits {again_fits}")
        require(again["final_test_AUPRC_scores"] == seq["final_test_AUPRC_scores"]
                and again["average_CV_AUPRC"] == seq["average_CV_AUPRC"],
                "cv: resumed scores differ")
    finally:
        engine.fit = log.real

    # -- serve the fold-best checkpoint on the card --
    reset_counters()
    t0 = time.perf_counter()
    probs = et.predict(best, data)
    predict_wall = time.perf_counter() - t0
    predict_launches = fused_launches()
    require(predict_launches > 0, "cv: predict launched no kernel")
    require(probs.shape == (CV_WINDOWS, 2) and bool(np.isfinite(probs).all())
            and bool(np.abs(probs.sum(1) - 1).max() <= 1e-5),
            "cv: fold-best predictions must be finite rows that sum to 1")

    def run(scores, fits, wall, launches):
        windows = sum(f["windows"] for f in fits)
        return {"wall_s": wall, "fits_wall_s": sum(f["wall_s"] for f in fits),
                "launches": launches,
                "train_windows": windows, "train_windows_per_s": windows / wall,
                "fits": fits,
                "final_test_AUPRC": scores["final_test_AUPRC_scores"],
                "final_train_AUPRC": scores["final_train_AUPRC_scores"],
                "average_CV_AUPRC": scores["average_CV_AUPRC"]}

    return {"launches": seq_launches + fus_launches + predict_launches,
            "windows": CV_WINDOWS, "positives": int(data["y"].sum()),
            "sequential": run(seq, seq_fits, seq_wall, seq_launches),
            "fused": run(fus, fus_fits, fus_wall, fus_launches),
            "resume": {"wall_s": again_wall, "launches": again_launches},
            "fused_vs_sequential_max_abs": fused_vs_seq,
            "fused_vs_sequential": exact,
            "predict": {"wall_s": predict_wall, "launches": predict_launches}}


MODELS = ("ConcatNetMultimodal", "CNN_LSTM")
WIDEST = {"ConcatNetMultimodal": widest_concat_flat_params,
          "CNN_LSTM": widest_lstm_flat_params}
# the models phase: the eval windows held card against CPU, the fit's
# windows (make_data's 3,000 train and 1,000 test) and the CV's
MODEL_EVAL_WINDOWS, MODEL_CV_WINDOWS = 512, 2000
# the data phase: regions per family, the cell lines' widths (HEPG2 566
# features, as in the survey; a second line of 52) and the task
DATA_REGIONS = 5000
DATA_WIDTHS = {"HEPG2": 566, "K562": 52}
DATA_TASK = "active_E_vs_inactive_E"


def max_rel_err(got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def model_phase(model, workdir):
    """The widest trial of ``model`` from seed 0: its eval forward on the
    card against the CPU, one ``engine.fit``, then ``train`` with 2 folds x
    2 trials and ``predict`` on the fold-best checkpoint, card against
    CPU."""
    flat = WIDEST[model]()
    hp = space.params_to_hp(model, flat)
    spec = get_spec(model, in_features_ffnn=IN_FEATURES)
    params, bn = spec.init(torch.Generator().manual_seed(0), hp)
    data = make_data(4000, IN_FEATURES, np.random.default_rng(0))
    path = os.path.join(workdir, f"{model}_widest")
    save_checkpoint(path, {"params": params, "bn_state": bn},
                    {"model": model, "model_params": flat})
    window = {k: v[:MODEL_EVAL_WINDOWS] for k, v in data.items()}

    # -- the widest trial's eval forward: card against CPU --
    t0 = time.perf_counter()
    card = load_model(path)(window, logits=True)
    card_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_model = load_model(path, device="cpu")
    cpu_model.BATCH = MODEL_EVAL_WINDOWS   # no padding to 4096 rows
    cpu = cpu_model(window, logits=True)
    cpu_wall = time.perf_counter() - t0
    forward_err = max_rel_err(card, cpu)
    require(np.isfinite(card).all() and forward_err <= 1e-4,
            f"{model}: card logits off the CPU's by {forward_err} of max")
    metrics = et.evaluate(path, window)
    require(all(math.isfinite(v) for v in metrics.values()),
            f"{model}: evaluate {metrics}")

    # -- one engine.fit of it: float32, batch 100, 1 epoch --
    train = {k: v[:3000] for k, v in data.items()}
    test = {k: v[3000:] for k, v in data.items()}
    init = tree_to_numpy(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.fit(spec, [hp], [space.optimizer_hp(flat)], train, test,
                     TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=100),
                     init_params=engine.stack_trials([params]),
                     init_bn_state=engine.stack_trials([bn]))
    fit_wall = time.perf_counter() - t0
    hist = res.loss_train[0] + res.auprc_train[0] + res.auprc_test[0]
    require(res.epochs_run == [1] and all(math.isfinite(v) for v in hist),
            f"{model}: fit history {hist}")
    trained = tree_to_numpy(res.params)
    moved = max(float(np.abs(a[0] - b).max()) for a, b in zip(
        tree_leaves(trained), tree_leaves(init)))
    require(moved > 0, f"{model}: no parameter moved")
    loss_train = res.loss_train[0]
    del res, trained

    # -- train: 2 folds x 2 TPE trials x 1 epoch, then predict --
    cv_data = {k: v[:MODEL_CV_WINDOWS] for k, v in data.items()}
    t0 = time.perf_counter()
    scores = et.train(model, CV_CELL, CV_TASK, data=cv_data,
                      cv_cfg=CVConfig(n_folds=2, n_trials=2, sampler="TPE"),
                      train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1,
                                            batch_size=100),
                      storage=os.path.join(workdir, f"{model}.db"),
                      checkpoint_dir=os.path.join(workdir, model))
    cv_wall = time.perf_counter() - t0
    finals = scores["final_test_AUPRC_scores"]
    require(len(finals) == 2 and all(math.isfinite(v) for v in finals),
            f"{model}: CV final scores {finals}")
    best = os.path.join(workdir, model,
                        checkpoint_name(CV_CELL, model, CV_TASK, 0))
    t0 = time.perf_counter()
    card = et.predict(best, window)
    predict_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = et.predict(best, window, device="cpu")
    predict_cpu_wall = time.perf_counter() - t0
    predict_err = float(np.abs(card - cpu).max())
    require(predict_err <= 1e-4, f"{model}: fold-best predict on the card "
            f"off the CPU's by {predict_err}")
    return {"model": model, "flat": flat,
            "forward_card_vs_cpu_rel": forward_err,
            "forward_512_wall_s": card_wall, "forward_512_cpu_wall_s": cpu_wall,
            "evaluate": metrics,
            "fit": {"wall_s": fit_wall,
                    "train_windows_per_s": len(train["y"]) / fit_wall,
                    "loss_train": loss_train, "max_param_move": moved},
            "cv": {"windows": MODEL_CV_WINDOWS, "wall_s": cv_wall,
                   "final_test_AUPRC": finals,
                   "average_CV_AUPRC": scores["average_CV_AUPRC"]},
            "predict": {"wall_s": predict_wall, "cpu_wall_s": predict_cpu_wall,
                        "card_vs_cpu_max_abs": predict_err}}


def data_phase(workdir):
    """Raw files -> ``preprocess`` (built, then from its cache) ->
    ``train(pipeline=...)`` of EmbraceNetMultimodal on the card ->
    ``predict`` on the fold-best checkpoint."""
    from embracenet_tpu_torch import runtime

    root = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    write_raw_dataset(root, DATA_REGIONS, DATA_WIDTHS, seed=0)
    write_wall = time.perf_counter() - t0
    require(runtime.available(), "data: the native runtime did not build: "
            f"{runtime.BUILD_ERROR}")
    cache = os.path.join(workdir, "cache")
    t0 = time.perf_counter()
    pipe = et.preprocess(DATA_TASK, root=root, cache_dir=cache)
    pipe_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = et.preprocess(DATA_TASK, root=root, cache_dir=cache)
    cached_wall = time.perf_counter() - t0
    require(again.walls["load"] == 0 and again.cells() == pipe.cells()
            == sorted(DATA_WIDTHS), "data: the second preprocess did not "
            "come from the cache")
    for cell in pipe.cells():
        a, b = pipe.cell_data(cell), again.cell_data(cell)
        require(all(np.array_equal(a[k], b[k]) for k in a)
                and pipe.feature_names[cell] == again.feature_names[cell],
                f"data: {cell}'s cached arrays differ")
    data = again.cell_data(CV_CELL)
    require(data["ffnn"].shape[1] > 0 and np.isfinite(data["ffnn"]).all(),
            f"data: {CV_CELL} features {data['ffnn'].shape}")

    log = FitLog()
    engine.fit = log
    try:
        reset_counters()
        t0 = time.perf_counter()
        scores = et.train(CV_MODEL, CV_CELL, DATA_TASK, pipeline=again,
                          cv_cfg=CVConfig(n_folds=2, n_trials=2, sampler="TPE"),
                          train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1,
                                                batch_size=100),
                          storage=os.path.join(workdir, "data.db"),
                          checkpoint_dir=os.path.join(workdir, "data_models"))
        cv_wall = time.perf_counter() - t0
        launches = fused_launches()
    finally:
        engine.fit = log.real
    require([f["kind"] for f in log.fits] == ["search", "retrain"] * 2
            and all(f["launches"] > 0 for f in log.fits),
            f"data: fits {[(f['kind'], f['launches']) for f in log.fits]}")
    finals = scores["final_test_AUPRC_scores"] + scores["final_train_AUPRC_scores"]
    require(all(math.isfinite(v) for v in finals), f"data: scores {finals}")
    best = os.path.join(workdir, "data_models",
                        checkpoint_name(CV_CELL, CV_MODEL, DATA_TASK, 0))
    reset_counters()
    probs = et.predict(best, data)
    predict_launches = fused_launches()
    require(predict_launches > 0 and probs.shape == (len(data["y"]), 2)
            and bool(np.isfinite(probs).all())
            and bool(np.abs(probs.sum(1) - 1).max() <= 1e-5),
            "data: fold-best predictions must be finite rows that sum to 1")
    return {"launches": launches + predict_launches,
            "regions_per_family": DATA_REGIONS, "widths": DATA_WIDTHS,
            "write_raw_wall_s": write_wall,
            "pipeline_wall_s": pipe_wall, "pipeline_stage_wall_s": pipe.walls,
            "pipeline_cached_wall_s": cached_wall,
            "selected_features": {c: int(pipe.features[c].shape[1])
                                  for c in pipe.cells()},
            "windows": int(len(data["y"])), "positives": int(data["y"].sum()),
            "cv": {"wall_s": cv_wall, "launches": launches,
                   "fits": [{k: f[k] for k in ("kind", "trials", "launches",
                                               "wall_s", "windows")}
                            for f in log.fits],
                   "final_test_AUPRC": scores["final_test_AUPRC_scores"]},
            "predict_launches": predict_launches}, again


# the sweep phase: HEPG2's width at the CV phase's prevalence.  4,000
# windows, because every split of the sweep's 2-fold CV then passes the
# reference's reverse-strand and augmentation asserts (a ratio of 0.1 to
# two decimals) in both packages; at 2,400, 3,000, 3,600 or 4,800 windows
# one split fails them.
SWEEP_WINDOWS = 4000
SWEEP_ENTRIES = ("FFNN_smote", "FFNN_double", "FFNN", "CNN",
                 "ConcatNetMultimodal", "EmbraceNetMultimodal",
                 "EmbraceNetMultimodal_augmentation")
# the report phase holds card against CPU predictions on these windows
REPORT_CPU_WINDOWS = 512


class TrainLog:
    """Wraps ``api.train`` (which ``sweep.run_sweep`` calls through the
    module) to log, per run, its variant, wall, kernel launches and the
    ``FitLog`` entries of its fits."""

    def __init__(self, fits: FitLog):
        self.runs = []
        self.fits = fits
        self.real = api.train

    def __call__(self, model, cell_line, task, **kw):
        first, launches0 = len(self.fits.fits), fused_launches()
        t0 = time.perf_counter()
        scores = self.real(model, cell_line, task, **kw)
        wall = time.perf_counter() - t0
        fits = self.fits.fits[first:]
        windows = sum(f["windows"] for f in fits)
        self.runs.append({"variant": kw.get("model_label") or model,
                          "wall_s": wall,
                          "launches": fused_launches() - launches0,
                          "fit_launches": [f["launches"] for f in fits],
                          "train_windows": windows,
                          "train_windows_per_s": windows / wall})
        return scores


def finite_scores(entry):
    values = (entry["final_test_AUPRC_scores"] + entry["final_train_AUPRC_scores"]
              + [entry["average_CV_AUPRC"]])
    for key, it in entry.items():
        if key.startswith("iteration_n_"):
            values += it["AUPRC_train"] + it["AUPRC_test"] + [
                v for f1 in it["F1_precision_recall"] for v in f1]
    return bool(values) and all(math.isfinite(v) for v in values)


def sweep_phase(workdir):
    """``sweep.run_sweep`` on the card: HEPG2, one task, the five default
    models, 2 folds x 2 TPE trials x 1 epoch; at 5 % positives the FFNN
    smote-vs-double contest runs."""
    from embracenet_tpu_torch import sweep

    data = make_data(SWEEP_WINDOWS, IN_FEATURES, np.random.default_rng(0),
                     prevalence=CV_PREVALENCE)
    ckdir = os.path.join(workdir, "sweep_models")
    results_path = os.path.join(workdir, "sweep_results.json")
    fits = FitLog()
    runs = TrainLog(fits)
    engine.fit, api.train = fits, runs
    try:
        reset_counters()
        t0 = time.perf_counter()
        results = sweep.run_sweep(
            data_fn=lambda cell, task: data, cells=[CV_CELL], tasks=[CV_TASK],
            models=sweep.DEFAULT_MODELS,
            cv_cfg=CVConfig(n_folds=2, n_trials=2, sampler="TPE"),
            train_cfg=TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=100),
            results_path=results_path,
            storage=os.path.join(workdir, "sweep.db"), checkpoint_dir=ckdir,
            verbose=False)
        wall = time.perf_counter() - t0
        launches = fused_launches()
    finally:
        engine.fit, api.train = fits.real, runs.real
    node = results.data[CV_CELL][CV_TASK]
    require(set(SWEEP_ENTRIES) <= set(node), f"sweep: entries {sorted(node)}")
    require(node.get("best_augmentation") == "double"
            and "baseline_AUPRC" in node,
            f"sweep: best_augmentation {node.get('best_augmentation')!r}, "
            f"baseline {node.get('baseline_AUPRC')}: the FFNN contest's "
            "winner was not recorded")
    require(node["FFNN"] in (node["FFNN_smote"], node["FFNN_double"]),
            "sweep: the FFNN entry is no copy of a variant's")
    for name in SWEEP_ENTRIES:
        require(finite_scores(node[name]), f"sweep: {name}'s scores not finite")
    require(ResultsDict(results_path).data == results.data,
            "sweep: the results JSON does not reload equal")
    canonical = [checkpoint_name(CV_CELL, "FFNN", CV_TASK, 0) + ".npz"] + [
        f"{CV_CELL}_{CV_TASK}_FFNN_fold{f}_result.npz" for f in (1, 2)]
    missing = [n for n in canonical if not os.path.exists(os.path.join(ckdir, n))]
    require(not missing, f"sweep: canonical FFNN copies missing: {missing}")
    variants = [r["variant"] for r in runs.runs]
    require(variants == ["FFNN_smote", "FFNN_double", "CNN",
                         "ConcatNetMultimodal", "EmbraceNetMultimodal",
                         "EmbraceNetMultimodal_augmentation"],
            f"sweep: variants {variants}")
    for r in runs.runs:
        embrace = r["variant"].startswith("EmbraceNet")
        require(r["fit_launches"] and all(
            (n > 0) == embrace for n in r["fit_launches"]),
            f"sweep: {r['variant']}'s fits launched {r['fit_launches']} kernels")
    return {"launches": launches, "wall_s": wall, "windows": SWEEP_WINDOWS,
            "positives": int(data["y"].sum()), "variants": runs.runs,
            "best_augmentation": node["best_augmentation"],
            "winner": "double" if node["FFNN"] == node["FFNN_double"] else "smote",
            "average_CV_AUPRC": {n: node[n]["average_CV_AUPRC"]
                                 for n in SWEEP_ENTRIES},
            "baseline_AUPRC": node["baseline_AUPRC"]}, {
        "results": results.data, "checkpoint_dir": ckdir, "data": data}


def report_phase(sweep_out, workdir):
    """``visual.report`` over the sweep's output: the tables against the
    results, the pooled comparison, and ``CompareModelsResult`` on the card
    over the four default families' fold-best checkpoints inside a
    ``profiling.device_trace``."""
    import glob
    import pickle

    from embracenet_tpu_torch.models.reload import ReloadedModel
    from embracenet_tpu_torch.utils import profiling
    from embracenet_tpu_torch.visual import report

    results, data = sweep_out["results"], sweep_out["data"]
    node = results[CV_CELL][CV_TASK]
    avg = report.get_average_auprc_df(results, CV_CELL, tasks=[CV_TASK])[CV_TASK]
    std = report.get_standard_dev_df(results, CV_CELL, tasks=[CV_TASK])[CV_TASK]
    for m in report.DEFAULT_MODELS:
        require(avg[m] == node[m]["average_CV_AUPRC"]
                and std[m] == float(np.std(node[m]["final_test_AUPRC_scores"])),
                f"report: {m}'s table cells differ from the results")
    overall = report.compare_model_overall_performance(
        results, tasks=[CV_TASK], cells=[CV_CELL])
    require(all(math.isfinite(r["two_sided_p"]) and math.isfinite(r["greater_p"])
                for r in overall.values()), f"report: overall {overall}")

    models = ("FFNN", "CNN", "ConcatNetMultimodal", "EmbraceNetMultimodal")
    cmp = report.CompareModelsResult(sweep_out["checkpoint_dir"], n_folds=1)
    trace_dir = os.path.join(workdir, "trace")
    reset_counters()
    t0 = time.perf_counter()
    with profiling.device_trace(trace_dir) as prof:
        with profiling.annotate("compare_models"):
            res = cmp({CV_CELL: data}, CV_TASK, models=models)
    wall = time.perf_counter() - t0
    launches = fused_launches()
    require(launches > 0, "report: CompareModelsResult launched no kernel")
    # the same comparison again without the profiler: the trace's cost
    t0 = time.perf_counter()
    again = cmp({CV_CELL: data}, CV_TASK, models=models)
    untraced_wall = time.perf_counter() - t0
    pairs = res[CV_CELL]
    require(len(pairs) == 6 and all(
        len(r["pvalues"]) == 1 and all(0 <= p <= 1 for p in r["pvalues"])
        and isinstance(r["different"], bool) for r in pairs.values()),
        f"report: pairs {pairs}")
    traces = glob.glob(os.path.join(trace_dir, "*.json"))
    require(len(traces) == 1, f"report: trace files {traces}")
    with open(traces[0]) as fh:
        trace = fh.read()
    require("embrace_fused_fwd_kernel" in trace and "compare_models" in trace,
            "report: the trace names no embrace_fused_fwd_kernel or no "
            "compare_models span")
    kernel_us = sum(getattr(e, "device_time_total", 0)
                    for e in prof.key_averages()
                    if "embrace_fused_fwd_kernel" in e.key)

    # the three families without a kernel: card against CPU predictions
    sub = {k: v[:REPORT_CPU_WINDOWS] for k, v in data.items()}
    cpu_cmp = report.CompareModelsResult(sweep_out["checkpoint_dir"],
                                         n_folds=1, device="cpu")
    batch = ReloadedModel.BATCH
    ReloadedModel.BATCH = REPORT_CPU_WINDOWS     # no padding to 4096 rows
    try:
        errs = {m: float(np.abs(cmp._predictions(CV_CELL, m, CV_TASK, 0, sub)
                                - cpu_cmp._predictions(CV_CELL, m, CV_TASK, 0,
                                                       sub)).max())
                for m in models[:3]}
    finally:
        ReloadedModel.BATCH = batch
    require(all(e <= 1e-4 for e in errs.values()),
            f"report: card predictions off the CPU's: {errs}")

    path = cmp.save_pval_dict(res, CV_TASK, out_dir=workdir)
    with open(path, "rb") as fh:
        loaded = pickle.load(fh)
    require(set(loaded) == {CV_TASK} and set(loaded[CV_TASK]) == {CV_CELL}
            and set(loaded[CV_TASK][CV_CELL]) == {"1"}
            and all(loaded[CV_TASK][CV_CELL]["1"][a][b]
                    == loaded[CV_TASK][CV_CELL]["1"][b][a] == r["pvalues"][0]
                    for (a, b), r in pairs.items()),
            "report: save_pval_dict does not round-trip")
    return {"launches": launches, "compare_wall_s": wall,
            "compare_untraced_wall_s": untraced_wall,
            "repeat_equal": again == res,
            "trace_mbytes": len(trace) / 1e6,
            "fused_kernel_trace_ms": kernel_us / 1e3,
            "pvalues": {f"{a}|{b}": r["pvalues"][0] for (a, b), r in pairs.items()},
            "different": {f"{a}|{b}": r["different"] for (a, b), r in pairs.items()},
            "overall": overall, "card_vs_cpu_max_abs": errs}


def cli_phase(workdir, pipe):
    """``python -m embracenet_tpu_torch`` in the data phase's raw tree and
    cache: each subcommand in-process (so the launch counter sees them),
    then ``preprocess`` and the quickstart as subprocesses."""
    import contextlib
    import io
    import subprocess

    from embracenet_tpu_torch.__main__ import main as cli

    root, cache = os.path.join(workdir, "data"), os.path.join(workdir, "cache")
    where = ["--root", root, "--cache-dir", cache]
    walls, launches = {}, {}

    def run(name, argv):
        out = io.StringIO()
        reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli(argv)
        walls[name] = time.perf_counter() - t0
        launches[name] = fused_launches()
        require(rc == 0, f"cli: {name} returned {rc}")
        return out.getvalue()

    def last_json(text):
        lines = text.splitlines()
        return json.loads("\n".join(lines[max(i for i, line in enumerate(lines)
                                               if line == "{"):]))

    info = json.loads(run("preprocess", ["preprocess", "--task", DATA_TASK,
                                         *where]))
    want = {c: {"rows": int(len(pipe.labels[c])),
                "features": int(pipe.features[c].shape[1])} for c in pipe.cells()}
    require(info == want, f"cli: preprocess printed {info}, expected {want}")

    results = os.path.join(workdir, "cli_results.json")
    ckdir = os.path.join(workdir, "cli_models")
    store = ["--results", results, "--storage", os.path.join(workdir, "cli.db"),
             "--checkpoint-dir", ckdir]
    log = FitLog()
    engine.fit = log
    try:
        scores = last_json(run("train", [
            "train", "--model", CV_MODEL, "--cell", CV_CELL, "--task",
            DATA_TASK, *where, "--epochs", "1", "--folds", "2", "--trials",
            "2", *store]))
    finally:
        engine.fit = log.real
    require(math.isfinite(scores["average_CV_AUPRC"]) and launches["train"] > 0,
            f"cli: train {scores}, {launches['train']} launches")
    ev = json.loads(run("evaluate", [
        "evaluate", "--task", DATA_TASK, *where, "--cell", CV_CELL,
        "--checkpoint", os.path.join(ckdir, checkpoint_name(
            CV_CELL, CV_MODEL, DATA_TASK, 0))]))
    require(set(ev) >= {"AUPRC", "AUROC", "F1", "accuracy"}
            and all(math.isfinite(v) for v in ev.values())
            and launches["evaluate"] > 0, f"cli: evaluate {ev}")
    sweep_results = os.path.join(workdir, "cli_sweep_results.json")
    out = run("sweep", [
        "sweep", *where, "--cells", CV_CELL, "--tasks", DATA_TASK,
        "--models", "FFNN", "CNN", "--epochs", "1", "--folds", "2",
        "--trials", "1", "--results", sweep_results, "--storage",
        os.path.join(workdir, "cli_sweep.db"), "--checkpoint-dir",
        os.path.join(workdir, "cli_sweep_models")])
    require(out.strip().endswith(f"results written to {sweep_results}"),
            f"cli: sweep printed {out[-200:]!r}")
    swept = ResultsDict(sweep_results).get(CV_CELL, DATA_TASK)
    require(all(finite_scores(swept[m]) for m in ("FFNN", "CNN")),
            f"cli: sweep entries {sorted(swept)}")
    table = run("parity", ["parity", "--results", results, "--baseline",
                           os.path.join(REPO, "BASELINE.md")]).splitlines()
    rows = [line.split() for line in table[1:]
            if line.split()[:2] == [CV_CELL, DATA_TASK]]
    require(table[0].split() == ["cell", "task", "model", "ours", "reference",
                                 "delta", "within_tolerance"]
            and [r[2] for r in rows] == ["FFNN", "CNN", "ConcatNet",
                                         "EmbraceNet", "EmbraceNet_augm"]
            and float(rows[3][3]) == float(format(scores["average_CV_AUPRC"],
                                                  ".6g")),
            f"cli: parity rows {rows}")

    # -- the module and the quickstart as programs of their own --
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "embracenet_tpu_torch",
                           "preprocess", "--task", DATA_TASK, *where],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    walls["preprocess_subprocess"] = time.perf_counter() - t0
    require(proc.returncode == 0 and json.loads(proc.stdout) == want,
            f"cli: python -m embracenet_tpu_torch preprocess exited "
            f"{proc.returncode}: {proc.stderr[-2000:]}")
    with tempfile.TemporaryDirectory(dir=workdir) as qs:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.join(
            REPO, "examples", "torch_quickstart.py"), "--epochs", "1",
            "--root", os.path.join(qs, "demo_data")],
            capture_output=True, text=True, env=env, cwd=qs, timeout=600)
        walls["quickstart_subprocess"] = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli: the quickstart exited "
            f"{proc.returncode}: {proc.stderr[-2000:]}")
    return {"launches": sum(launches.values()), "walls_s": walls,
            "launches_by_command": launches,
            "train_average_CV_AUPRC": scores["average_CV_AUPRC"],
            "evaluate": ev, "parity_rows": rows,
            "quickstart_tail": proc.stdout.splitlines()[-7:]}

# the mesh phase: the widest EmbraceNet twice, on 2,000 windows, 1 epoch
MESH_WINDOWS, MESH_TRAIN = 2000, 1600
# seconds before the mesh phase's two-process world is killed
MESH_TIMEOUT = 240.0


def mesh_population():
    """The mesh phase's fit: two trials of the widest EmbraceNetMultimodal
    (dropout 0.1 in every block, selection probability 0.5, Adam lr 1e-3;
    each its own init and step seeds) on ``make_data``'s windows, float32,
    batch 100, 1 epoch."""
    data = make_data(MESH_WINDOWS, IN_FEATURES, np.random.default_rng(0))
    train = {k: v[:MESH_TRAIN] for k, v in data.items()}
    test = {k: v[MESH_TRAIN:] for k, v in data.items()}
    flat = widest_flat_params(0.5)
    for key in list(flat):
        if "_n_units_l" in key or "out_channels_l" in key:
            flat[key.replace("n_units_l", "dropout_l").replace(
                "out_channels_l", "dropout_l")] = 0.1
    hp = space.params_to_hp("EmbraceNetMultimodal", flat)
    opt = space.optimizer_hp(flat)
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=IN_FEATURES)
    return (spec, [hp, hp], [opt, opt], train, test,
            TrainConfig(num_epochs=1, epoch_chunk=1, batch_size=100))


def fit_history(res):
    return {"loss": res.loss_train, "auprc_train": res.auprc_train,
            "auprc_test": res.auprc_test, "epochs": res.epochs_run}


def fit_distance(got, want):
    """Max |got - want| of every epoch's train and test AUPRC and the
    largest relative difference of a train loss, over trials."""
    def gap(key):
        return float(np.abs(np.asarray(got[key]) - np.asarray(want[key])).max())
    return {"auprc_train": gap("auprc_train"), "auprc_test": gap("auprc_test"),
            "loss_rel": float((np.abs(np.asarray(got["loss"])
                                      - np.asarray(want["loss"]))
                               / np.abs(np.asarray(want["loss"]))).max())}


def param_diff(res, ref):
    """Max |res - ref| over every param and BatchNorm leaf (``ref``: the
    checkpoint trees of the meshless fit), max |ref| of the params, and
    whether every leaf is equal bit for bit."""
    got = tree_leaves(tree_to_numpy({"params": res.params,
                                     "bn_state": res.bn_state}))
    want = tree_leaves(ref)
    diffs = [float(np.abs(g.astype(np.float64) - w).max()) for g, w in zip(got, want)]
    return {"max_abs": max(diffs),
            "max_p": max(float(np.abs(w).max()) for w in tree_leaves(ref["params"])),
            "equal": all(np.array_equal(g, w) for g, w in zip(got, want))}


def population_init(spec, hps, cfg):
    """The init ``engine.fit`` draws for the population (its
    ``seed_streams``), stacked over trials."""
    return engine.host_init(spec, hps,
                            engine.seed_streams(cfg.seed, len(hps))[0])


def adam_first_step_excess(new_s, new_w, params, g_s, g_w, lr, wd):
    """How far the sharded step's new params stray past what Adam's first
    step allows, given the two steps' gradients (``g_s``, ``g_w``; None
    for a leaf without one): the step moves each weight by
    ``lr * g / (|g| + eps)`` of its coupled gradient ``g + wd * p``, which
    moves by at most ``|dg| / (min |g| + eps)`` (and never by more than 2),
    plus float32 rounding.  Returns the largest excess over that bound
    (<= 0 when the update is right) and the largest |new_s - new_w|
    relative to max |p|."""
    eps, excess, gap, top = 1e-8, -math.inf, 0.0, 0.0
    for a, b, p, gs, gw in zip(new_s, new_w, params, g_s, g_w):
        p = p.float()
        gs = wd * p if gs is None else gs.float() + wd * p
        gw = wd * p if gw is None else gw.float() + wd * p
        bound = lr * torch.clamp((gs - gw).abs()
                                 / (torch.minimum(gs.abs(), gw.abs()) + eps),
                                 max=2.0) + 1e-6 * (lr + p.abs())
        d = (a.float() - b.float()).abs()
        excess = max(excess, float((d - bound).max()))
        gap, top = max(gap, float(d.max())), max(top, float(p.abs().max()))
    return excess, gap / top


def sharded_step(spec, hps, opts, train, cfg, mesh):
    """Trial 0's first train step at full width, on this rank's half of the
    first balanced batch (``BatchShard``) and on the whole batch, from the
    fit's own init: the loss, the logits of this rank's rows, every
    gradient (taken where ``optim.apply_update`` receives them), the new
    BatchNorm running statistics and the new params (held to what Adam's
    first step makes of the gradients' rounding,
    :func:`adam_first_step_excess`)."""
    from embracenet_tpu_torch.ops import optim
    from embracenet_tpu_torch.parallel.mesh import BatchShard

    dev = mesh.device
    params, bn = (tree_map(lambda a: a[0].to(dev), t)
                  for t in population_init(spec, hps, cfg))
    opt_state = optim.init_state(params)
    require(int(opts[0]["optimizer"]) == optim.ADAM,
            "mesh: the sharded step's bound is Adam's")
    opt_hp = {k: torch.tensor(opts[0][k], device=dev)
              for k in ("optimizer", "lr", "weight_decay")}
    plan = balanced_plan(train["y"], cfg.batch_size, seed=123)
    bw = plan.idx.shape[1]
    per, k = -(-bw // 2), mesh.coords["data"]
    idx = torch.zeros(2 * per, dtype=torch.long, device=dev)
    mask = torch.zeros(2 * per, device=dev)
    idx[:bw] = torch.as_tensor(plan.idx[0], device=dev)
    mask[:bw] = torch.as_tensor(plan.mask[0], device=dev)
    data = engine._device_data(train, spec, dev)
    statics = engine._resolve_statics(spec, hps, cfg)
    grads, real = [], engine.optim.apply_update

    def capture(p, g, *args):
        grads.append(tree_leaves(g))
        return real(p, g, *args)

    engine.optim.apply_update = capture
    try:
        whole = engine.train_step(spec, params, bn, opt_state, hps[0], opt_hp,
                                  *engine._gather(data, idx[:bw], spec),
                                  mask[:bw], 12345, None, statics)
        cols = slice(k * per, (k + 1) * per)
        shard = engine.train_step(spec, params, bn, opt_state, hps[0], opt_hp,
                                  *engine._gather(data, idx[cols], spec),
                                  mask[cols], 12345, None, statics,
                                  BatchShard(k * per, bw, 2, mesh.group("data")))
    finally:
        engine.optim.apply_update = real
    n = min(bw, (k + 1) * per) - k * per
    logits = whole[1][k * per:k * per + n]
    have = [(a, b) for a, b in zip(grads[1], grads[0]) if b is not None]
    bn_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(tree_leaves(shard[3]), tree_leaves(whole[3])))
    excess, params_rel = adam_first_step_excess(
        tree_leaves(shard[2]), tree_leaves(whole[2]), tree_leaves(params),
        grads[1], grads[0], float(opts[0]["lr"]), float(opts[0]["weight_decay"]))
    return {"rows": [k * per, k * per + n],
            "loss_rel": abs(float(shard[0]) / float(whole[0]) - 1.0),
            "logits_max_abs": float((shard[1][:n] - logits).abs().max()),
            "logits_max": float(logits.abs().max()),
            "grad_max_abs": max(float((a - b).abs().max()) for a, b in have),
            "grad_max": max(float(b.abs().max()) for _, b in have),
            "bn_rel": bn_rel, "params_rel": params_rel,
            "params_excess_over_adam_bound": excess}


def same_value(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def shard_pair_case(first, second, dev):
    """Two data shards' first launches at one layout (``first`` at rows
    [0, r), ``second`` at [r, r + b) with ``row_base = r``, from the same
    step of the two ranks) against the kernel launched on their rows
    together: the replicas' weights, seed and mask equal bit for bit, the
    whole launch's ``choose`` the shards' bit for bit (each shard drew the
    whole batch's uniforms at its rows), its out theirs within the kernel
    phase's tolerance."""
    (k0, a), (k1, b) = first, second
    tol = 1e-4 if k0[4] == "float32" else 1e-2
    xa, xb = a["args"], b["args"]
    require(all(same_value(xa[i], xb[i]) for i in (2, 3, 4, 5, 7, 8)),
            f"mesh: the data replicas launched {k0} / {k1} with other "
            "weights, seed or mask")
    # rows are axis 1 of every [T, B, ...] operand
    whole = (torch.cat([xa[0], xb[0]], 1), torch.cat([xa[1], xb[1]], 1))
    out, ch = K.fused_embrace(*whole, *xa[2:6], torch.cat([xa[6], xb[6]], 1),
                              xa[7], xa[8])
    require(torch.equal(ch, torch.cat([a["choose"], b["choose"]], 1)),
            f"mesh: shards {k0} / {k1} chose other than their rows of the "
            "whole batch's launch")
    want = torch.cat([a["out"], b["out"]], 1)
    torch.testing.assert_close(want, out, rtol=tol, atol=tol)
    return {"shape": [int(out.shape[1])] + list(k0[1:4]), "trials": k0[8],
            "dtype": k0[4],
            "shards": [[0, k0[0]], [k1[7], k1[7] + k1[0]]],
            "max_abs_err": float((want - out).abs().max())}


def mesh_checkpoint(res, mesh, workdir, ref):
    """Every rank of ``mesh`` saves the trial mesh's population trees
    (whole and equal on each rank, equal to the meshless fit's) with
    ``save_checkpoint_orbax(..., mesh=mesh)`` into one directory of
    ``workdir``, then loads it alone: its files, and whether the load
    equals ``ref`` (the npz checkpoint of the meshless fit) bit for bit."""
    path = os.path.join(workdir, "population_dcp")
    t0 = time.perf_counter()
    save_checkpoint_orbax(path, {"params": res.params, "bn_state": res.bn_state},
                          {"model": "EmbraceNetMultimodal"}, mesh=mesh)
    t1 = time.perf_counter()
    got, meta = load_checkpoint_orbax(path)
    return {"files": sorted(os.listdir(path + ".orbax")),
            "equal": same_trees(got, ref) and meta == {"model": "EmbraceNetMultimodal"},
            "save_s": t1 - t0, "load_s": time.perf_counter() - t1}


def mesh_worker(workdir) -> int:
    """One of the mesh phase's two ranks (``chip_smoke.py --mesh-worker
    DIR``, started by :func:`mesh_phase`): gloo on this card, a 2 x 1
    trial mesh, then a 1 x 2 data mesh, each fit compared with the meshless
    fit's checkpoint in ``DIR``, and the data mesh's first train step
    (:func:`sharded_step`); writes ``DIR/mesh_rank{r}.json``, and the
    first inputs and outputs of each kernel layout it launched
    (:class:`ShapeLog`) to ``DIR/mesh_shapes_rank{r}.pt``.  An untimed
    trial-mesh fit warms the process up first.  The kernel's launches and
    the rows it was launched at are counted in each fit; every all-reduce
    is timed on the host after the card has caught up (a synchronise
    before it), so its share of a step is the collectives' alone."""
    import torch.distributed as dist

    init_distributed(backend="gloo")
    rank = dist.get_rank()
    spec, hps, opts, train, test, cfg = mesh_population()
    ref, _ = load_checkpoint(os.path.join(workdir, "ref"))
    bases, reduce_s = set(), [0.0, 0]
    shapes, real_all_reduce = ShapeLog(), dist.all_reduce

    def fused(*args, row_base=0):
        bases.add(int(row_base))
        return shapes(*args, row_base=row_base)

    def all_reduce(tensor, *args, **kw):
        if tensor.is_cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        work = real_all_reduce(tensor, *args, **kw)
        reduce_s[0] += time.perf_counter() - t
        reduce_s[1] += 1
        return work

    K.fused_embrace, dist.all_reduce = fused, all_reduce
    out = {"rank": rank}
    for name, shape in (("trial_2x1", (2, 1)), ("data_1x2", (1, 2))):
        mesh = make_mesh(*shape)
        if name == "trial_2x1":
            # warm-up: this process' first fit loads the kernels and the
            # cuDNN / cuBLAS handles that the meshless fit found loaded
            engine.fit(spec, hps, opts, train, test, cfg, mesh=mesh)
        else:
            out["data_step"] = sharded_step(spec, hps, opts, train, cfg, mesh)
        reduce_s[:] = [0.0, 0]
        reset_counters()
        bases.clear()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = engine.fit(spec, hps, opts, train, test, cfg, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {"wall_s": wall, "launches": fused_launches(),
                     "init_launches": fused_launches("mt19937.launches"),
                     "update_launches": fused_launches("optim.launches"),
                     "train_steps": fused_launches("engine.train_steps"),
                     "row_bases": sorted(bases), "allreduce_s": reduce_s[0],
                     "allreduce_calls": reduce_s[1], "device": str(mesh.device),
                     "coords": mesh.coords, "hist": fit_history(res),
                     "params": param_diff(res, ref)}
        if name == "trial_2x1":
            out["checkpoint"] = mesh_checkpoint(res, mesh, workdir, ref)
    with open(os.path.join(workdir, f"mesh_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    torch.save(shapes.seen, os.path.join(workdir, f"mesh_shapes_rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def mesh_phase(workdir):
    """Multi-device training on the one card: the meshless fit of
    :func:`mesh_population`; the same fit on a 1 x 1 mesh through
    ``init_distributed`` with NCCL (world of 1), bit for bit; then two
    processes on the card with gloo (:func:`mesh_worker`): the 2 x 1 trial
    mesh bit for bit, and the 1 x 2 data mesh (each rank half of every
    batch): its first train step at full width against the whole batch's
    (loss within 1e-5 relative, logits within 1e-4 x max|logit|, every
    gradient within 1e-4 x max|gradient|, the new BatchNorm running
    statistics within 1e-5 relative, the new params within what Adam's
    first step makes of the gradients' rounding), its epoch reported beside the
    meshless fit's own distance under a 1-ulp change of its init (the
    yardstick of how far rounding carries an epoch of Adam) and held to
    finite values, equal epochs and a loss within 1 %.  Every fit launches
    the kernel once per forward pass, the data mesh's in both shards at
    their first rows (0; 48 of a 95-row train batch, 100 of a 200-row eval
    batch).  Aggregate train windows/s of the trial mesh against the
    meshless fit; ms per train step of the data mesh and its all-reduces'
    share."""
    import torch.distributed as dist

    spec, hps, opts, train, test, cfg = mesh_population()
    n_tr, w_tr = balanced_plan(train["y"], cfg.batch_size, seed=123).idx.shape
    n_ev, w_ev = eval_plan(len(test["y"]), 2 * cfg.batch_size, seed=123).idx.shape
    # forward passes of a population, whatever its number of trials
    per_trial = cfg.num_epochs * (n_tr + n_ev)
    windows = len(hps) * cfg.num_epochs * len(train["y"])

    def timed_fit(mesh=None, init=(None, None)):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.fit(spec, hps, opts, train, test, cfg, mesh=mesh,
                         init_params=init[0], init_bn_state=init[1])
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, fused_launches()

    ref, ref_wall, ref_launches = timed_fit()
    require(ref_launches == per_trial,
            f"mesh: meshless fit launched {ref_launches}, expected "
            f"{per_trial} (one per population forward pass)")
    save_checkpoint(os.path.join(workdir, "ref"),
                    {"params": ref.params, "bn_state": ref.bn_state})
    ref_trees, _ = load_checkpoint(os.path.join(workdir, "ref"))
    want = fit_history(ref)
    # the yardstick of the data mesh's fit: the meshless fit from its own
    # init moved by one ulp (every weight to the next float32 up)
    init_p, init_bn = population_init(spec, hps, cfg)
    ulp, _, _ = timed_fit(init=(tree_map(
        lambda a: torch.nextafter(a, torch.full_like(a, math.inf)), init_p),
        init_bn))
    ulp_diff = dict(fit_distance(fit_history(ulp), want),
                    params=param_diff(ulp, ref_trees)["max_abs"])
    del ulp

    # (a) a 1 x 1 mesh through init_distributed, NCCL, a world of one
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        require(dist.get_backend() == "nccl", "mesh: the card's default "
                f"backend is {dist.get_backend()}, not nccl")
        one, one_wall, one_launches = timed_fit(make_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    one_diff = param_diff(one, ref_trees)
    require(fit_history(one) == want and one_diff["equal"],
            f"mesh: the 1 x 1 NCCL mesh differs from the meshless fit "
            f"({one_diff})")
    require(one_launches == ref_launches, "mesh: the 1 x 1 mesh launched "
            f"{one_launches} kernels, the meshless fit {ref_launches}")
    del one, ref
    torch.cuda.empty_cache()

    # (b) two processes on this card, gloo: the trial mesh, the data mesh
    t0 = time.perf_counter()
    launch_local([os.path.abspath(__file__), "--mesh-worker", workdir], 2,
                 MESH_TIMEOUT)
    world_wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"mesh_rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    # each rank's kernel layouts, in the data mesh's shard order
    records = [torch.load(os.path.join(workdir, f"mesh_shapes_rank{r['rank']}.pt"),
                          map_location="cuda", weights_only=False)
               for r in sorted(ranks, key=lambda r: r["data_1x2"]["coords"]["data"])]
    for r in ranks:
        trial, data = r["trial_2x1"], r["data_1x2"]
        require(trial["hist"] == want and trial["params"]["equal"],
                f"mesh: rank {r['rank']}'s 2 x 1 trial mesh differs from the "
                f"meshless fit ({trial['params']})")
        require(trial["init_launches"] == data["init_launches"] == 1,
                f"mesh: rank {r['rank']} launched the MT19937 kernel "
                f"{trial['init_launches']} and {data['init_launches']} times "
                "in its two fits, expected once a fit")
        for fit in (trial, data):
            require(fit["update_launches"] == fit["train_steps"] > 0,
                    f"mesh: rank {r['rank']} launched the fused optimizer "
                    f"update {fit['update_launches']} times in "
                    f"{fit['train_steps']} train steps")
        require(trial["launches"] == per_trial and trial["row_bases"] == [0],
                f"mesh: rank {r['rank']} of the trial mesh launched "
                f"{trial['launches']} at rows {trial['row_bases']}, expected "
                f"{per_trial} at 0")
        ck = r["checkpoint"]
        require(ck["files"] == [".metadata", "__0_0.distcp", "__1_0.distcp"]
                and ck["equal"],
                f"mesh: rank {r['rank']}'s DCP checkpoint of the trial mesh "
                f"holds {ck['files']} and loads equal: {ck['equal']}")
        # one sharded step at full width: the data axis' sums agree with
        # the whole batch's to float32 rounding
        st = r["data_step"]
        require(st["loss_rel"] <= 1e-5
                and st["logits_max_abs"] <= 1e-4 * st["logits_max"]
                and st["grad_max_abs"] <= 1e-4 * st["grad_max"]
                and st["bn_rel"] <= 1e-5
                and st["params_excess_over_adam_bound"] <= 0.0,
                f"mesh: rank {r['rank']}'s sharded step differs from the "
                f"whole batch's: {st}")
        # the fit: an epoch of Adam carries that rounding as far as a
        # 1-ulp change of the init carries the meshless fit (measured
        # beside it), so it is held only to finite, equal epochs and a
        # loss within 1 %
        d = fit_distance(data["hist"], want)
        require(data["hist"]["epochs"] == want["epochs"]
                and all(math.isfinite(v) for v in sum(
                    (sum(data["hist"][k_], []) for k_ in
                     ("loss", "auprc_train", "auprc_test")), []))
                and d["loss_rel"] <= 1e-2,
                f"mesh: rank {r['rank']}'s data mesh fit {d} (a 1-ulp init "
                f"change: {ulp_diff})")
        # each shard's first row of a train batch and of an eval batch
        k = data["coords"]["data"]
        want_bases = sorted({k * -(-w // 2) for w in (w_tr, w_ev)})
        require(data["launches"] == per_trial
                and data["row_bases"] == want_bases,
                f"mesh: rank {r['rank']} of the data mesh launched "
                f"{data['launches']} at rows {data['row_bases']}, expected "
                f"{per_trial} at {want_bases}")
    trial_wall = max(r["trial_2x1"]["wall_s"] for r in ranks)
    data_wall = max(r["data_1x2"]["wall_s"] for r in ranks)
    steps = cfg.num_epochs * n_tr                   # stacked steps
    return {"launches": ref_launches + one_launches
            + sum(r[m]["launches"] for r in ranks for m in ("trial_2x1", "data_1x2")),
            "init_launches": sum(r[m]["init_launches"] for r in ranks
                                 for m in ("trial_2x1", "data_1x2")),
            "init_card_fits": 2 * len(ranks),
            "update_launches": sum(r[m]["update_launches"] for r in ranks
                                   for m in ("trial_2x1", "data_1x2")),
            "plan_widths": [w_tr, w_ev],
            "windows": windows, "train_steps_per_trial": n_tr,
            "eval_batches_per_trial": n_ev,
            "meshless": {"wall_s": ref_wall, "launches": ref_launches,
                         "train_windows_per_s": windows / ref_wall},
            "nccl_1x1": {"wall_s": one_wall, "launches": one_launches,
                         "train_windows_per_s": windows / one_wall},
            "gloo_world_wall_s": world_wall,
            "trial_2x1": {"wall_s": trial_wall,
                          "aggregate_train_windows_per_s": windows / trial_wall,
                          "vs_meshless": ref_wall / trial_wall,
                          "launches_per_rank": [r["trial_2x1"]["launches"]
                                                for r in ranks]},
            "data_1x2": {"wall_s": data_wall,
                         "train_windows_per_s": windows / data_wall,
                         "ms_per_train_step": 1e3 * data_wall / steps,
                         "allreduce_calls_per_step": [
                             r["data_1x2"]["allreduce_calls"] / steps
                             for r in ranks],
                         "allreduce_s_per_rank": [r["data_1x2"]["allreduce_s"]
                                                  for r in ranks],
                         "allreduce_calls_per_rank": [
                             r["data_1x2"]["allreduce_calls"] for r in ranks],
                         "allreduce_share": max(r["data_1x2"]["allreduce_s"]
                                                for r in ranks) / data_wall,
                         "launches_per_rank": [r["data_1x2"]["launches"]
                                               for r in ranks],
                         "row_bases_per_rank": [r["data_1x2"]["row_bases"]
                                                for r in ranks],
                         "step": [r["data_step"] for r in ranks],
                         "fit_vs_meshless": dict(
                             fit_distance(ranks[0]["data_1x2"]["hist"], want),
                             params=ranks[0]["data_1x2"]["params"]["max_abs"]),
                         "max_p": ranks[0]["data_1x2"]["params"]["max_p"]},
            "ulp_init_vs_meshless": ulp_diff,
            "checkpoint_per_rank": [r["checkpoint"] for r in ranks]}, records


def mesh_shard_cases(records, widths, dev):
    """The kernel at every layout the two ranks gave it
    (:func:`path_case`), and each pair of data shards held against the
    launch on their rows together (:func:`shard_pair_case`): one pair for
    each plan width the data mesh split (a train and an eval batch)."""
    cases = [path_case(key, rec, dev) for recs in records
             for key, rec in recs.items()]
    first, second = records
    pairs = [shard_pair_case(((k1[7],) + k1[1:7] + (0,) + k1[8:],
                              first[(k1[7],) + k1[1:7] + (0,) + k1[8:]]),
                             (k1, b), dev)
             for k1, b in second.items() if k1[7] != 0]
    # a plan row is padded with masked columns to a multiple of the 2 shards
    padded = {2 * -(-w // 2) for w in widths}
    require({p["shape"][0] for p in pairs} == padded,
            f"mesh: shard pairs at widths {[p['shape'][0] for p in pairs]}, "
            f"the plans split {sorted(padded)}")
    return cases, pairs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke test "
              "needs one card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = nvidia_smi()
    print(card, flush=True)
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)

    walls, clock = {}, [time.perf_counter()]

    def lap(phase):
        """Record the wall since the last lap as ``phase``'s."""
        now = time.perf_counter()
        walls[phase] = now - clock[0]
        clock[0] = now

    for source, load in ((K.SOURCE, K._load), (mt19937.SOURCE, mt19937._load),
                         (optim.SOURCE, optim._load)):
        t0 = time.perf_counter()
        built = K.build(source)
        load()
        print(json.dumps({"source": source.name,
                          "build_s": time.perf_counter() - t0,
                          "nvcc_s": built.seconds}), flush=True)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas ({source.name}):", line.strip(), flush=True)
    lap("build")

    gen = torch.Generator(device=dev).manual_seed(0)
    cases, fulle_cases = [], []
    for shape in SHAPES + BENCH + EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            case = kernel_case(shape, dtype, dev, gen)
            cases.append(case)
            print(json.dumps({"kernel_case": case, "card": card}), flush=True)
    lap("kernel")
    for shape in SHAPES + BENCH + EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            case = fulle_case(shape, dtype, dev, gen)
            fulle_cases.append(case)
            print(json.dumps({"kernel_fulle_case": case, "card": card}), flush=True)
    lap("kernel_fulle")
    row_cases = [row_base_case(kernel, shape, dtype, dev, gen)
                 for kernel in ("fused_embrace", "fused_embrace_fulle")
                 for shape in (TRAIN, EVAL)
                 for dtype in (torch.float32, torch.bfloat16)]
    print(json.dumps({"row_base_cases": row_cases, "card": card}), flush=True)
    lap("row_base")
    # the trial axis: T trials in one launch of each kernel
    trial_cases = [trial_case(n, shape, dtype, dev, gen,
                              timed=(n == 8 and shape is TRAIN))
                   for n in TRIALS for shape in (TRAIN, EVAL)
                   for dtype in (torch.float32, torch.bfloat16)]
    print(json.dumps({"trial_cases": trial_cases, "card": card}), flush=True)
    lap("trials")
    for shape in (MAIN, TRAIN):
        grads = grad_phase(shape, dev, gen)
        print(json.dumps({"gradient": grads, "card": card}), flush=True)
    lap("gradient")
    # the MT19937 kernel: the pop8 population and CNN_LSTM's longest stream
    draws = init_draws.run(dev, seed=0, reps=1, byarch=(1,))
    require(all(c["equal"] for c in draws), "init draws: the card drew "
            "other numbers than the CPU generators")
    # a warm-up and a timed rep, each the kernel alone and init_population,
    # and one profiled call
    require(all(c["launches"] == 5 for c in draws),
            "init draws: the kernel was not launched once a call")
    print(json.dumps({"init_draws": draws, "card": card}), flush=True)
    lap("init_draws")
    # the fused optimizer update at the pop8 population, in its three types
    updates = optim_bench.run(dev, seed=0, reps=10)
    require(all(c["equal"] and c["inputs_unchanged"] for c in updates),
            "update: the kernel differs from the plain version or wrote into "
            "its inputs")
    require(all(c["launches"] == [1, 1, 1] for c in updates),
            "update: the kernel was not launched once a call")
    print(json.dumps({"optim_update": updates, "card": card}), flush=True)
    lap("optim_update")

    build_dir = os.path.join(REPO, "embracenet_tpu_torch", "_build")
    # every fit of the main-path phases, in this process (the mesh ranks
    # count their own): the init kernel once a card fit without init_params
    init_fits = InitDraws()
    engine.fit = init_fits
    phase_lap = lap

    def lap(phase):
        phase_lap(phase)
        init_fits.lap(phase)

    shapes = ShapeLog()
    K.fused_embrace = shapes
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
            serve = serve_phase(workdir)
        print(json.dumps({"serve": serve, "card": card}), flush=True)
        lap("serve")
        train = train_phase()
        print(json.dumps({"train": train, "card": card}), flush=True)
        lap("train")
    finally:
        K.fused_embrace = shapes.real
    bench_out = bench_phase()
    print(json.dumps({"bench": bench_out, "card": card}), flush=True)
    lap("bench")
    K.fused_embrace = shapes
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
            cv = cv_phase(workdir)
    finally:
        K.fused_embrace = shapes.real
    print(json.dumps({"cv": cv, "card": card}), flush=True)
    lap("cv")
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        for model in MODELS:
            out = model_phase(model, workdir)
            print(json.dumps({"models": out, "card": card}), flush=True)
            lap(f"models_{model}")
    K.fused_embrace = shapes
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as data_dir:
            data_out, pipe = data_phase(data_dir)
            print(json.dumps({"data": data_out, "card": card}), flush=True)
            lap("data")
            with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
                sweep_out, swept = sweep_phase(workdir)
                print(json.dumps({"sweep": sweep_out, "card": card}), flush=True)
                lap("sweep")
                report_out = report_phase(swept, workdir)
                print(json.dumps({"report": report_out, "card": card}),
                      flush=True)
                lap("report")
            cli_out = cli_phase(data_dir, pipe)
            print(json.dumps({"cli": cli_out, "card": card}), flush=True)
            lap("cli")
        with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
            mesh_out, mesh_records = mesh_phase(workdir)
        print(json.dumps({"mesh": mesh_out, "card": card}), flush=True)
        lap("mesh")
    finally:
        K.fused_embrace = shapes.real
    engine.fit = init_fits.real
    init_fits.phases["mesh"]["card_fits"] += mesh_out["init_card_fits"]
    init_fits.phases["mesh"]["launches"] += mesh_out["init_launches"]
    init_fits.update_launches += mesh_out["update_launches"]
    init_launches = sum(p["launches"] for p in init_fits.phases.values())
    init_card_fits = sum(p["card_fits"] for p in init_fits.phases.values())
    require(init_card_fits > 0 and init_launches == init_card_fits,
            f"init draws: {init_launches} MT19937 launches in the main-path "
            f"phases' {init_card_fits} card fits without init_params")
    print(json.dumps({"init_draws_main_path": init_fits.phases,
                      "card": card}), flush=True)

    # -- the kernel at every layout the serve, train, CV, data, sweep,
    # report, CLI and mesh phases gave it, the mesh workers' included --
    path_cases = [path_case(key, rec, dev) for key, rec in shapes.seen.items()]
    shapes.seen.clear()
    mesh_cases, pair_cases = mesh_shard_cases(mesh_records,
                                              mesh_out["plan_widths"], dev)
    del mesh_records
    print(json.dumps({"path_cases": path_cases, "mesh_path_cases": mesh_cases,
                      "mesh_shard_pairs": pair_cases, "card": card}), flush=True)
    lap("path_shapes")
    print(json.dumps({"phase_walls_s": walls, "card": card}), flush=True)

    def row(name, source_line, launches, cs):
        main_f32 = cs[0]
        ms_key = "device_ms" if name == "embrace_fused_fwd" else "fulle_device_ms"
        trial_axis = {c["dtype"]: {k: c[k] for k in (
            ms_key, "singles_device_ms", "batched_products_ms", "bound_ms",
            "bound_by", "plain_ms")} for c in trial_cases if "ms" in c}
        return {"name": name, "route": "cuda",
                "source": "embracenet_tpu_torch/csrc/embrace.cu",
                "replaces": f"embracenet_tpu/ops/pallas/embrace.py:{source_line}",
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in cs
                                   if c["dtype"] == "float32"),
                "ms": main_f32["ms"], "device_ms": main_f32["device_ms"],
                "plain_ms": main_f32["plain_ms"],
                "bound_ms": main_f32["bound_ms"], "bound_by": main_f32["bound_by"],
                "library_ms": main_f32["library_ms"],
                "trials_8_b100": trial_axis}

    def init_row(launches, cs):
        """The MT19937 kernel: its main-path launches; times of the pop8
        case (8 streams of 11.96 M words); plain_ms the host draw and stack
        it replaces; no library draws this generator on the card."""
        pop8 = cs[0]
        return {"name": "mt19937_uniform_init", "route": "cuda",
                "source": "embracenet_tpu_torch/csrc/mt19937.cu",
                "replaces": None, "launches": launches,
                "max_abs_err": 0.0 if all(c["equal"] for c in cs) else None,
                "ms": pop8["kernel_ms"], "device_ms": pop8["device_ms"],
                "plain_ms": pop8["plain_ms"], "bound_ms": pop8["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "words_per_s_per_stream": pop8["words_per_s_per_stream"]}

    def update_row(launches, cs):
        """The fused optimizer update: its main-path launches (one a train
        step of every card fit); times of the pop8 float32 case; plain_ms
        the PyTorch composite it replaces; no library call computes this
        update."""
        pop8 = cs[0]
        return {"name": "optim_update", "route": "cuda",
                "source": "embracenet_tpu_torch/csrc/optim_update.cu",
                "replaces": None, "launches": launches,
                "max_abs_err": 0.0 if all(c["equal"] for c in cs) else None,
                "ms": pop8["ms"], "device_ms": pop8["device_ms"],
                "plain_ms": pop8["plain_ms"], "bound_ms": pop8["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "roofline_pct": pop8["roofline_pct"]}

    require(init_fits.update_launches > 0, "update: no main-path fit "
            "launched the fused optimizer update")
    print(card, flush=True)
    print(json.dumps({"kernels": [
        row("embrace_fused_fwd", 39,
            serve["launches"] + train["launches"] + cv["launches"]
            + data_out["launches"] + sweep_out["launches"]
            + report_out["launches"] + cli_out["launches"]
            + mesh_out["launches"],
            cases + path_cases + mesh_cases + pair_cases + trial_cases),
        row("embrace_fused_fwd_fulle", 78, bench_out["launches_fulle"],
            fulle_cases + [{"dtype": c["dtype"],
                            "max_abs_err": c["fulle_max_abs_err"]}
                           for c in trial_cases]),
        init_row(init_launches, draws),
        update_row(init_fits.update_launches, updates)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2]))
    sys.exit(main())
