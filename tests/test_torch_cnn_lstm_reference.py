"""The port's CNN_LSTM against the benchmark's plain reference
(``benchmark/reference/cnn_lstm.py``: the recurrence as an explicit loop
over timesteps), the faults that reference must tell apart, the
benchmark driver's groups and seeds against ``run_search``'s, and the
recurrence's spans and counter.  CPU only, at small widths (4-8 channels,
hidden 8-16: 116-248 timesteps), no JAX.

Tolerances, float32 both sides, the sums taken in another order (ATen's
LSTM takes each gate product as one GEMM, the reference as two; the FC
layers' batched products):

* logits, loss and first gradients: 1e-4 of the largest element of the
  leaf (round-off is ~1e-6 of it), leaves whose gradient is under a
  thousandth of the median leaf's left out (a conv bias under BatchNorm,
  whose gradient is nought but round-off), as the cell leaves them out;
* a leaf's change over a fit's first three steps, as the cell compares it
  (``benchmark/core/checks.py``: the gap over the larger of the
  reference's change and the trial's median leaf's, leaves with a
  nought gradient left out): 2e-3.  The optimizers move an element by
  about lr whatever the size of its gradient, so the round-off of a near
  nought gradient moves its element by up to 2 lr a step; at lr 1e-3 the
  cases read at most 3.3e-4.
"""

import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.core.checks import EXCLUDE_BELOW, train_gaps, verdict
from benchmark.drivers import population_byarch as D
from benchmark.drivers.population import Capture
from benchmark.frozen import cnn_lstm as A
from benchmark.frozen.data import make_data
from benchmark.frozen.plans import balanced_plan
from benchmark.frozen.seeds import group_seed, seed_streams
from benchmark.reference import cnn_lstm as R
from benchmark.reference import multimodal as M
from benchmark.run import cell
from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.convert import tree_leaves
from embracenet_tpu_torch.hpo import search, space
from embracenet_tpu_torch.hpo.samplers import ReplaySampler
from embracenet_tpu_torch.models import cnn_lstm
from embracenet_tpu_torch.ops import optim
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.modelspec import get_spec
from embracenet_tpu_torch.utils import profiling

MODEL = "CNN_LSTM"
CELL = "cnn_lstm-hepg2.train-pop8-f32-byarch"
TOL = 1e-4
STEP_TOL = 2e-3
CFG = TrainConfig(num_epochs=1, batch_size=20, patience=2)


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    profiling.reset_counters()
    yield
    profiling.reset_counters()
    torch.set_num_threads(threads)


def _flat(blocks=1, layers=1, optimizer="Adam", **over):
    flat = {"n_layers": blocks, "out_channels_l0": 4, "kernel_size_l0": 5,
            "dropout_l0": 0.3, "out_channels_l1": 8, "kernel_size_l1": 11,
            "dropout_l1": 0.2, "LSTM_hidden_layer_size": 8,
            "LSTM_n_layers": layers, "optimizer": optimizer, "lr": 1e-3,
            "weight_decay": 1e-3}
    flat.update(over)
    return flat


def _split(n_train=80, n_test=40, seed=0):
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    data = {"cnn": rng.integers(0, 4, size=(n, 256), dtype=np.uint8),
            "y": (rng.random(n) < 0.3).astype(np.int64)}
    return ({k: v[:n_train] for k, v in data.items()},
            {k: v[n_train:] for k, v in data.items()})


def _port_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def close(got, want, tol=TOL):
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


def _watched_fit(flat, train, test, seed):
    """The port's fit of one trial, its first three steps kept."""
    hp = space.params_to_hp(MODEL, flat)
    cap = Capture(engine.population_step)
    cap.begin()
    engine.population_step = cap
    try:
        engine.fit(get_spec(MODEL), [hp], [space.optimizer_hp(flat)], train,
                   test, CFG, seed=seed, device="cpu")
    finally:
        engine.population_step = cap.step_fn
    return cap.fits[0]


def _follow(a, train, seed, fault=None, keep=False):
    """The reference's first three steps of the single trial fitted at
    ``seed``."""
    init, run = seed_streams(seed, 1)
    plan = balanced_plan(train["y"], CFG.batch_size)
    data = {k: torch.as_tensor(v) for k, v in train.items()}
    return R.follow_trial(a, init[0], run[0], data,
                          (plan[0][:3], plan[1][:3]), "float32", 3, "cpu",
                          fault=fault, keep=keep)


@pytest.mark.parametrize("blocks,layers", [(1, 1), (2, 2)])
def test_the_reference_draws_the_ports_initial_parameters(blocks, layers):
    flat = _flat(blocks, layers)
    a = A.arch(flat)
    params, _ = cnn_lstm.init(torch.Generator().manual_seed(17),
                              space.params_to_hp(MODEL, flat))
    ref = R.init_trial(a, 17)
    assert len(tree_leaves(params)) == len(ref)
    for name, path, shape, _ in A.leaves(a):
        assert torch.equal(_port_leaf(params, path), ref[name]), name
        assert tuple(ref[name].shape) == shape


@pytest.mark.parametrize("optimizer", ["Adam", "Nadam", "RMSprop"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("blocks", [1, 2])
def test_the_port_matches_the_reference(blocks, layers, optimizer):
    """``spec.apply`` in training (its dropout draws too) against the
    reference's forward: logits, loss and every leaf's gradient; then
    ``engine.fit``'s first three steps against the reference's: each
    step's loss and each leaf's change."""
    flat = _flat(blocks, layers, optimizer)
    a, hp = A.arch(flat), space.params_to_hp(MODEL, flat)
    train, test = _split()
    P = R.init_trial(a, 5)
    spec = get_spec(MODEL)
    params, bn = cnn_lstm.init(torch.Generator().manual_seed(5), hp)
    leaves = {name: _port_leaf(params, path).requires_grad_(True)
              for name, path, _, _ in A.leaves(a)}
    rows = torch.arange(20)
    codes = torch.as_tensor(train["cnn"])[rows]
    y = torch.as_tensor(train["y"])[rows]
    mask = torch.ones(20)
    mask[-3:] = 0.0
    logits, _ = spec.apply(params, bn, hp, {"cnn": codes}, True, 99, mask,
                           None)
    loss = M.weighted_cross_entropy(logits, y, mask)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    live = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    want = R.forward(a, live, codes, mask, "float32",
                     M.StepDraws(a, 99, 20, True, "cpu"))
    want_loss = M.weighted_cross_entropy(want, y, mask)
    want_grads = torch.autograd.grad(want_loss, list(live.values()))
    close(logits, want)
    close(loss, want_loss)
    norms = [float(w.norm()) for w in want_grads]
    floor = EXCLUDE_BELOW * statistics.median(norms)
    for name, g, w, n in zip(leaves, grads, want_grads, norms):
        if n >= floor:      # else a conv bias under BatchNorm: round-off
            close(g, w)

    rec = _watched_fit(flat, train, test, seed=11)
    ref = _follow(a, train, 11, keep=True)
    init = R.init_trial(a, seed_streams(11, 1)[0][0])
    for got, wanted in zip(rec["loss"], ref["loss"]):
        assert float(got[0]) == pytest.approx(wanted, rel=TOL)
    med = statistics.median(ref["change"].values())
    floor = EXCLUDE_BELOW * statistics.median(ref["raw"].values())
    for name, path, _, _ in A.leaves(a):
        if ref["raw"][name] < floor:
            continue    # a conv bias under BatchNorm: nought but round-off
        moved = (_port_leaf(rec["params"], path)[0]
                 - _port_leaf(rec["params0"], path)[0])
        gap = float((moved - (ref["params"][name] - init[name])).norm())
        assert gap <= STEP_TOL * max(ref["change"][name], med), name


def _swapped_lstm(x, P, layers, precision):
    """The reference's recurrence with the input and forget gates read in
    each other's places."""
    P = dict(P)
    for layer in range(layers):
        for key in ("w_ih", "w_hh", "b_ih", "b_hh"):
            i, f, g, o = P[f"lstm{layer}.{key}"].chunk(4, dim=-1)
            P[f"lstm{layer}.{key}"] = torch.cat([f, i, g, o], dim=-1)
    return _LSTM(x, P, layers, precision)


_LSTM = R.lstm


@pytest.mark.parametrize("fault", ["gate_order", "lr", "half", "reset"])
def test_a_planted_fault_reads_not_correct(fault, monkeypatch):
    """The reference with a fault planted, put in the program's place,
    against the reference: not correct under the cell's limits."""
    archs = [[A.arch(_flat(2, 1))], [A.arch(_flat(1, 2, "RMSprop"))]]
    train, _ = _split()
    plan = balanced_plan(train["y"], CFG.batch_size)
    plan = (plan[0][:3], plan[1][:3])
    data = {k: torch.as_tensor(v) for k, v in train.items()}
    ref = R.follow(archs, 7, data, plan, "float32", 3, "cpu")
    if fault == "gate_order":
        monkeypatch.setattr(R, "lstm", _swapped_lstm)
        side = R.follow(archs, 7, data, plan, "float32", 3, "cpu")
    else:
        side = R.follow(archs, 7, data, plan, "float32", 3, "cpu", fault=fault)
    limits = cell(CELL)["limits"]
    assert verdict({k: v[0] for k, v in train_gaps(ref, ref).items()},
                   limits)[0]
    correct, checks = verdict({k: v[0] for k, v in
                               train_gaps(side, ref).items()}, limits)
    assert not correct, checks


@pytest.mark.parametrize("optimizer", ["Adam", "Nadam", "RMSprop"])
def test_an_optimizer_state_lost_between_steps_reads_not_correct(
        optimizer, monkeypatch):
    """The port's fit with its optimizer's state started afresh at every
    step (moments nought, step count 0), against the reference, as the
    cell compares them (the driver's port side, the cell's limits): not
    correct; the same fit without the fault: correct."""
    flat = _flat(1, 2, optimizer)
    a = A.arch(flat)
    train, test = _split()
    ref = [[_follow(a, train, 13)]]
    limits = cell(CELL)["limits"]

    def reading():
        st = {"groups": [[0]], "archs": [a], "capture": Capture(None)}
        st["capture"].fits.append(_watched_fit(flat, train, test, seed=13))
        gaps = train_gaps(D._port_side(st), ref)
        return verdict({k: v[0] for k, v in gaps.items()}, limits)

    assert reading()[0]
    real = optim.apply_update

    def afresh(params, grads, state, *args, **kwargs):
        lead = tuple(state["step"].shape)
        return real(params, grads, optim.init_state(params, lead=lead),
                    *args, **kwargs)

    monkeypatch.setattr(optim, "apply_update", afresh)
    correct, checks = reading()
    assert not correct, checks


class _Stop(Exception):
    pass


#: the cell's trials that the test at the cell's widths fits, one an
#: optimizer (trial 5: the nested tree of two LSTM layers), its seed
WIDE_TRIALS = {"RMSprop": 0, "Adam": 2, "Nadam": 5}
WIDE_SEED = 1900000505
#: ``step_gap`` over three steps at the cell's widths on the CPU: sound
#: fits read 9.3e-8 to 5.8e-6 (ATen's LSTM and the loop part by
#: round-off), a state started afresh every step 4.7e-2 to 0.32, a second
#: moment decayed at 0.99 for 0.999 1.1e-3 to 1.5e-3 (PERF.md §4)
WIDE_STEP_TOL = 1e-4


def _wide_fit(trial: int, train, test):
    """The port's fit of one of the cell's trials at its published
    widths (the cell's batches, its seeds), stopped after three steps."""
    flat = cell(CELL)["config"]["population"][trial]
    cap = Capture(engine.population_step)
    cap.begin()

    def three(*args, **kwargs):
        out = cap(*args, **kwargs)
        if len(cap.fits[0]["loss"]) == 3:
            raise _Stop
        return out

    engine.population_step = three
    try:
        engine.fit(get_spec(MODEL), [space.params_to_hp(MODEL, flat)],
                   [space.optimizer_hp(flat)], train, test,
                   TrainConfig(num_epochs=1, batch_size=100, patience=2),
                   seed=group_seed(WIDE_SEED, trial), device="cpu")
    except _Stop:
        pass
    finally:
        engine.population_step = cap.step_fn
    return {"groups": [[0]], "archs": [A.arch(flat)], "capture": cap}


@pytest.mark.parametrize("optimizer", sorted(WIDE_TRIALS))
def test_at_the_cells_widths_a_broken_optimizer_state_reads_not_correct(
        optimizer, monkeypatch):
    """The cell compares a fit's first step, where Adam's and Nadam's
    update is about lr sign(g) whatever their moments hold; their later
    steps are held here, at the cell's widths on its data: three steps of
    the port against the reference read correct, and not correct with the
    optimizer's state started afresh every step, or (Adam, Nadam) with a
    wrong second-moment decay."""
    c = cell(CELL)
    cfg, trial = c["config"], WIDE_TRIALS[optimizer]
    n_tr = cfg["hpo_train_windows"]
    data = make_data(n_tr + cfg["hpo_val_windows"], cfg["in_features"],
                     np.random.default_rng(WIDE_SEED),
                     c["traffic"]["prevalence"])
    train = {k: data[k][:n_tr] for k in ("cnn", "y")}
    test = {k: data[k][n_tr:] for k in ("cnn", "y")}
    a = A.arch(cfg["population"][trial])
    init, run = seed_streams(group_seed(WIDE_SEED, trial), 1)
    plan = balanced_plan(train["y"], 100)
    ref = [[R.follow_trial(a, init[0], run[0],
                           {k: torch.as_tensor(v) for k, v in train.items()},
                           (plan[0][:3], plan[1][:3]), "float32", 3, "cpu")]]
    limits = dict(c["limits"], step_gap=WIDE_STEP_TOL)

    def reading():
        gaps = train_gaps(D._port_side(_wide_fit(trial, train, test)), ref)
        return verdict({k: v[0] for k, v in gaps.items()}, limits)

    assert reading()[0], reading()[1]
    real = optim.apply_update

    def afresh(params, grads, state, *args, **kwargs):
        lead = tuple(state["step"].shape)
        return real(params, grads, optim.init_state(params, lead=lead),
                    *args, **kwargs)

    faults = [("apply_update", afresh)]
    if optimizer != "RMSprop":
        faults.append(("_B2", 0.99))
    for name, value in faults:
        with monkeypatch.context() as m:
            m.setattr(optim, name, value)
            correct, checks = reading()
        assert not correct, (name, checks)


def test_the_drivers_groups_and_seeds_are_run_searchs(tmp_path, monkeypatch):
    """A study whose sampler replays a population with two trials of one
    architecture: the fits ``run_search`` makes (their trials and seeds)
    are the driver's groups at ``frozen.seeds.group_seed``."""
    flats = [_flat(2, 1), _flat(1, 2, "RMSprop"), _flat(2, 1, lr=3e-3),
             _flat(1, 1, LSTM_hidden_layer_size=16)]
    hps = [space.params_to_hp(MODEL, f) for f in flats]
    trial = {_key(h, space.optimizer_hp(f)): i
             for i, (h, f) in enumerate(zip(hps, flats))}
    train, test = _split(60, 20)
    calls = []
    real_fit = engine.fit

    def recorded(spec, hp_list, opt_list, *args, **kw):
        calls.append(([trial[_key(h, o)] for h, o in zip(hp_list, opt_list)],
                      kw["seed"]))
        return real_fit(spec, hp_list, opt_list, *args, **kw)

    monkeypatch.setattr(engine, "fit", recorded)
    search.run_search(get_spec(MODEL), MODEL, train, test, "s",
                      storage=str(tmp_path / "s.db"),
                      sampler=ReplaySampler(flats), n_trials=len(flats),
                      train_cfg=TrainConfig(num_epochs=1, batch_size=30),
                      seed=41, device="cpu")
    groups = D.groups_of(get_spec(MODEL), hps)
    assert groups == [[0, 2], [1], [3]]
    assert calls == [(idxs, group_seed(41, g)) for g, idxs in
                     enumerate(groups)]


def _key(hp, opt):
    """A trial as ``run_search`` hands it to a fit: its architecture and
    its optimizer's numbers."""
    return tuple(tuple(np.asarray(v).ravel().tolist()) for d in (hp, opt)
                 for v in d.values())


def _fit_with_grads(profiled: bool):
    flat = _flat(2, 2, "Nadam")
    train, test = _split()
    if not profiled:
        return _watched_fit(flat, train, test, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rec = _watched_fit(flat, train, test, seed=3)
    return rec, prof


def test_the_spans_leave_a_fits_numbers_as_they_are():
    """A fit's losses, first gradients and parameters after its steps, with
    and without a profiler recording: bit for bit equal; the profiled fit
    records the recurrence's span."""
    plain = _fit_with_grads(False)
    traced, prof = _fit_with_grads(True)
    for key in ("loss", "m1", "params"):
        got = tree_leaves(traced[key]) if key != "loss" else traced[key]
        want = tree_leaves(plain[key]) if key != "loss" else plain[key]
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), key
    assert "cnn_lstm.lstm" in {e.name for e in prof.events()}


def _lstm_leaves(hidden=8, layers=2, seed=1):
    params = cnn_lstm._lstm_init(torch.Generator().manual_seed(seed), 4,
                                 hidden, layers)
    for layer in params:
        for v in layer.values():
            v.requires_grad_(True)
    return params


def test_the_recurrence_computes_the_library_calls_numbers_bit_for_bit():
    """``lstm_apply`` (the library's call inside its span) against torch's
    LSTM called directly, as before the span: outputs and every gradient
    bit for bit."""
    params = _lstm_leaves()
    x = torch.randn(5, 30, 4, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    leaves = [x] + [v for layer in params for v in layer.values()]
    out = cnn_lstm.lstm_apply(params, x, train=True)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    flat = []
    for layer in params:
        flat += [layer["w_ih"].t().contiguous(), layer["w_hh"].t().contiguous(),
                 layer["b_ih"], layer["b_hh"]]
    h0 = x.new_zeros((2, 5, 8))
    direct = torch._VF.lstm(x, (h0, h0), flat, True, 2, 0.0, True, False,
                            True)[0]
    want = torch.autograd.grad((direct ** 2).sum(), leaves)
    assert torch.equal(out, direct)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("rows", [None, 2])
def test_lstm_steps_count_timesteps_times_layers_once_a_call(rows, monkeypatch):
    """Every call of the recurrence adds its timesteps x layers once, in
    one chunk or in three (5 rows, 2 a chunk), training or evaluating;
    the chunks compute what one call does."""
    params = _lstm_leaves()
    x = torch.randn(5, 30, 4, generator=torch.Generator().manual_seed(2))
    whole = cnn_lstm.lstm_apply(params, x, train=True)
    if rows is not None:
        monkeypatch.setattr(cnn_lstm, "_chunk_rows", lambda *a: rows)
    profiling.reset_counters()
    out = cnn_lstm.lstm_apply(params, x, train=True)
    with torch.no_grad():
        cnn_lstm.lstm_apply(params, x, train=False)
    assert profiling.counters()["cnn_lstm.lstm_steps"] == 2 * 30 * 2
    torch.testing.assert_close(out, whole, rtol=1e-6, atol=1e-7)
    (out.sum()).backward()
    assert all(v.grad is not None for layer in params for v in layer.values())
