"""The plain reference against the port on the CPU, each cell cut to a
size a test holds (``tiny.py``): a whole run of the harness (set-up,
window, traced stretch, checks) with the chip's look skipped comes out
correct; its control, the reference at the precision below the cell's,
fails the cell's limits; and with the timed path broken underneath --
a step that returns its state unchanged, half of each batch left out, an
answer altered where it is produced -- the run comes out not correct.
(The exchange between chips has no fault to plant: every cell is one
chip.)"""

import time

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.core.checks import train_gaps, verdict
from benchmark.tests.tiny import PATHS, tiny_cell

#: the cells of BENCHMARK.json
CELLS = ["embracenet-hepg2.train-pop8-f32", "embracenet-hepg2.serve-10k"]
TRAIN = CELLS[:1] + list(PATHS)
SERVE = CELLS[1:]
SEED = 3000000007


def _run(name, trace=False):
    return R.run(tiny_cell(name), SEED, 0.5, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_the_port_matches_the_reference(name):
    result, lines = _run(name, trace=name == TRAIN[0])
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


def _ctx(c, seed=SEED):
    return {"workload": c["workload"], "config": c["config"],
            "traffic": c["traffic"], "seed": seed, "device": "cpu"}


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_fails_a_training_cell(name):
    c = tiny_cell(name)
    driver = R.load_module(c["driver"], "ctl_" + name.replace(".", "_"))
    ctx = _ctx(c)
    st = driver.setup(ctx)
    ref = driver.reference(ctx, st, c["traffic"]["compute_dtype"])
    ctl = driver.reference(ctx, st, c["traffic"]["control_precision"])
    values = {k: v[0] for k, v in train_gaps(ctl, ref).items()}
    assert not verdict(values, c["limits"])[0], values


def test_the_control_fails_the_serving_cell():
    c = tiny_cell(SERVE[0])
    driver = R.load_module(c["driver"], "ctl_serve")
    ctx = _ctx(c)
    st = driver.setup(ctx)
    st["model_batch"] = st["model"].BATCH
    gap = max(float(np.abs(driver.reference_probs(ctx, st, k, "tf32")
                           - driver.reference_probs(ctx, st, k, "float32")).max())
              for k in range(len(st["pool"])))
    assert not verdict({"prob_gap": gap}, c["limits"])[0], gap


def _unchanged(step):
    def broken(spec, params, bn_state, opt_state, *rest):
        loss, logits, *_ = step(spec, params, bn_state, opt_state, *rest)
        return loss, logits, params, bn_state, opt_state
    return broken


def _half_batch(step):
    def broken(*args):
        args = list(args)
        mask = args[8].clone()
        mask[:, mask.shape[1] // 2:] = 0.0
        args[8] = mask
        return step(*args)
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state-unchanged", "half-batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_training_step_is_not_correct(name, fault, monkeypatch):
    from embracenet_tpu_torch.training import engine

    monkeypatch.setattr(engine, "population_step", fault(engine.population_step))
    result, lines = _run(name)
    assert not result["correct"], lines


def _one_trial_lr(update):
    """The last trial's learning rate 1.1 times its own."""
    def broken(params, grads, state, opt_id, lr, weight_decay, upd=None):
        lr = lr.clone()
        lr[-1] = lr[-1] * 1.1
        return update(params, grads, state, opt_id, lr, weight_decay, upd)
    return broken


def _one_trial_frozen(update):
    """The last trial's update frozen, as a stopped trial's is."""
    def broken(params, grads, state, opt_id, lr, weight_decay, upd=None):
        upd = (torch.ones(lr.shape, dtype=torch.bool, device=lr.device)
               if upd is None else upd.clone())
        upd[-1] = False
        return update(params, grads, state, opt_id, lr, weight_decay, upd)
    return broken


@pytest.mark.parametrize("fault", [_one_trial_lr, _one_trial_frozen],
                         ids=["one-trial-lr", "one-trial-frozen"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_update_of_one_trial_is_not_correct(name, fault, monkeypatch):
    from embracenet_tpu_torch.ops import optim

    monkeypatch.setattr(optim, "apply_update", fault(optim.apply_update))
    result, lines = _run(name)
    assert not result["correct"], lines


def _altered(forward):
    def broken(self, data, logits=False):
        out = forward(self, data, logits)
        out[0] = (1.0, 0.0)
        return out
    return broken


def _half_rows(forward):
    def broken(self, data, logits=False):
        out = forward(self, data, logits)
        n = len(out)
        out[n // 2:] = out[:n - n // 2]
        return out
    return broken


@pytest.mark.parametrize("fault", [_altered, _half_rows],
                         ids=["answer-altered", "half-batch"])
def test_a_broken_answer_is_not_correct(fault, monkeypatch):
    from embracenet_tpu_torch.models.reload import ReloadedModel

    monkeypatch.setattr(ReloadedModel, "forward", fault(ReloadedModel.forward))
    result, lines = _run(SERVE[0])
    assert not result["correct"], lines


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name, card):
    result, lines = R.run(R.cell(name), SEED, 2.0, False, card,
                          time.perf_counter())
    assert result["correct"], lines
