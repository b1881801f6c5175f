"""The CNN_LSTM cell (``cnn_lstm-hepg2.train-pop8-f32-byarch``): the harness
finds its pieces by name, its driver runs a copy cut to the CPU's size
end to end, its readers read the recurrence's spans and counter and find
nothing where the program has none, and the frozen arithmetic gives the
configuration's timesteps, parameters and FLOPs."""

import copy
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import run as R
from benchmark.frozen import cnn_lstm as A
from benchmark.frozen.plans import eval_batches
from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.utils import profiling

CELL = "cnn_lstm-hepg2.train-pop8-f32-byarch"
NEW = ("lstm_wall_pct.train", "idle_lstm_pct.train",
       "lstm_steps_per_train_step")
SHARED = ("kernels_per_train_step", "mfu.train", "device_idle_pct.train",
          "idle_fit_setup_pct.train", "idle_step_pct.train",
          "idle_eval_pct.train", "draw_launches_per_train_step",
          "fit_to_device_mb.train")


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def reader(name):
    c = R.cell(CELL)
    return R.load_module(c["metric_files"][name],
                         "bench_metric_" + name.replace(".", "_")).read


def tiny_cell() -> dict:
    """The cell cut to the CPU's size: three narrow trials (one block or
    two, one LSTM layer or two), a few hundred windows, batches of 20."""
    c = copy.deepcopy(R.cell(CELL))
    base = {"n_layers": 1, "out_channels_l0": 4, "kernel_size_l0": 5,
            "dropout_l0": 0.3, "out_channels_l1": 8, "kernel_size_l1": 11,
            "dropout_l1": 0.2, "LSTM_hidden_layer_size": 8,
            "LSTM_n_layers": 1, "optimizer": "Adam", "lr": 1e-3,
            "weight_decay": 1e-3}
    c["config"]["population"] = [
        base, dict(base, n_layers=2, LSTM_n_layers=2, optimizer="RMSprop"),
        dict(base, LSTM_hidden_layer_size=16, optimizer="Nadam")]
    c["config"].update(hpo_train_windows=120, hpo_val_windows=60)
    c["traffic"].update(batch_size=20, warmup_windows=40)
    return c


def test_the_harness_finds_the_cells_pieces_by_name():
    c = R.cell(CELL)
    assert c["driver"].name == "population_byarch.py" and c["driver"].exists()
    assert c["config"]["name"] == "cnn_lstm-hepg2"
    assert c["config"]["model"] == "CNN_LSTM"
    assert set(c["limits"]) == {"loss_gap", "grad_gap", "step_gap"}
    assert {m["name"] for m in c["end_to_end"]} == {"train_windows_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in c["per_layer"]} == set(NEW + SHARED)
    for name in NEW + SHARED:
        assert c["metric_files"][name].exists()
        assert callable(reader(name))
    for name in NEW:
        m = next(m for m in c["per_layer"] if m["name"] == name)
        assert m["workloads"] == [CELL] and m["layer"] == "Model"


def test_the_configurations_population_is_the_search_spaces_draw():
    conf = R.cell(CELL)["config"]
    assert conf["population"] == [
        space.sample_params("CNN_LSTM", np.random.default_rng(i))
        for i in range(8)]
    archs = [A.arch(f) for f in conf["population"]]
    assert [a["timesteps"] for a in archs] == [464, 992, 928, 464, 1392, 928,
                                               992, 928]
    assert sum(a["timesteps"] * a["lstm_layers"] for a in archs) == 8016
    fc1 = [a["timesteps"] * a["lstm_hidden"] * A.FC1 for a in archs]
    assert max(fc1) == 126_976_000 and sum(fc1) == 368_640_000
    widest = A.arch(conf["widest"])
    assert widest["timesteps"] == 1984
    assert widest["timesteps"] * widest["lstm_hidden"] * A.FC1 == 253_952_000


def test_forward_flops_count_every_product_once():
    a = A.arch({"n_layers": 2, "out_channels_l0": 16, "kernel_size_l0": 5,
                "out_channels_l1": 32, "kernel_size_l1": 15,
                "LSTM_hidden_layer_size": 64, "LSTM_n_layers": 2,
                "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4})
    steps = 32 * 58 // 4
    want = (2 * 4 * 16 * 5 * 256 + 2 * 16 * 32 * 15 * 124
            + steps * 2 * 256 * (4 + 64) + steps * 2 * 256 * (64 + 64)
            + 2 * (steps * 64 * 1000 + 1000 * 64 + 64 * 2))
    assert A.fwd_flops(a) == want
    assert A.train_flops(a, 10, 4, 2) == 2 * (30 + 4) * want
    n_params = sum(int(np.prod(s)) for _, _, s, _ in A.leaves(a))
    assert n_params == (16 * 4 * 5 + 16 + 2 * 16 + 32 * 16 * 15 + 32 + 2 * 32
                        + 4 * 256 + 64 * 256 + 2 * 256
                        + 64 * 256 + 64 * 256 + 2 * 256
                        + steps * 64 * 1000 + 1000 + 1000 * 64 + 64
                        + 64 * 2 + 2)


@pytest.mark.parametrize("trace", [False, True])
def test_the_driver_runs_a_tiny_copy_on_the_cpu(trace):
    c = tiny_cell()
    result, lines = R.run(c, 3_000_000_019, 0.5, trace, "cpu",
                          time.perf_counter())
    assert result["correct"] and result["failed"] == 0, lines
    assert result["attempted"] >= 1
    if not trace:
        assert result["metrics"]["train_windows_per_s"]["value"] > 0
        return
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["lstm_wall_pct.train"] > 0
    archs = [A.arch(f) for f in c["config"]["population"]]
    n_train = 120 // 20 + 1             # the balanced plan's batches
    n_eval = eval_batches(60, 40)
    recurrent = sum(a["timesteps"] * a["lstm_layers"] for a in archs)
    assert got["lstm_steps_per_train_step"] == pytest.approx(
        recurrent * (n_train + n_eval) / (len(archs) * n_train))


def _record(host, device=(("k", 1.0, 2.0), ("k", 4.0, 6.0))):
    """A 10 s stretch whose device runs [1, 2] and [4, 6]."""
    return {"stretch": (0.0, 10.0), "stretch_s": 10.0,
            "kernels": list(device), "device": list(device),
            "host": list(host)}


def test_the_recurrence_readers_read_the_spans():
    rec = _record([("cnn_lstm.lstm", 0.0, 3.0),
                   ("aten::_cudnn_rnn_backward", 3.5, 5.0),
                   ("cnn_lstm.lstm", 2.5, 3.2), ("engine.step", 0.0, 9.0)])
    # union [0, 3.2] and [3.5, 5]: 4.7 s; idle [0, 1], [2, 3.2], [3.5, 4]
    assert reader("lstm_wall_pct.train")(rec) == pytest.approx(47.0)
    assert reader("idle_lstm_pct.train")(rec) == pytest.approx(27.0)


def test_the_recurrence_readers_find_nothing_without_the_program_s_spans():
    rec = _record([("engine.step", 0.0, 9.0), ("aten::mm", 1.0, 1.5),
                   ("aten::_cudnn_rnn_backward", 3.5, 5.0)])
    for name in NEW:
        assert reader(name)(rec) is None
    profiling.count("cnn_lstm.lstm_steps", 10)     # outside any profile
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("engine.train_steps", 4)
    assert reader("lstm_steps_per_train_step")(rec) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("cnn_lstm.lstm_steps", 10)
    assert reader("lstm_steps_per_train_step")(rec) == 2.5
