"""A cell cut to a size the CPU runs in seconds, for the harness's CPU
tests: two narrow trials (or a narrow served model), a few hundred
windows, batches of 20, requests of 300 windows."""

from __future__ import annotations

import copy

from benchmark.run import cell


def _trial(model: str, **over) -> dict:
    flat = {"FFNN_n_layers": 2, "FFNN_n_units_l0": 32, "FFNN_dropout_l0": 0.3,
            "FFNN_n_units_l1": 16, "FFNN_dropout_l1": 0.2,
            "FFNN_n_units_l2": 4, "FFNN_dropout_l2": 0.0,
            "FFNN_n_units_l3": 4, "FFNN_dropout_l3": 0.0,
            "CNN_n_layers": 2, "CNN_out_channels_l0": 16,
            "CNN_kernel_size_l0": 5, "CNN_dropout_l0": 0.2,
            "CNN_out_channels_l1": 32, "CNN_kernel_size_l1": 11,
            "CNN_dropout_l1": 0.4, "CNN_out_channels_l2": 64,
            "CNN_kernel_size_l2": 5, "CNN_dropout_l2": 0.0,
            "CNN_out_channels_l3": 128, "CNN_kernel_size_l3": 5,
            "CNN_dropout_l3": 0.0, "optimizer": "Adam", "lr": 0.01,
            "weight_decay": 0.001}
    if model == "EmbraceNetMultimodal":
        flat.update({"EMBRACENET_embracement_size": 512, "n_post_layers": 1,
                     "EMBRACENET_n_units_l0": 32, "EMBRACENET_dropout_l0": 0.2,
                     "EMBRACENET_n_units_l1": 16, "EMBRACENET_dropout_l1": 0.0,
                     "selection_probabilities_FFNN": 0.6})
    else:
        flat.update({"CONCATNET_n_post_layers": 2, "CONCATNET_n_units_l0": 512,
                     "CONCATNET_dropout_l0": 0.2, "CONCATNET_n_units_l1": 32,
                     "CONCATNET_dropout_l1": 0.3, "CONCATNET_n_units_l2": 16,
                     "CONCATNET_dropout_l2": 0.0})
    flat.update(over)
    return flat


#: the population driver's paths that no cell of BENCHMARK.json takes yet
#: (their host-bound runs spread too widely for a bound, PERF.md): name ->
#: (the cell it is cut from, its model, its mix's changes, its limits, as
#: calibrated on the card for the cells PERF.md keeps for later)
PATHS = {
    "embracenet-bf16": ("embracenet-hepg2.train-pop8-f32", None,
                        {"compute_dtype": "bfloat16", "control_precision": "fp8",
                         "width_buckets": True, "pipeline_chunks": True},
                        {"loss_gap": 1.5e-4, "grad_gap": 1.5e-2, "step_gap": 2e-3}),
    "concatnet-bf16": ("embracenet-hepg2.train-pop8-f32", "ConcatNetMultimodal",
                       {"compute_dtype": "bfloat16", "control_precision": "fp8",
                        "width_buckets": True, "pipeline_chunks": True},
                       {"loss_gap": 2e-4, "grad_gap": 1.5e-2, "step_gap": 1e-3}),
}


def tiny_cell(workload: str) -> dict:
    """A cell of ``BENCHMARK.json``, or a path of :data:`PATHS`, cut to the
    CPU's size."""
    if workload in PATHS:
        base, model, changes, limits = PATHS[workload]
        c = copy.deepcopy(cell(base))
        c["config"]["model"] = model or c["config"]["model"]
        c["traffic"].update(changes)
        c["limits"] = dict(limits)
    else:
        c = copy.deepcopy(cell(workload))
    conf, mix = c["config"], c["traffic"]
    model = conf["model"]
    conf["population"] = [
        _trial(model),
        _trial(model, FFNN_n_layers=3, FFNN_n_units_l2=32, CNN_n_layers=1,
               optimizer="RMSprop", lr=0.003, weight_decay=0.01),
    ]
    conf["widest"] = _trial(model, n_post_layers=0)
    conf.update(hpo_train_windows=120, hpo_val_windows=60)
    mix.update(batch_size=20, warmup_windows=40, request_windows=300,
               pool=2, traced_requests=2, checked_requests=2)
    return c
