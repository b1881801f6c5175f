"""The port's spans and counters (``utils.profiling``): a span is a no-op
unless a torch profiler records, and then lands in its timeline nested as
the code nests; the engine's and the serving path's spans and counters
say what the fit and the request did.  CPU only, no JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.core import trace
from embracenet_tpu_torch.config import TrainConfig
from embracenet_tpu_torch.convert import tree_leaves
from embracenet_tpu_torch.hpo import space
from embracenet_tpu_torch.models import ffnn
from embracenet_tpu_torch.models.layers import Draws, stack_hps
from embracenet_tpu_torch.models.reload import ReloadedModel
from embracenet_tpu_torch.training import engine
from embracenet_tpu_torch.training.batching import balanced_plan, eval_plan
from embracenet_tpu_torch.training.modelspec import get_spec
from embracenet_tpu_torch.utils import profiling

IN_FEATURES = 16
#: aten ops that make a view and launch nothing on a device
VIEWS = {"aten::select", "aten::slice", "aten::view", "aten::as_strided",
         "aten::alias", "aten::detach", "aten::lift_fresh"}


@pytest.fixture(autouse=True)
def _fresh_counters():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    profiling.reset_counters()
    yield
    profiling.reset_counters()
    torch.set_num_threads(threads)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _flat(**over):
    flat = {"FFNN_n_layers": 2, "FFNN_n_units_l0": 32, "FFNN_dropout_l0": 0.3,
            "FFNN_n_units_l1": 16, "FFNN_dropout_l1": 0.2,
            "CNN_n_layers": 2, "CNN_out_channels_l0": 16,
            "CNN_kernel_size_l0": 5, "CNN_dropout_l0": 0.2,
            "CNN_out_channels_l1": 32, "CNN_kernel_size_l1": 11,
            "CNN_dropout_l1": 0.4, "EMBRACENET_embracement_size": 512,
            "n_post_layers": 1, "EMBRACENET_n_units_l0": 32,
            "EMBRACENET_dropout_l0": 0.2, "selection_probabilities_FFNN": 0.6,
            "optimizer": "Adam", "lr": 0.01, "weight_decay": 0.001}
    flat.update(over)
    return flat


def _split(n_train=240, n_test=80):
    rng = np.random.default_rng(0)
    n = n_train + n_test
    data = {"ffnn": rng.normal(size=(n, IN_FEATURES)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(n, 256), dtype=np.uint8),
            "y": (rng.random(n) < 0.3).astype(np.int64)}
    return ({k: v[:n_train] for k, v in data.items()},
            {k: v[n_train:] for k, v in data.items()})


def _population():
    flats = [_flat(), _flat(FFNN_n_layers=1, CNN_n_layers=1,
                            optimizer="RMSprop", lr=0.003)]
    hps = [space.params_to_hp("EmbraceNetMultimodal", f) for f in flats]
    return hps, [space.optimizer_hp(f) for f in flats]


CFG = TrainConfig(num_epochs=2, epoch_chunk=1, batch_size=60)


@pytest.fixture(scope="module")
def traced_fit():
    """A two-trial fit of two epochs under the profiler: its spans as
    FunctionEvents, its reduced events, its counters and what it was fed
    and returned."""
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=IN_FEATURES)
    hps, opts = _population()
    train, test = _split()
    profiling.reset_counters()
    with _cpu_profile() as prof:
        res = engine.fit(spec, hps, opts, train, test, CFG, seed=3,
                         device="cpu")
    counts = profiling.counters(traced=True)
    profiling.reset_counters()
    return {"events": prof.events(), "reduced": trace._events(prof),
            "counts": counts, "res": res, "hps": hps, "opts": opts,
            "train": train, "test": test}


def _named(events, name):
    return [e for e in events if e.name == name]


def _inside(child, parent):
    return (parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


def test_annotate_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with profiling.annotate("engine.step"):
        pass
    assert profiling.annotate("a") is profiling.annotate("b")
    assert profiling.spanned("x")(lambda v: v + 1)(1) == 2


def test_annotate_is_a_span_of_the_running_profile():
    with _cpu_profile() as prof:
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(8) + 1
    (outer,), (inner,) = _named(prof.events(), "outer"), _named(
        prof.events(), "inner")
    assert _inside(inner, outer) and inner.cpu_parent is outer


def test_counts_outside_a_profiler_stay_out_of_the_traced_table():
    profiling.count("c.outside", 5)
    with _cpu_profile():
        profiling.count("c.inside")
        profiling.count("c.outside", 2)
    profiling.count("c.inside", 10)
    assert profiling.counters() == {"c.outside": 7, "c.inside": 11}
    assert profiling.counters(traced=True) == {"c.inside": 1, "c.outside": 2}
    profiling.reset_counters()
    assert profiling.counters() == {} == profiling.counters(traced=True)


def test_a_traced_fit_nests_its_phase_spans(traced_fit):
    ev = traced_fit["events"]
    (fit,) = _named(ev, "engine.fit")
    (setup,) = _named(ev, "engine.fit.setup")
    steps, evals = _named(ev, "engine.step"), _named(ev, "engine.eval")
    fetches = _named(ev, "engine.fetch")
    nb = balanced_plan(traced_fit["train"]["y"], CFG.batch_size,
                       seed=123).idx.shape[0]
    assert len(steps) == CFG.num_epochs * nb
    assert len(evals) == CFG.num_epochs
    assert len(fetches) == CFG.num_epochs // CFG.epoch_chunk
    for span in [setup] + steps + evals + fetches:
        assert _inside(span, fit), span.name
    assert setup.time_range.end <= min(s.time_range.start for s in steps)
    for step in steps:
        kids = [e.name for e in ev if e.cpu_parent is step
                and e.name.startswith("engine.")]
        assert kids == ["engine.step.gather", "engine.step.draws",
                        "engine.forward", "engine.backward", "engine.update"]


def test_the_benchmark_reads_the_program_spans_as_spans(traced_fit):
    kinds = {}
    for kind, name, _, _ in traced_fit["reduced"]:
        if name.startswith("engine."):
            kinds.setdefault(name, set()).add(kind)
    assert set(kinds) >= {"engine.fit", "engine.fit.setup", "engine.step",
                          "engine.step.gather", "engine.step.draws",
                          "engine.forward", "engine.backward",
                          "engine.update", "engine.eval", "engine.fetch"}
    assert all(k == {"span"} for k in kinds.values())
    rec = trace.reduce(traced_fit["reduced"])
    assert any(h[0] == "engine.step" for h in rec["host"])


def test_train_steps_count_the_plan(traced_fit):
    nb = balanced_plan(traced_fit["train"]["y"], CFG.batch_size,
                       seed=123).idx.shape[0]
    assert traced_fit["counts"]["engine.train_steps"] == CFG.num_epochs * nb


def test_to_device_bytes_count_every_array_a_fit_moves(traced_fit):
    """The init's constants (BatchNorm's; its drawn leaves are drawn on the
    device, not copied), the split, the plans and the hyperparameters."""
    res, hps, opts = traced_fit["res"], traced_fit["hps"], traced_fit["opts"]
    train, test = traced_fit["train"], traced_fit["test"]
    T = len(hps)

    def nbytes(tree):
        return sum(a.nbytes for a in tree_leaves(tree))

    plan = balanced_plan(train["y"], CFG.batch_size, seed=123)
    tplan = eval_plan(len(test["y"]), 2 * CFG.batch_size, seed=123)
    want = (nbytes({k: v for k, v in res.params["cnn"].items()
                    if k.startswith("bn")}) + nbytes(res.bn_state)
            + sum(nbytes(d) for d in (train, test))
            + 12 * (plan.idx.size + tplan.idx.size)   # int64 rows, f32 mask
            + sum(np.asarray([o[k] for o in opts]).nbytes
                  for k in ("optimizer", "lr", "weight_decay"))
            + 4 * T                                  # eval divisors, f32
            + nbytes(stack_hps(hps)))
    assert traced_fit["counts"]["engine.to_device_bytes"] == want


def _ops_issued(events, span):
    """The tensor ops each ``span`` region issued itself (views aside)."""
    return sum(1 for s in _named(events, span) for e in s.cpu_children
               if e.name.startswith("aten::") and e.name not in VIEWS)


@pytest.mark.parametrize("case", ["same_shapes", "ragged", "one_idle"])
def test_draw_launches_count_the_ops_a_draw_site_issues(case):
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    rows, own = [5, 5, 5], [(4,), (4,), (4,)]
    if case == "ragged":
        rows, own = [5, 3, 5], [(4,), (2,), (4,)]
    if case == "one_idle":
        gens[1] = None
    draws = Draws(gens, rows, "cpu")
    with _cpu_profile() as prof:
        for method, call in (("rand", lambda: draws.rand(5, own, (4,))),
                             ("scalar", draws.scalar),
                             ("seeds", draws.seeds)):
            with profiling.annotate(f"site.{method}"):
                call()
    ev = prof.events()
    issued = sum(_ops_issued(ev, f"site.{m}") for m in
                 ("rand", "scalar", "seeds"))
    assert profiling.counters(traced=True)["draws.launches"] == issued
    drawn = sum(g is not None for g in gens)
    stacked = case != "ragged" and drawn == len(gens)
    assert issued == (drawn + 1 if stacked else 2 * drawn + 1) + 2 * (
        len(gens) + 1)


def test_draw_launches_of_a_fit_are_those_its_draw_sites_issue(monkeypatch):
    """Each draw site of a fit wrapped in a span of its own: the counter
    equals the tensor ops those spans issued."""
    for method in ("rand", "scalar", "seeds"):
        orig = getattr(Draws, method)

        def site(self, *a, _orig=orig, **k):
            with profiling.annotate("site"):
                return _orig(self, *a, **k)

        monkeypatch.setattr(Draws, method, site)
    spec = get_spec("EmbraceNetMultimodal", in_features_ffnn=IN_FEATURES)
    hps, opts = _population()
    train, test = _split(120, 40)
    with _cpu_profile() as prof:
        engine.fit(spec, hps, opts, train, test,
                   TrainConfig(num_epochs=1, batch_size=60), device="cpu")
    counts = profiling.counters(traced=True)
    assert counts["draws.launches"] == _ops_issued(prof.events(), "site") > 0
    assert counts["draws.launches"] % counts["engine.train_steps"] == 0


def test_a_request_records_its_copies_micro_batches_and_rows():
    flat = {"n_layers": 2, "n_units_l0": 16, "n_units_l1": 8}
    hp = space.params_to_hp("FFNN", flat)
    params = ffnn.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    model = ReloadedModel("FFNN", params, {}, flat,
                          in_features_ffnn=IN_FEATURES, device="cpu")
    x = np.random.default_rng(0).normal(size=(10_000, IN_FEATURES))
    model({"ffnn": x.astype(np.float32)})
    assert profiling.counters(traced=True) == {}
    with _cpu_profile() as prof:
        probs = model({"ffnn": x.astype(np.float32)})
    assert probs.shape == (10_000, 2)
    ev = prof.events()
    (req,) = _named(ev, "reload.request")
    parts = [e.name for e in ev if e.cpu_parent is req
             and e.name.startswith("reload.")]
    assert parts == (["reload.copy_in"] + ["reload.microbatch"] * 3
                     + ["reload.copy_out"])
    assert profiling.counters(traced=True) == {"reload.rows_real": 10_000,
                                              "reload.rows_run": 12_288}
    assert profiling.counters()["reload.rows_run"] == 2 * 12_288
