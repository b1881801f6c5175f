"""Serving end to end: checkpoints cross between the packages, and the
port's ``predict`` / ``evaluate`` on the CPU equal the JAX package's.

Eval mode still draws the stochastic embracement, from another RNG stream
in each package, so EmbraceNet predictions agree exactly only at
``selection_probabilities_FFNN`` in {0, 1}; probabilities and metrics must
then agree at rtol = atol = 1e-4 (float32, another summation order).  Both
sides micro-batch at 128 rows so a 300-window request spans three batches,
the last one padded.
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch
from torch_parity import IN_FEATURES, close, flat_embracenet

import embracenet_tpu_torch
from embracenet_tpu import api as japi
from embracenet_tpu.hpo import space as jspace
from embracenet_tpu.models import cnn as jcnn
from embracenet_tpu.models import embracenet as jem
from embracenet_tpu.models import ffnn as jffnn
from embracenet_tpu.models import reload as jreload
from embracenet_tpu.training.checkpoint import load_checkpoint as j_load
from embracenet_tpu.training.checkpoint import save_checkpoint as j_save
from embracenet_tpu_torch import api as tapi
from embracenet_tpu_torch.models import embracenet as tem
from embracenet_tpu_torch.models import reload as treload
from embracenet_tpu_torch.training.checkpoint import load_checkpoint as t_load
from embracenet_tpu_torch.training.checkpoint import save_checkpoint as t_save

TOL = 1e-4
N = 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def small_batches(monkeypatch):
    monkeypatch.setattr(jreload.ReloadedModel, "BATCH", 128)
    monkeypatch.setattr(treload.ReloadedModel, "BATCH", 128)


@pytest.fixture
def data(rng):
    y = (rng.random(N) < 0.3).astype(np.int64)
    x = rng.normal(size=(N, IN_FEATURES)).astype(np.float32)
    x[:, 0] += 1.5 * y
    return {"ffnn": x, "y": y,
            "cnn": rng.integers(0, 4, size=(N, 256)).astype(np.uint8)}


def _jax_checkpoint(tmp_path, model, flat):
    hp = jspace.params_to_hp(model, flat)
    key = jax.random.PRNGKey(3)
    if model == "FFNN":
        params = jax.jit(jffnn.init_from_fans, static_argnums=2)(
            key, jffnn.fan_ins(hp, IN_FEATURES), IN_FEATURES)
        bn = {}
    elif model == "CNN":
        params, bn = jax.jit(jcnn.init_from_fans)(key, jcnn.fan_ins(hp))
    else:
        params, bn = jax.jit(jem.init_from_fans, static_argnums=2)(
            key, jem.fan_ins(hp, IN_FEATURES), IN_FEATURES)
    path = str(tmp_path / f"{model}_ckpt")
    j_save(path, {"params": params, "bn_state": bn},
           {"model": model, "model_params": flat})
    return path


@pytest.mark.parametrize("p_ffnn", [0.0, 1.0])
def test_embracenet_predict_evaluate_match_jax(tmp_path, data, p_ffnn):
    path = _jax_checkpoint(tmp_path, "EmbraceNetMultimodal",
                           flat_embracenet(p_ffnn, n_post=2))
    want = japi.predict(path, data)
    want_metrics = japi.evaluate(path, data)
    for fused in (True, False):
        got = tapi.predict(path, data, device="cpu", fused_embrace=fused)
        assert got.shape == (N, 2) and got.dtype == np.float32
        close(got, want, TOL)
        got_metrics = tapi.evaluate(path, data, device="cpu",
                                    fused_embrace=fused)
        assert got_metrics.keys() == want_metrics.keys()
        for k, v in want_metrics.items():
            assert got_metrics[k] == pytest.approx(v, abs=TOL), k


@pytest.mark.parametrize("model", ["FFNN", "CNN"])
def test_unimodal_predict_matches_jax(tmp_path, data, model):
    if model == "FFNN":
        flat = {"n_layers": 2, "n_units_l0": 64, "n_units_l1": 32}
    else:
        flat = {"n_layers": 2, "out_channels_l0": 16, "out_channels_l1": 32,
                "kernel_size_l0": 5, "kernel_size_l1": 11}
    path = _jax_checkpoint(tmp_path, model, flat)
    close(tapi.predict(path, data, device="cpu"), japi.predict(path, data), TOL)


def test_mid_probability_predictions_are_seeded(tmp_path, data):
    path = _jax_checkpoint(tmp_path, "EmbraceNetMultimodal",
                           flat_embracenet(0.5, n_post=1))
    model = treload.load_model(path, device="cpu")
    first, again = model(data, logits=True), model(data, logits=True)
    np.testing.assert_array_equal(first, again)
    assert np.all(np.isfinite(first))
    other = treload.load_model(path, device="cpu", seed=1)(data, logits=True)
    assert not np.array_equal(first, other)


def test_port_checkpoint_loads_in_jax(tmp_path):
    flat = flat_embracenet(0.5)
    hp = jspace.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = tem.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    path = str(tmp_path / "port_ckpt")
    meta = {"model": "EmbraceNetMultimodal", "model_params": flat}
    t_save(path, {"params": params, "bn_state": bn}, meta)
    trees_j, meta_j = j_load(path)
    trees_t, meta_t = t_load(path)
    assert meta_j == meta_t == meta
    want = {"params": jax.tree.map(lambda a: a.numpy(), params),
            "bn_state": jax.tree.map(lambda a: a.numpy(), bn)}
    jax.tree.map(np.testing.assert_array_equal, trees_j, want)
    jax.tree.map(np.testing.assert_array_equal, trees_t, want)
    # and the JAX package serves it
    model = jreload.load_model(path)
    assert model.spec.name == "EmbraceNetMultimodal"


def test_no_silent_cpu_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embracenet_tpu_torch.default_device()
    path = _jax_checkpoint(tmp_path, "FFNN", {"n_layers": 1, "n_units_l0": 32})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treload.load_model(path)
    assert treload.load_model(path, device="cpu").device.type == "cpu"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    tools = os.path.join(REPO, "tools")
    examples = os.path.join(REPO, "examples")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, n) for d in (tools, examples)
        for n in sorted(os.listdir(d))
        if n.startswith("torch_") and n.endswith(".py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "embracenet_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not source
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"embracenet_tpu_torch/training/engine.py",
            "embracenet_tpu_torch/benchkit.py",
            "embracenet_tpu_torch/ops/optim.py",
            "embracenet_tpu_torch/training/cv.py",
            "embracenet_tpu_torch/hpo/search.py",
            "embracenet_tpu_torch/data/sampling.py",
            "embracenet_tpu_torch/utils/skcompat.py",
            "embracenet_tpu_torch/models/concatnet.py",
            "embracenet_tpu_torch/models/cnn_lstm.py",
            "embracenet_tpu_torch/models/utils.py",
            "embracenet_tpu_torch/runtime/__init__.py",
            "embracenet_tpu_torch/utils/statcompat.py",
            "embracenet_tpu_torch/data/io.py",
            "embracenet_tpu_torch/data/tasks.py",
            "embracenet_tpu_torch/data/stats.py",
            "embracenet_tpu_torch/data/preprocess.py",
            "embracenet_tpu_torch/data/splits.py",
            "embracenet_tpu_torch/data/pipeline.py",
            "embracenet_tpu_torch/data/synth.py",
            "embracenet_tpu_torch/sweep.py",
            "embracenet_tpu_torch/__main__.py",
            "embracenet_tpu_torch/visual/report.py",
            "embracenet_tpu_torch/utils/profiling.py",
            "embracenet_tpu_torch/utils/logging.py",
            "examples/torch_quickstart.py",
            "tools/torch_embrace_ab.py", "tools/torch_embrace_bench.py",
            "tools/torch_serve_profile.py"} <= names
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "embracenet_tpu", "pandas"), \
                (path, mod)
