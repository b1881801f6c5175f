"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: hyperparameter constructors, the numpy bridge between the two,
and a deterministic stand-in for ``engine.fit`` that both packages' search
and CV code can be run on."""

from __future__ import annotations

import os

import jax
import numpy as np
import torch

from embracenet_tpu.training.checkpoint import load_checkpoint as j_load_ck
from embracenet_tpu_torch.convert import tree_to_torch
from embracenet_tpu_torch.training.checkpoint import load_checkpoint as t_load_ck

# Each pytest-xdist worker is a process of its own, and torch's default of
# one intra-op thread per core makes two workers that train at once thrash
# each other (two files of about a minute each took 6.5 minutes side by
# side).  The port's CPU tests run small tensors, which two threads serve
# about as fast.
torch.set_num_threads(min(2, torch.get_num_threads()))

IN_FEATURES = 16


def hp_ffnn(n_layers, widths, dropout=None):
    return {"n_layers": np.int32(n_layers),
            "widths": np.asarray(widths, np.int32),
            "dropout": np.asarray(dropout or [0.0] * 4, np.float32)}


def hp_cnn(n_layers, channels, kernels, dropout=None):
    return {"n_layers": np.int32(n_layers),
            "channels": np.asarray(channels, np.int32),
            "kernels": np.asarray(kernels, np.int32),
            "dropout": np.asarray(dropout or [0.0] * 4, np.float32)}


def flat_embracenet(p_ffnn, n_post=1, cnn_layers=2, ffnn_layers=2,
                    embrace_size=512):
    """Small EmbraceNetMultimodal flat params (reference names)."""
    flat = {"FFNN_n_layers": ffnn_layers, "CNN_n_layers": cnn_layers,
            "EMBRACENET_embracement_size": embrace_size,
            "n_post_layers": n_post,
            "selection_probabilities_FFNN": p_ffnn,
            "optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4}
    for i, (w, c, k) in enumerate(zip((64, 32, 16, 4), (16, 32, 64, 128),
                                      (5, 11, 15, 5))):
        flat[f"FFNN_n_units_l{i}"] = w
        flat[f"CNN_out_channels_l{i}"] = c
        flat[f"CNN_kernel_size_l{i}"] = k
    flat["EMBRACENET_n_units_l0"] = 64
    flat["EMBRACENET_n_units_l1"] = 32
    return flat


def to_torch(tree):
    """JAX tree -> numpy -> the port's tensors (CPU)."""
    return tree_to_torch(jax.tree.map(np.asarray, tree), "cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# a fake engine.fit for both packages' search and CV accounting
# ---------------------------------------------------------------------------

def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def curve(opt, n_epochs):
    """A per-epoch test AUPRC history fixed by the trial's optimizer
    params: it rises to a peak epoch, then falls (so the pruners fire)."""
    lr, wd = float(opt["lr"]), float(opt["weight_decay"])
    base = (lr * 1e4) % 0.5
    peak = 1 + int(wd * 1e4) % n_epochs
    return [base + 0.05 * min(e, peak) - 0.04 * max(0, e - peak)
            for e in range(1, n_epochs + 1)]


class FakeResult:
    def __init__(self, params, bn_state, hists):
        self.params, self.bn_state = params, bn_state
        self.auprc_test = hists
        self.auprc_train = [[0.5 * v for v in h] for h in hists]
        self.f1_precision_recall = [[[v, v, v] for v in h] for h in hists]
        self.epochs_run = [len(h) for h in hists]

    @property
    def final_test_auprc(self):
        return [h[-1] if h else 0.0 for h in self.auprc_test]

    @property
    def final_train_auprc(self):
        return [h[-1] if h else 0.0 for h in self.auprc_train]


def fake_fit(calls):
    """An ``engine.fit`` stand-in for both packages: records its call and
    reports each trial's :func:`curve` epoch by epoch until pruned."""
    def fit(spec, hp_list, opt_list, data_train, data_test, cfg, **kw):
        calls.append({"hp": hp_list, "opt": opt_list, "train": data_train,
                      "test": data_test, "kw": kw})
        n = len(hp_list)
        full = [curve(o, cfg.num_epochs) for o in opt_list]
        hists, done = [[] for _ in range(n)], [False] * n
        report = kw.get("report_fn")
        for e in range(cfg.num_epochs):
            for t in range(n):
                if done[t]:
                    continue
                hists[t].append(full[t][e])
                if report is not None and report(t, e + 1, full[t][e]):
                    done[t] = True
        init = kw.get("init_params")
        if init is not None:
            params = {k: v + 1 for k, v in to_numpy(init).items()
                      if not isinstance(v, dict)}
            bn = to_numpy(kw.get("init_bn_state") or {})
        else:
            params = {"w": np.asarray([[h[-1], float(o["lr"]), t]
                                       for t, (h, o) in enumerate(zip(hists, opt_list))],
                                      np.float32)}
            bn = {"bn0": {"mean": np.arange(2 * n, dtype=np.float32).reshape(n, 2)}}
        return FakeResult(params, bn, hists)
    return fit


def fake_reset(calls):
    """A ``weight_reset`` stand-in for both packages: records its call and
    shifts every non-BatchNorm leaf by 0.5."""
    def weight_reset(key, spec, hp, old_params, old_bn):
        calls.append({"hp": hp, "params": to_numpy(old_params)})
        return ({k: (v if k.startswith("bn") else np.asarray(v) + 0.5)
                 for k, v in to_numpy(old_params).items()}, to_numpy(old_bn))
    return weight_reset


def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "idx") and hasattr(x, "mask"):     # a BatchPlan
        return {"idx": np.asarray(x.idx).tolist(),
                "mask": np.asarray(x.mask).tolist(),
                "div": int(x.metric_divisor)}
    if isinstance(x, (np.ndarray, np.generic)):
        return np.asarray(x).tolist()
    return x


def same_calls(calls):
    """Both packages made the same fits: groups, hp and opt lists, data,
    and per-trial plans."""
    assert len(calls["jax"]) == len(calls["torch"]) > 0
    for cj, ct in zip(calls["jax"], calls["torch"]):
        assert plain(ct["hp"]) == plain(cj["hp"])
        assert plain(ct["opt"]) == plain(cj["opt"])
        assert plain(ct["train"]) == plain(cj["train"])
        assert plain(ct["test"]) == plain(cj["test"])
        for k in ("train_plans", "eval_plans"):
            assert plain(ct["kw"].get(k)) == plain(cj["kw"].get(k))


def same_checkpoints(dj, dt):
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt))
    for name in names:
        if not name.endswith(".npz"):
            continue
        tj, mj = j_load_ck(os.path.join(dj, name))
        tt, mt = t_load_ck(os.path.join(dt, name))
        assert mj == mt, name
        assert plain(tj) == plain(tt), name
    return names


def same_text_table(got: str, want: str):
    """Two printed tables hold the same cells: words equal, numbers within
    the 6 digits each side prints."""
    a = [line.split() for line in got.strip().splitlines()]
    b = [line.split() for line in want.strip().splitlines()]
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb), (ra, rb)
        for x, y in zip(ra, rb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y
                continue
            assert (np.isnan(fx) and np.isnan(fy)) or abs(fx - fy) <= 1e-6 * max(
                1.0, abs(fy)), (x, y)
