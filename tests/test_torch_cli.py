"""The port's CLI (``python -m embracenet_tpu_torch``) against the JAX
package's (``tests/test_cli.py``'s raw tree), on the CPU: the same
subcommands and options plus ``--device``; ``preprocess``, ``evaluate`` and
``parity`` print what the JAX CLI prints (``parity`` as text: the same
cells, numbers to the 6 digits each prints); ``train`` and ``sweep`` run
with ``--device cpu``.  And the quickstart's demo writer writes the JAX
quickstart's tables and FASTA text without pandas."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from torch_parity import same_text_table

from embracenet_tpu.__main__ import main as jmain
from embracenet_tpu_torch.__main__ import build_parser
from embracenet_tpu_torch.__main__ import main as tmain
from embracenet_tpu_torch.training.cv import checkpoint_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "active_P_vs_inactive_P"


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The parser ``main`` builds, caught at its ``parse_args``."""
    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as caught:
            main([])
    return caught.value.args[0]


def _describe(parser):
    """{subcommand: {dest: (flags, default, type, choices, required, nargs,
    action)}}"""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.type,
                            a.choices, a.required, a.nargs, type(a).__name__)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_parser_matches_jax_plus_device(monkeypatch):
    got = _describe(_parser_of(tmain, monkeypatch))
    assert got == _describe(build_parser())
    want = _describe(_parser_of(jmain, monkeypatch))
    assert list(got) == list(want) == ["preprocess", "train", "sweep",
                                       "evaluate", "parity"]
    for cmd, opts in want.items():
        extra = {k: v for k, v in got[cmd].items() if k not in opts}
        assert {k: got[cmd][k] for k in opts} == opts, cmd
        if cmd in ("train", "sweep", "evaluate"):
            assert extra == {"device": (("--device",), None, None, None, False,
                                        None, "_StoreAction")}, cmd
        else:
            assert not extra, cmd
    help_text = " ".join(build_parser()._subparsers._group_actions[0].choices[
        "train"].format_help().split())
    assert "TPU" not in help_text and "on for every EmbraceNet fit" in help_text


@pytest.fixture
def data_root(tmp_path, rng):
    from test_api_golden import _write_family

    root = str(tmp_path / "data")
    _write_family(root, "enhancers", 60, rng)
    _write_family(root, "promoters", 200, rng)
    return root


def _out(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def _last_json(text):
    lines = text.splitlines()
    start = max(i for i, line in enumerate(lines) if line == "{")
    return json.loads("\n".join(lines[start:]))


def test_cli_commands_match_jax_on_the_cpu(data_root, tmp_path, capsys,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    tc, jc = str(tmp_path / "tcache"), str(tmp_path / "jcache")

    # preprocess: the same JSON
    got = json.loads(_out(tmain, ["preprocess", "--task", TASK, "--root",
                                  data_root, "--cache-dir", tc], capsys))
    want = json.loads(_out(jmain, ["preprocess", "--task", TASK, "--root",
                                   data_root, "--cache-dir", jc], capsys))
    assert got == want and got["K562"]["rows"] == 200

    # train on the CPU: the JAX CLI's keys
    where = ["--task", TASK, "--root", data_root, "--cache-dir", tc]
    results = str(tmp_path / "r.json")
    scores = _last_json(_out(tmain, [
        "train", "--model", "FFNN", "--cell", "K562", *where,
        "--epochs", "2", "--folds", "2", "--trials", "1", "--sampler", "random",
        "--results", results, "--storage", str(tmp_path / "s.db"),
        "--checkpoint-dir", str(tmp_path / "models"), "--device", "cpu"], capsys))
    assert list(scores) == ["average_CV_AUPRC", "final_test_AUPRC_scores"]
    assert np.isfinite(scores["average_CV_AUPRC"])

    # evaluate that checkpoint: what the JAX CLI prints, within 1e-4
    ck = str(tmp_path / "models" / checkpoint_name("K562", "FFNN", TASK, 0))
    ev = json.loads(_out(tmain, ["evaluate", *where, "--cell", "K562",
                                 "--checkpoint", ck, "--device", "cpu"], capsys))
    jev = json.loads(_out(jmain, ["evaluate", "--task", TASK, "--root",
                                  data_root, "--cache-dir", jc, "--cell", "K562",
                                  "--checkpoint", ck], capsys))
    assert list(ev) == list(jev)
    for k, v in jev.items():
        assert ev[k] == pytest.approx(v, abs=1e-4), k
    # without --device the command runs on the card, and there is none here
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmain(["evaluate", *where, "--cell", "K562", "--checkpoint", ck])

    # sweep on the CPU
    swept = str(tmp_path / "sweep.json")
    out = _out(tmain, ["sweep", "--root", data_root, "--cache-dir", tc,
                       "--cells", "K562", "--tasks", TASK, "--models", "FFNN",
                       "--epochs", "1", "--folds", "2", "--trials", "1",
                       "--sampler", "random", "--results", swept,
                       "--storage", str(tmp_path / "sw.db"),
                       "--checkpoint-dir", str(tmp_path / "sw"),
                       "--device", "cpu"], capsys)
    assert out.strip().endswith(f"results written to {swept}")
    with open(swept) as fh:
        entry = json.load(fh)["K562"][TASK]["FFNN"]
    assert len(entry["final_test_AUPRC_scores"]) == 2

    # parity over the port's results file and a JAX-shaped one
    (tmp_path / "j.json").write_text(json.dumps(
        {"K562": {TASK: {"FFNN": {"average_CV_AUPRC": 0.40}}}}))
    baseline = os.path.join(REPO, "BASELINE.md")
    for path in (results, str(tmp_path / "j.json")):
        argv = ["parity", "--results", path, "--baseline", baseline]
        got, want = _out(tmain, argv, capsys), _out(jmain, argv, capsys)
        same_text_table(got, want)
        assert "K562" in got and "0.3419" in got


def test_python_m_help_exits_0():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "embracenet_tpu_torch",
                           "--help"], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "embracenet_tpu_torch" in proc.stdout and "sweep" in proc.stdout


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_demo_writer_matches_jax(tmp_path):
    jq = _load("jax_quickstart", os.path.join(REPO, "examples", "quickstart.py"))
    tq = _load("torch_quickstart", os.path.join(REPO, "examples",
                                                "torch_quickstart.py"))
    jq.make_demo_data(str(tmp_path / "j"), np.random.default_rng(0))
    tq.make_demo_data(str(tmp_path / "t"), np.random.default_rng(0))
    for family in ("enhancers", "promoters"):
        jd, td = tmp_path / "j" / family, tmp_path / "t" / family
        names = sorted(os.listdir(jd))
        assert names == sorted(os.listdir(td)) and len(names) == 9
        for name in names:
            if name.endswith(".fa"):
                assert (td / name).read_text() == (jd / name).read_text()
                continue
            sep = "\t" if name.endswith(".bed") else ","
            pd.testing.assert_frame_equal(pd.read_csv(td / name, sep=sep),
                                          pd.read_csv(jd / name, sep=sep),
                                          check_exact=True)
