"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, traffic mix, driver, limit and metric by name."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run as R

ROOT = R.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_units_and_texts(group):
    entries = BENCH[group]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end" and group != "per_layer":
                assert TEXT.match(e[key]), (e["name"], key)
        for k in e.get("reduced", []):
            assert NAME.match(k)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in ends
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in ends and TEXT.match(m["layer"])


def test_every_cell_reports_what_the_contract_asks():
    ends = BENCH["end_to_end"]
    for w in BENCH["workloads"]:
        c = R.cell(w["name"])
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"]
        for m in c["per_layer"]:
            moved = next(e for e in ends if e["name"] == m["moves"])
            assert w["name"] in moved.get("workloads", [w["name"]])


def test_every_piece_is_found_by_name():
    for w in BENCH["workloads"]:
        c = R.cell(w["name"])
        assert c["driver"].exists()
        assert c["config"]["name"] == w["config"]
        assert set(c["limits"]) and all(v > 0 for v in c["limits"].values())
        for path in c["metric_files"].values():
            mod = R.load_module(path, "m_" + path.stem.replace(".", "_"))
            assert callable(mod.read)


def test_a_new_config_mix_and_metric_are_new_files_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries are found; no file the benchmark has changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    here = tmp_path / "benchmark"
    conf = json.loads((here / "configs" / "embracenet-hepg2.json").read_text())
    conf["name"] = "embracenet-k562"
    conf["in_features"] = 52
    (here / "configs" / "embracenet-k562.json").write_text(json.dumps(conf))
    mix = json.loads((here / "traffic" / "train-pop8-f32.json").read_text())
    mix["batch_size"] = 50
    (here / "traffic" / "train-pop8-f32-b50.json").write_text(json.dumps(mix))
    (here / "limits" / "embracenet-k562.train-pop8-f32-b50.json").write_text(
        json.dumps({"loss_gap": 0.1}))
    (here / "metrics" / "kernels_per_window.py").write_text(
        "def read(rec):\n    return rec.get('answer')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "embracenet-k562", "source": "x",
                             "file": "benchmark/configs/embracenet-k562.json",
                             "reduced": [], "why": "x"})
    new = "embracenet-k562.train-pop8-f32-b50"
    bench["workloads"].append({"name": new, "config": "embracenet-k562",
                               "traffic": "train-pop8-f32-b50", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "train_windows_per_s":
            m["workloads"].append(new)
    bench["per_layer"].append({"name": "kernels_per_window", "unit": "kernels",
                               "better": "lower", "source": "device_trace",
                               "layer": "Engine", "moves": "train_windows_per_s",
                               "workloads": [new]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = R.cell(new, root=tmp_path)
    assert c["config"]["in_features"] == 52
    assert c["traffic"]["batch_size"] == 50
    assert [m["name"] for m in c["per_layer"]] == ["kernels_per_window"]
    assert R.per_layer(c, {"answer": 7.0}) == {
        "kernels_per_window": {"value": 7.0, "unit": "kernels"}}
    assert R.per_layer(c, {}) == {}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_without_a_card_the_run_fails_and_prints_nothing():
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                           "--workload", BENCH["workloads"][0]["name"],
                           "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True,
                          cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                                         "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
