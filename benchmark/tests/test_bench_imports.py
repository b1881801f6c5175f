"""What the benchmark imports: nothing of JAX or of the JAX package
anywhere it runs (top-level names compared whole: the port's name begins
with the JAX package's), and nothing of the port in the reference or the
frozen yardstick."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "embracenet_tpu"}
PORT = "embracenet_tpu_torch"


def _top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py")
                 if "out" not in p.relative_to(HERE).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in
                                  ("reference", "frozen")],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_yardstick_stand_apart_from_the_port(path):
    assert PORT not in _top_levels(path)


def test_a_run_loads_no_jax():
    """A whole run of a cell cut to the CPU's size, in a process of its own:
    nothing it loaded has a forbidden top-level name."""
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(2)\n"
            "from benchmark.tests.tiny import tiny_cell\n"
            "from benchmark import run as R\n"
            "R.run(tiny_cell('embracenet-bf16'), 7, 0.5, True,"
            " 'cpu', time.perf_counter())\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % str(HERE.parent))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert PORT in loaded and not loaded & FORBIDDEN
