"""The port's public names against the JAX package's, read with ``ast``
(neither package is imported).

For every module of ``embracenet_tpu/`` the port has the module at the
same path under ``embracenet_tpu_torch/``, and there:

* every public top-level name of the JAX module (a def, a class or an
  assignment) is bound in the port's module, by a def, a class, an
  assignment or an import;
* every public member of a public JAX class (a method, ``__init__`` and
  ``__call__`` included, or a class-level field) is a member of the port's
  class; ``__call__`` may be an ``nn.Module``'s ``forward``;
* every parameter of a public JAX function or method is a parameter of
  its counterpart, followed through the port's imports to the def; a
  ``*args`` / ``**kwargs`` matches the port's of the same kind.

What the port leaves out on purpose is allow-listed below, each entry with
the entry of ROADMAP.md's Queue 3 that states the divergence, and each
entry must still be a divergence, so the list stays exact.
"""

from __future__ import annotations

import ast
import functools
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "embracenet_tpu", "embracenet_tpu_torch"

# The stated divergences (ROADMAP.md, Queue 3) ------------------------------
SEEDS = "Integer seeds where JAX takes PRNG keys"
PROGRAMS = "Compiled-program reuse"
#: modules with no counterpart at the same path
MODULES_LEFT_OUT = {
    "ops/pallas/__init__.py": "The TPU kernels' module",
    "ops/pallas/embrace.py": "The TPU kernels' module",
    "utils/jaxcache.py": "Modules of JAX alone",
    "utils/pyc_rescue.py": "Modules of JAX alone",
}
#: (module, name) of top-level names and class members ("Class.member")
NAMES_LEFT_OUT = {
    ("training/engine.py", "key_streams"): SEEDS,
    ("training/modelspec.py", "ModelSpec.init_traced"): SEEDS,
    ("utils/profiling.py", "StepTimer"): "Profiling hooks",
    ("config.py", "TrainConfig.cnn_full_depth"): PROGRAMS,
    ("config.py", "TrainConfig.pad_ffnn_features"): PROGRAMS,
    ("config.py", "CVConfig.share_programs"): PROGRAMS,
}
#: parameters the port leaves out wherever JAX takes them
PARAMS_LEFT_OUT_EVERYWHERE = {"key": SEEDS, "init_keys": SEEDS,
                              "run_keys": SEEDS}
#: (module, function or "Class.method", parameter)
PARAMS_LEFT_OUT = {
    ("training/engine.py", "fit", "shape_targets"): "Batch plans",
    ("parallel/mesh.py", "global_from_host_local", "spec"): "Multi-device",
}


def _modules(pkg: str) -> list[str]:
    root = os.path.join(REPO, pkg)
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = [n for n in dirs if n != "_build"]  # build outputs, not source
        out += [os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


class Params:
    """A def's parameters: the named ones, and whether it takes ``*args``
    and ``**kwargs``."""

    def __init__(self, fn: ast.FunctionDef | ast.AsyncFunctionDef):
        a = fn.args
        self.named = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        self.varargs, self.varkw = a.vararg is not None, a.kwarg is not None

    def missing(self, other: Params) -> list[str]:
        """What of this def's parameters ``other`` lacks."""
        out = [p for p in self.named if p not in other.named]
        if self.varargs and not other.varargs:
            out.append("*args")
        if self.varkw and not other.varkw:
            out.append("**kwargs")
        return out


def _targets(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    out = []
    for t in targets:
        out += [n.id for n in ast.walk(t) if isinstance(n, ast.Name)]
    return out


def _module_path(pkg: str, module: str, node: ast.ImportFrom) -> str | None:
    """The path (under ``pkg``) of the module an ``import from`` names, if
    it is one of ``pkg``'s."""
    if node.level:
        parts = module.split("/")[:-node.level]
        name = "/".join(parts + (node.module or "").split(".")).strip("/")
    elif node.module and node.module.split(".")[0] == pkg:
        name = "/".join(node.module.split(".")[1:])
    else:
        return None
    for cand in (f"{name}.py", f"{name}/__init__.py"):
        if os.path.exists(os.path.join(REPO, pkg, cand)):
            return cand
    return None


@functools.cache
def surface(pkg: str, module: str) -> dict:
    """A module's top-level bindings: ``names`` (every bound name),
    ``own`` (those bound by a def, a class or an assignment), ``defs``
    (name -> Params), ``classes`` (name -> {member: Params or None}),
    ``imports`` (name -> (module, name) of ``pkg``)."""
    with open(os.path.join(REPO, pkg, module)) as fh:
        tree = ast.parse(fh.read())
    out = {"names": set(), "own": set(), "defs": {}, "classes": {},
           "imports": {}}

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out["own"].add(node.name)
                out["defs"][node.name] = Params(node)
            elif isinstance(node, ast.ClassDef):
                out["own"].add(node.name)
                members = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        members[sub.name] = Params(sub)
                    elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                        members.update(dict.fromkeys(_targets(sub)))
                out["classes"][node.name] = members
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                out["own"].update(_targets(node))
            elif isinstance(node, ast.Import):
                out["names"].update((a.asname or a.name).split(".")[0]
                                    for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                src = _module_path(pkg, module, node)
                for a in node.names:
                    out["names"].add(a.asname or a.name)
                    if src:
                        out["imports"][a.asname or a.name] = (src, a.name)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for block in ("body", "orelse", "finalbody"):
                    visit(getattr(node, block, []))
                for handler in getattr(node, "handlers", []):
                    visit(handler.body)

    visit(tree.body)
    out["names"] |= out["own"]
    return out


def port_def(module: str, name: str):
    """The port's Params of ``name`` as ``module`` binds it, through its
    imports; None where it is not a def."""
    s = surface(PORT, module)
    if name in s["defs"]:
        return s["defs"][name]
    if name in s["imports"]:
        return port_def(*s["imports"][name])
    return None


def port_class(module: str, name: str):
    s = surface(PORT, module)
    if name in s["classes"]:
        return s["classes"][name]
    if name in s["imports"]:
        return port_class(*s["imports"][name])
    return None


def _public(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _param_gaps(module: str, where: str, want: Params, got: Params) -> list:
    return [f"{module}: {where}({p})" for p in want.missing(got)
            if p not in PARAMS_LEFT_OUT_EVERYWHERE
            and (module, where, p) not in PARAMS_LEFT_OUT]


def gaps(module: str) -> list[str]:
    """Every public name, member and parameter of the JAX module that the
    port's module lacks, less the stated divergences."""
    jax, port = surface(JAX, module), surface(PORT, module)
    out = []
    for name in sorted(jax["own"]):
        if not _public(name) or (module, name) in NAMES_LEFT_OUT:
            continue
        if name not in port["names"]:
            out.append(f"{module}: {name}")
        elif name in jax["defs"]:
            got = port_def(module, name)
            if got is None:
                out.append(f"{module}: {name} is not a def in the port")
            else:
                out += _param_gaps(module, name, jax["defs"][name], got)
        elif name in jax["classes"]:
            members = port_class(module, name)
            if members is None:
                out.append(f"{module}: {name} is not a class in the port")
                continue
            for m, params in sorted(jax["classes"][name].items()):
                where = f"{name}.{m}"
                if not _public(m) or (module, where) in NAMES_LEFT_OUT:
                    continue
                have = m if m in members else (
                    "forward" if m == "__call__" and "forward" in members
                    else None)
                if have is None:
                    out.append(f"{module}: {where}")
                elif params is not None and members[have] is not None:
                    out += _param_gaps(module, where, params, members[have])
    return out


PORTED = [m for m in _modules(JAX) if m not in MODULES_LEFT_OUT]


def test_every_jax_module_is_either_ported_or_left_out_on_purpose():
    port = set(_modules(PORT))
    missing = [m for m in PORTED if m not in port]
    assert not missing, f"modules with no port: {missing}"


@pytest.mark.parametrize("module", PORTED)
def test_the_port_binds_the_jax_modules_public_names(module):
    assert not gaps(module), "\n".join(gaps(module))


def test_every_stated_divergence_is_still_one():
    """An allow-list entry that the port has since closed must go."""
    port_modules = set(_modules(PORT))
    assert not [m for m in MODULES_LEFT_OUT if m in port_modules]
    closed = []
    for (module, name), why in NAMES_LEFT_OUT.items():
        cls, _, member = name.rpartition(".")
        jax = surface(JAX, module)
        assert (member in jax["classes"][cls]) if cls else (name in jax["own"])
        if (member in (port_class(module, cls) or {})) if cls else (
                name in surface(PORT, module)["names"]):
            closed.append((module, name, why))
    for (module, where, p), why in PARAMS_LEFT_OUT.items():
        cls, _, fn = where.rpartition(".")
        want = (surface(JAX, module)["classes"][cls][fn] if cls
                else surface(JAX, module)["defs"][fn])
        got = ((port_class(module, cls) or {}).get(fn) if cls
               else port_def(module, fn))
        assert p in want.named
        if got is not None and p in got.named:
            closed.append((module, where, p, why))
    everywhere = {p for m in _modules(JAX) for d in surface(JAX, m)["defs"].values()
                  for p in d.named}
    assert set(PARAMS_LEFT_OUT_EVERYWHERE) <= everywhere
    assert not closed, f"allow-list entries the port has closed: {closed}"


def test_every_reason_is_an_entry_of_queue_3():
    """Each allow-list reason opens a bold entry of ROADMAP.md's Queue 3."""
    with open(os.path.join(REPO, "ROADMAP.md")) as fh:
        text = fh.read()
    queue3 = text.split("### Queue 3", 1)[1].split("\n#", 1)[0]
    reasons = {*MODULES_LEFT_OUT.values(), *NAMES_LEFT_OUT.values(),
               *PARAMS_LEFT_OUT_EVERYWHERE.values(), *PARAMS_LEFT_OUT.values()}
    assert not [r for r in reasons if f"**{r}" not in queue3]
