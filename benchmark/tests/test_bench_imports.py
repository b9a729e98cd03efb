"""No module of the benchmark imports JAX or the JAX package, the
reference imports nothing of the port, and the run's check of loaded
modules compares top-level names whole."""

import ast
import os
import sys
import types

from benchmark import harness

PORT = "manigaussian_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    top = os.path.join(harness.HERE, sub)
    for d, _, fs in os.walk(top):
        if "tests" in d.split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in fs if f.endswith(".py"))


def test_nothing_imports_jax_or_the_jax_package():
    for f in _files():
        assert not set(_imports(f)) & set(harness.FORBIDDEN), f


def test_reference_and_traffic_import_nothing_of_the_port():
    for sub in ("reference", "traffic"):
        for f in _files(sub):
            assert PORT not in set(_imports(f)), f


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".fake", types.ModuleType("x"))
    assert "manigaussian_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "manigaussian_tpu.fake",
                        types.ModuleType("y"))
    assert "manigaussian_tpu" in harness.forbidden_modules()
