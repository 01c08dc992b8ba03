"""What the benchmark imports, compared by whole top-level module names.

Nothing under rtbench/ imports JAX or the JAX package (the port's name
begins with the JAX package's, so names are compared whole); the
reference side (rtbench/reference/) imports nothing of the port either.
"""

from __future__ import annotations

import ast
import os

import pytest

from rtbench import harness

JAX_SIDE = {"jax", "jaxlib", "flax", "rust_wgpu_raytracing_tpu"}
PORT = "rust_wgpu_raytracing_tpu_torch"


def _sources(sub=""):
    top = os.path.join(harness.HERE, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_names(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


def test_top_names_are_whole():
    assert "rust_wgpu_raytracing_tpu" not in {PORT.split(".")[0]}
    assert PORT.startswith("rust_wgpu_raytracing_tpu")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_anywhere(path):
    assert not _top_names(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_takes_nothing_of_the_program(path):
    assert not _top_names(path) & (JAX_SIDE | {PORT})


def test_run_refuses_a_process_holding_jax(monkeypatch):
    import sys
    import types

    from rtbench import run

    monkeypatch.setitem(sys.modules, PORT + ".ops", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "rust_wgpu_raytracing_tpu.core",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax", "rust_wgpu_raytracing_tpu"]
