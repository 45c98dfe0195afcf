"""The reference imports nothing of the program, the JAX package, JAX or
the old benchmark; no file of the benchmark imports JAX, the JAX package or
the old benchmark. Top-level names are compared whole: the port's name
begins with the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench.run import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = imported(path) & (FORBIDDEN | {"autostyle_tts_tpu_torch", "portbench"})
    assert not bad, f"{path.name} imports {bad}"


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_forbidden_names_compare_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "autostyle_tts_tpu_torch_x", types.ModuleType("autostyle_tts_tpu_torch_x"))
    assert "autostyle_tts_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert forbidden_modules() == ["jaxlib"]
