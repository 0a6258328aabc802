"""Nothing the benchmark runs imports JAX, the JAX package or the old
harnesses, by whole top-level name; the reference imports nothing of the
program."""

import ast
import sys
import types

import pytest

from h100_bench import run
from bench_tiny import BENCH

RUN_FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", RUN_FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    names = imported_top_names(path)
    assert not names & set(run.FORBIDDEN), path
    if "reference" in path.parts:
        assert "fast_dit_torch" not in names, path
        assert not any(isinstance(n, ast.ImportFrom) and n.level >= 2
                       for n in ast.walk(ast.parse(path.read_text()))), path


def test_the_run_time_check_compares_whole_names(monkeypatch):
    for name in ("fast_dit_tpu_extra", "benchmarks_old", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setattr(sys, "modules", {k: v for k, v in sys.modules.items()
                                         if k.split(".")[0] not in run.FORBIDDEN})
    assert run.forbidden_modules() == []
    sys.modules["fast_dit_tpu.models"] = types.ModuleType("fast_dit_tpu.models")
    sys.modules["bench"] = types.ModuleType("bench")
    assert run.forbidden_modules() == ["bench", "fast_dit_tpu"]
