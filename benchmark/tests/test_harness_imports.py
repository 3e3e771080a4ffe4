"""The import boundary: no benchmark module imports JAX or the JAX
package (compared by whole top-level names: the port's name begins with
the JAX package's), the reference imports nothing of the program, and
the load generator imports neither torch nor the program."""

import ast

import pytest

from benchmark import harness

FILES = sorted(p for p in harness.BENCH_DIR.rglob("*.py")
               if "tests" not in p.relative_to(harness.BENCH_DIR).parts)


def top_names(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.partition(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.BENCH_DIR)))
def test_no_jax(path):
    assert not top_names(path) & set(harness.BANNED)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        assert "sonet_torch" not in top_names(path), path
        assert "benchmark" not in top_names(path), path


def test_load_generator_is_stdlib_and_numpy():
    names = top_names(harness.BENCH_DIR / "traffic" / "loadgen.py")
    assert names <= {"concurrent", "http", "io", "json", "sys", "time",
                     "numpy"}


def test_banned_names_are_whole_top_level_names():
    import sys
    import types
    sys.modules["sonet_tpu_like"] = types.ModuleType("sonet_tpu_like")
    try:
        assert "sonet_tpu" not in harness.banned_modules()
        assert "sonet_torch" not in harness.BANNED
    finally:
        del sys.modules["sonet_tpu_like"]
