"""No module of the benchmark imports JAX or the JAX package, and the plain
reference and the generators import nothing of the port.  Names are
compared by their whole top-level part, so ``repro_torch`` is never taken
for ``repro``."""

import ast

import pytest

from bench.fixtures import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
# the yardstick beside the port: nothing of the port may reach it
PLAIN = [BENCH / "reference.py", BENCH / "roofline.py",
         *sorted((BENCH / "generators").glob("*.py"))]


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", PLAIN, ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"torch", "typing", "__future__", "bench"}


def test_whole_names_are_compared():
    from bench import harness

    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    import sys

    assert "repro" not in {m.split(".")[0] for m in sys.modules if m.startswith("repro_torch")}
