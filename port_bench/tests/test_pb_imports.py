"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""
import ast
import subprocess
import sys

from conftest import PB

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        assert not {n for n in _imports(path) if n.startswith("repro")}, path


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "from conftest import run_small, TRAIN, SERVE; run_small(TRAIN); run_small(SERVE);"
            "from harness import cell; print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(PB / "tests"), str(PB)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
