"""What the benchmark's modules import, compared by whole top-level names:
no JAX and no module of the JAX package anywhere under ``benchmark/``;
nothing of the program in the plain reference or the yardstick; the port
only under ``benchmark/program/``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py"))


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module)
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "ldpc_tpu"}, tops


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py"))
                         + sorted((BENCH / "yardstick").glob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_takes_nothing_of_the_program(path):
    names = _imports(path)
    assert not {n for n in names if n.split(".")[0] == "ldpc_tpu_torch"}
    assert not {n for n in names if n.split(".")[:2] in (["benchmark", "program"],
                                                          ["benchmark", "drivers"])}


def test_only_program_module_imports_the_port():
    """No driver, metric, reference, yardstick or harness file imports the
    port: the files that do are exactly those under ``program/``."""
    users = [p.relative_to(BENCH).as_posix() for p in FILES
             if p.relative_to(BENCH).parts[0] != "tests"
             and any(n.split(".")[0] == "ldpc_tpu_torch" for n in _imports(p))]
    assert users == [p.relative_to(BENCH).as_posix()
                     for p in sorted((BENCH / "program").rglob("*.py"))]
    assert users
