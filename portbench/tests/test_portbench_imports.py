"""Nothing of the benchmark imports JAX or the JAX package, its reference
imports nothing of the program, and of the harness's sources only the
program kinds (``programs/``) import the program, inside their functions.
Top-level module names are compared whole: ``raytracer_tpu_torch`` is not
``raytracer_tpu``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "raytracer_tpu"}
PROGRAM = "raytracer_tpu_torch"
SOURCES = sorted(BENCH.rglob("*.py"))


def imported_tops(path: Path):
    """The top-level names every import in ``path`` names."""
    yield from tops_of(ast.parse(path.read_text(), filename=str(path)))


def tops_of(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def test_sources_found():
    names = {p.relative_to(BENCH).as_posix() for p in SOURCES}
    assert {"run.py", "harness.py", "reference/plain.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(BENCH).as_posix()
                              for p in SOURCES])
def test_no_jax(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    tops = set(imported_tops(path))
    assert PROGRAM not in tops
    assert not tops & FORBIDDEN


HARNESS = [p for p in SOURCES
           if p.relative_to(BENCH).parts[0] not in ("programs", "tests")]


@pytest.mark.parametrize("path", HARNESS,
                         ids=[p.relative_to(BENCH).as_posix()
                              for p in HARNESS])
def test_only_program_kinds_import_the_program(path):
    assert PROGRAM not in set(imported_tops(path))


@pytest.mark.parametrize("path", sorted(
    p for p in (BENCH / "programs").glob("*.py") if p.name != "__init__.py"),
    ids=lambda p: p.name)
def test_program_kinds_import_the_program_inside_functions(path):
    """Nothing at a kind's top level imports the program: the benchmark's
    tests import the kinds where the program is absent."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert PROGRAM not in set(tops_of(ast.Module(top, [])))
    assert PROGRAM in set(tops_of(tree))


def test_top_names_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import raytracer_tpu_torch.core\nimport jaxtyping\n"
                 "from raytracer_tpu.core import x\n")
    tops = set(imported_tops(f))
    assert tops & FORBIDDEN == {"raytracer_tpu"}
    assert PROGRAM in tops and "jaxtyping" in tops
