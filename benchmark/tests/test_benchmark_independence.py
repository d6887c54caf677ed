"""Nothing under benchmark/ imports JAX or the JAX package (top-level
names compared whole: gatv2_tpu_torch starts with gatv2_tpu), nor the
program's bench or tools; benchmark/reference/ imports nothing of the
program."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gatv2_tpu"}
MODULES = sorted(BENCH.rglob("*.py"))


def imported(path):
    """The dotted names a module imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
                for alias in node.names:
                    yield f"{node.module}.{alias.name}"
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_walk_finds_the_harness():
    names = {p.relative_to(BENCH).as_posix() for p in MODULES}
    assert {"run.py", "reference/gatv2.py", "correct.py"} <= names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_and_no_program_bench(path):
    for name in imported(path):
        top = name.split(".", 1)[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"
        assert not name.startswith("gatv2_tpu_torch.bench"), name
        assert top != "tools", f"{path.name} imports {name}"


@pytest.mark.parametrize(
    "path", [p for p in MODULES if "reference" in p.parts],
    ids=lambda p: p.relative_to(BENCH).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        assert name.split(".", 1)[0] != "gatv2_tpu_torch", (
            f"{path.name} imports {name}")


def test_whole_names_are_compared():
    from benchmark.harness import FORBIDDEN_MODULES

    assert "gatv2_tpu_torch".split(".", 1)[0] not in FORBIDDEN_MODULES
    assert "gatv2_tpu" in FORBIDDEN_MODULES
