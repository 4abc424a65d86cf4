"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level module names compared
whole: the port's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "storage_tpu", "chip_smoke", "flax"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "storage_tpu_torch" not in set(_imports(path))


def test_the_check_sees_the_port_as_itself():
    """``storage_tpu_torch`` starts with ``storage_tpu`` but is not it."""
    from portbench import run

    names = {"storage_tpu_torch", "storage_tpu_torch.ops", "numpy"}
    assert not {n.split(".")[0] for n in names} & run.FORBIDDEN
    assert {n.split(".")[0] for n in {"storage_tpu.engines"}} & run.FORBIDDEN
