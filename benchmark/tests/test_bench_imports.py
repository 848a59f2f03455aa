"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port: module names compared whole, by
their top-level part."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(ROOT.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "tpu_inspect"}


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert "tpu_inspect_torch" not in top_level_imports(path)


def test_the_port_name_is_not_the_jax_package():
    assert "tpu_inspect_torch".split(".")[0] != "tpu_inspect"
