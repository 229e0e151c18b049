"""No module of the benchmark imports JAX or the JAX package, compared by
the whole top-level name; the references import nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "multiverso_tpu"}
MODULES = sorted(BENCH.rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_and_no_program_in_references(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    if path.relative_to(BENCH).parts[0] == "reference":
        assert "multiverso_tpu_torch" not in names, path


def test_the_scan_sees_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import multiverso_tpu_torch.models\n"
                     "from jax import numpy\n")
    names = set(_imports(probe))
    assert names == {"multiverso_tpu_torch", "jax"}
    assert names & FORBIDDEN == {"jax"}
