"""No file of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` passes, ``repro`` does not), and the
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FILES = sorted(BENCH.rglob("*.py"))


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imported(path)) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    names = set(imported(path))
    assert "repro_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "bench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("bench"):
            assert node.module.startswith("bench.reference")


def test_whole_name_rule(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.models\nfrom repro.core import x\n")
    assert list(imported(p)) == ["repro_torch", "repro"]
