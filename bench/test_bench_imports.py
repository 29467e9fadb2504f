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


def dynamic_imports(path: Path):
    """The leading constant text of each ``import_module`` call's module
    name ("" where it starts with no constant)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            yield str(arg.value) if isinstance(arg, ast.Constant) else ""


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    """The reference imports the standard library's plainest modules,
    torch and its own files; a module it imports by name (a family's
    ``Ref``) is one of its own files too."""
    names = set(imported(path))
    assert "repro_torch" not in names
    assert names <= {"__future__", "importlib", "math", "typing", "torch",
                     "bench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("bench"):
            assert node.module.startswith("bench.reference")
    for prefix in dynamic_imports(path):
        assert prefix.startswith("bench.reference."), prefix


def test_whole_name_rule(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.models\nfrom repro.core import x\n")
    assert list(imported(p)) == ["repro_torch", "repro"]


def test_dynamic_import_prefix(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import importlib\n"
                 "importlib.import_module(f'bench.reference.{n}')\n"
                 "importlib.import_module(f'repro_torch.{n}')\n"
                 "importlib.import_module(name)\n")
    assert list(dynamic_imports(p)) == ["bench.reference.", "repro_torch.",
                                        ""]
