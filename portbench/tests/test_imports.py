"""What the benchmark's files may import, by each module's whole
top-level name: nothing under portbench/ imports jax, jaxlib, flax or the
JAX package (aacjax); nothing under portbench/reference/ imports the
program (aacjax_torch) either."""
import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "aacjax"}


def top_names(path: pathlib.Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_names(path) & NEVER


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.relative_to(HERE).parts],
    ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    names = top_names(path)
    assert "aacjax_torch" not in names
    assert not names & NEVER


def test_the_scan_sees_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import aacjax_torch.runtime\nfrom jax.numpy import x\n"
                 "import importlib\nimportlib.import_module('aacjax.host')\n")
    assert top_names(f) == {"aacjax_torch", "jax", "importlib", "aacjax"}
