"""The import check: nothing under wtbench/ imports JAX or the JAX package
(top-level module names compared whole: ``worldtpu_torch`` is allowed), and
the reference imports nothing of the program either."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent.parent


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(base):
    return sorted(p for p in base.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(HERE), ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    found = top_level_imports(path) & {"jax", "jaxlib", "flax", "worldtpu"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sources(HERE / "reference"), ids=lambda p:
                         str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path) & {"worldtpu_torch", "jax", "worldtpu"}
    assert not found, f"{path} imports {found}"


def test_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import worldtpu_torch.api\nfrom jax import numpy\n")
    assert top_level_imports(p) == {"worldtpu_torch", "jax"}


def test_benchmark_reads_nothing_of_the_old_harness():
    old = ("bench", "chip_smoke", "tools", "__graft_entry__")
    for path in sources(HERE):
        text = path.read_text()
        assert not top_level_imports(path) & set(old), path
        assert "BENCH_r0" not in text and "chip_smoke.py\"" not in text
