"""Nothing under port_bench imports JAX or the JAX package, and the
references import nothing of the program (top-level names compared whole:
the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not top_level_imports(f) & JAX, f


def test_the_whole_names_are_compared(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch\nfrom repro_torch.serve import Session\n"
                     "from repro.serve import x\n")
    assert top_level_imports(probe) == {"repro_torch", "repro"}
    assert top_level_imports(probe) & JAX == {"repro"}


def test_references_import_nothing_of_the_program():
    for f in sorted((PKG / "reference").glob("*.py")):
        assert "repro_torch" not in top_level_imports(f), f
        text = f.read_text()
        assert "repro_torch" not in text, f


def test_run_refuses_the_jax_package_after_the_window():
    import sys

    from port_bench import run

    assert run.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & JAX)
    sys.modules["repro"] = type(sys)("repro")
    try:
        assert run.forbidden_modules() == ["repro"]
    finally:
        del sys.modules["repro"]
