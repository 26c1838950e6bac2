"""tpurag_torch stands alone: importing it pulls in neither jax nor tpurag,
and no module of it, nor chip_smoke.py, imports them."""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "tpurag_torch"
MODULES = sorted(str(p.relative_to(PKG.parent)) for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts) + ["chip_smoke.py"]


def test_import_leaves_jax_out():
    code = ("import sys, tpurag_torch, tpurag_torch.api.knowledge_base, "
            "tpurag_torch.eval.bench; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'tpurag.')) or m == 'tpurag']; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax_or_tpurag(module):
    tree = ast.parse((PKG.parent / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "tpurag"), (module, name)
