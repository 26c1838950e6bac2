"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program: module names compared whole by their
top-level name (tpurag_torch begins with tpurag and is not it)."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "tpurag"}


def imported_tops(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((PKG / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert "tpurag_torch" not in tops and not tops & FORBIDDEN, f
        assert tops <= {"__future__", "collections", "math", "re", "numpy",
                        "torch", "portbench"}, (f, tops)


def test_loaded_modules_by_whole_top_level_name():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import runpy; run = runpy.run_path(%r)\n"
        "import portbench.harness, portbench.control\n"
        "import portbench.reference.bm25, portbench.reference.dense\n"
        "import portbench.reference.fusion\n"
        "import tpurag_torch\n"
        "from portbench import harness\n"
        "for m in harness.load_cell('kb100k-hybrid-b512')['per_layer']:\n"
        "    harness.load_reader(m['name'])\n"
        "bad = run['loaded_forbidden']()\n"
        "assert 'tpurag_torch' in sys.modules and not bad, bad\n"
        "print('ok')\n" % (str(ROOT), str(PKG / "run.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    code_ref = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.bm25, portbench.reference.dense\n"
        "import portbench.reference.fusion, portbench.reference.tokenizer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpurag', 'tpurag_torch')]\n"
        "assert not bad, bad\nprint('ok')\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code_ref],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
