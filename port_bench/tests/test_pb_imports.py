"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either.  Top-level module names
are compared whole: ``transmogrifai_tpu_torch`` begins with
``transmogrifai_tpu`` and is not it."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from pb_helpers import ROOT

BENCH = ROOT / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "transmogrifai_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "_cache" not in p.parts)


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_in_the_benchmark(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "transmogrifai_tpu_torch" not in names
        assert "port_bench" not in names  # relative imports of its own only


def test_the_whole_name_is_compared():
    import textwrap
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.py"
        p.write_text(textwrap.dedent("""
            import transmogrifai_tpu_torch.ops
            from transmogrifai_tpu_torch import OpWorkflow
        """))
        assert top_level_imports(p) == {"transmogrifai_tpu_torch"}
        assert not top_level_imports(p) & FORBIDDEN
        p.write_text("import transmogrifai_tpu.ops\n")
        assert top_level_imports(p) & FORBIDDEN


def test_run_imports_with_jax_blocked():
    """run.py and the whole harness import in a process where importing
    jax fails."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"ns = runpy.run_path({str(BENCH / 'run.py')!r}, run_name='pb')\n"
        "import port_bench.harness.cell, port_bench.harness.program\n"
        "import port_bench.reference.pipeline\n"
        "from port_bench.harness.cell import forbidden_modules\n"
        "assert forbidden_modules() == [], forbidden_modules()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == "
        "'transmogrifai_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
