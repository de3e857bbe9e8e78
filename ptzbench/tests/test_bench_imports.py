"""What the benchmark's modules import: no ``jax``, ``jaxlib``, ``flax`` or
``ptzjax`` anywhere (top-level names compared whole: ``ptzjax_torch`` is
not ``ptzjax``), nothing of ``ptzjax_torch`` in the reference or the
yardstick, and nothing that reads ``benchmarks/`` or ``bench.py``."""

from __future__ import annotations

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ptzjax"}
# the yardstick: may not import the program either
YARDSTICK = ("reference", "frames.py", "generator.py", "roofline.py", "check.py", "registry.py", "trace.py", "metrics")


def _modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imported(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_top_level_names_are_compared_whole():
    assert "ptzjax_torch".split(".")[0] not in FORBIDDEN and "ptzjax.slam".split(".")[0] in FORBIDDEN


def test_no_module_imports_jax_or_ptzjax():
    bad = {str(p.relative_to(BENCH)): _imported(p) & FORBIDDEN for p in _modules()}
    assert not {k: v for k, v in bad.items() if v}


def test_yardstick_and_reference_import_nothing_of_the_program():
    for p in _modules():
        rel = p.relative_to(BENCH)
        if rel.parts[0] in YARDSTICK:
            assert "ptzjax_torch" not in _imported(p), rel


def test_nothing_reads_the_jax_packages_benchmarks():
    for p in _modules():
        if p.name == Path(__file__).name:
            continue
        text = p.read_text()
        assert "bench.py" not in text.replace("ptzbench", "") and "benchmarks/" not in text.replace("benchmarks/soak.py", ""), p


def test_a_run_leaves_no_forbidden_module_loaded():
    import subprocess
    import sys

    code = (
        "import ptzbench.run, ptzbench.check, ptzbench.calibrate, ptzbench.program, ptzbench.roofline, ptzbench.trace; "
        "print(ptzbench.run.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
