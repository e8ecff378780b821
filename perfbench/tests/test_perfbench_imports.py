"""Nothing under perfbench/ imports JAX, the JAX package `repro` or the
old `benchmarks/` folder, by whole top-level module names (so
`repro_torch` is not `repro`); the plain reference imports nothing of
the program either. A cell's CPU rehearsal in a fresh interpreter ends
with none of them in sys.modules."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path) -> set:
    return _tops(path.read_text(), str(path))


def _tops(source: str, name: str = "<source>") -> set:
    tree = ast.parse(source, filename=name)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def _sources():
    return sorted(PB.rglob("*.py"))


def test_the_check_compares_whole_names():
    assert not _tops("import repro_torch.launch.train\n"
                     "from repro_torch.models import dlrm\n") & FORBIDDEN
    assert _tops("from repro.models import dlrm\n") & FORBIDDEN
    assert _tops("import jax.numpy as jnp\n") & FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_forbidden_import(path):
    assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PB / "reference").glob("*.py")):
        assert "repro_torch" not in _imports(path), path


def test_a_rehearsal_loads_none_of_them():
    code = (
        "import json, sys\n"
        "from perfbench.tests import tiny\n"
        "from perfbench.lib import harness\n"
        "c = tiny.cell('dlrm-criteo.train-resident')\n"
        "line = harness.run(c, 2**31 + 11, 0.5, False, 'cpu')\n"
        "print(json.dumps({'found': harness.forbidden_modules(),\n"
        "                  'correct': line['correct']}))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["found"] == [], got
