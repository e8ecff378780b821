"""The benchmark's own tests: run from the repository root with
`python -m pytest -q perfbench/tests` (the card's are marked `gpu` and
skip without one)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
