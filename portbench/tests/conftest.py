"""Tests of the benchmark's harness: ``python -m pytest -q portbench/tests``
from the repository's root (the CPU; ``-m gpu`` on a card)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
