"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
repository root (CPU; the card's cases skip without one)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parents[1]), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
