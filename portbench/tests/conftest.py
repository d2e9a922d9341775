"""The benchmark's CPU tests: the repository root (for ``portbench``) and
``src`` (for the program under test) on the path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
