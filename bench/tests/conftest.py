"""The benchmark's own tests: `python -m pytest -q bench/tests` from the
checkout's root. They import the benchmark and the port from the checkout."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
