"""The CPU tests of the benchmark (`python -m pytest portbench/tests` from
the root of the repo); the one marked `cuda` runs on the card and skips
elsewhere."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
