"""The benchmark's own tests: ``python -m pytest -p no:cacheprovider flagbench/tests -q``.

Tests that need the card are marked ``cuda`` and skip without one.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
