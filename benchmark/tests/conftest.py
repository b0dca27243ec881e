"""The benchmark's own tests. Those marked ``card`` need the CUDA cards a
cell asks for and skip without them (the test decides, never the import);
run them on a machine with the card:

    python3 -m pytest benchmark/tests -m card -q
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the cell's CUDA cards; skips without them")
