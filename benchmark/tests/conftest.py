"""The benchmark's own tests: on the host, and marked ``card`` where they
need the CUDA card (they skip without one, deciding inside the test).

    python3 -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
