"""The benchmark's own tests (``python -m pytest perfbench/tests``): on the
CPU they check the layout, the imports, the yardstick's arithmetic, the
frozen generators and each traffic mix at a tiny size against the
reference; tests marked ``card`` need a CUDA card and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
