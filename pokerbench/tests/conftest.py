"""Settings of the benchmark's own tests (CPU; the card's tests are marked
`cuda` and skip without a card):

    python3 -m pytest pokerbench/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips elsewhere")
