"""The benchmark's tests import it as the ``benchmarks`` package from the
checkout's root, and run on the CPU with a small thread pool."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
