"""The benchmark's CPU tests: run from the repository's root with
``python -m pytest rt_bench/tests -q``.  They import no JAX."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
