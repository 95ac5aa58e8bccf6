"""Run one cell of the benchmark of ray_tracer_tpu_torch on this machine's
card and print its result as the last line of standard output.

    python3 rt_bench/run.py --workload sponza_flat.progressive1080 \\
        --seed 1 --seconds 15 --trace 0

See ``rt_bench/harness.py`` for what a run does.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rt_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
