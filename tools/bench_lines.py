"""The bench's line on each route and on the scaled proxy, one process
each, on one NVIDIA GPU.

    python3 tools/bench_lines.py                 # every run below
    python3 tools/bench_lines.py default narrow  # the runs named

Runs ``python -m ray_tracer_tpu_torch.bench`` with each environment of
:data:`RUNS` added (the default route; ``RT_TWO_PHASE=1``,
``RT_LANEWALK=force``, ``RT_WIDE=0``, ``RT_CLUSTER=on``; and
``RT_BENCH_SCENE=sponza_proxy:1500000``) and prints the card's name and
power limit, then one JSON object per run: its exit code, its process
seconds, and its line, or the end of its stderr where it printed none.
Exits non-zero when any run failed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "default": {},
    "two_phase": {"RT_TWO_PHASE": "1"},
    "lanewalk": {"RT_LANEWALK": "force"},
    "narrow": {"RT_WIDE": "0"},
    "cluster": {"RT_CLUSTER": "on"},
    "sponza_proxy_1500000": {"RT_BENCH_SCENE": "sponza_proxy:1500000"},
}


def main() -> int:
    names = sys.argv[1:] or list(RUNS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    failed = 0
    for name in names:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "ray_tracer_tpu_torch.bench"],
            capture_output=True, text=True, cwd=REPO, timeout=1800,
            env={**os.environ, **RUNS[name]})
        rec = {"run": name, "env": RUNS[name], "rc": out.returncode,
               "process_s": time.perf_counter() - t0}
        lines = out.stdout.strip().splitlines()
        if out.returncode == 0 and lines:
            rec["line"] = json.loads(lines[-1])
        else:
            failed += 1
            rec["stderr"] = out.stderr[-3000:]
        print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
