"""Time the round's shade wrapper (``kernels/shade.py::shade_round``:
its checks, output allocations, argument packing and launch) against the
kernel alone, for one or more checkouts of the port in turns, on one card.

    python3 tools/measure_shade_wrapper.py [--root DIR ...]

Each ``--root`` is a checkout's root (default: this one).  For every root
in order, then in reverse (two roots: A, B, B, A), a child process imports
that checkout's package, compiles sponza_proxy, renders chip_smoke's main
frame (1920x1080, spp 2, bounce limit 8) once with ``shade_round``'s
arguments captured, and on rounds 0 and 6 times, three times each:

* ``wrapper_ms``: 20 calls of ``shade_round`` by CUDA events, the time
  chip_smoke's ``kernel_vs_plain`` line gives (host-bound where the
  host's work outlasts the kernel's);
* ``kernel_ms``: 20 launches of the kernel on arguments packed once;
* ``args_us``: the host microseconds of one ``shade_args`` call (the
  wrapper's Python work, no launch), over 200 calls.

Prints the card's name and power limit, one JSON line per child and
round, then one summary line with each root's means.  Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = (0, 6)
REPS = 3


def child(root: str) -> None:
    """One checkout's measurement (see the module's docstring)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import ray_tracer_tpu_torch as trt
    from ray_tracer_tpu_torch.kernels import shade
    from ray_tracer_tpu_torch.scene import presets

    def cuda_ms(fn, reps=20):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    sc = presets.sponza_proxy(260_000).compile()
    cfg = trt.RenderConfig(width=1920, height=1080, samples_per_pixel=2,
                           bounce_limit=8, max_rays_per_batch=1 << 21)
    calls = []
    fn = shade.shade_round
    shade.shade_round = lambda *a: calls.append(a) or fn(*a)
    try:
        trt.render(sc, cfg)
    finally:
        shade.shade_round = fn
    torch.cuda.synchronize()
    lib = shade._load()
    for r in ROUNDS:
        c, w = calls[r]
        args, out = shade.shade_args(c, w)
        stream = torch.cuda.current_stream().cuda_stream
        kernel = lambda: lib.rt_shade_round(ctypes.byref(args), stream)
        wrapper = lambda: shade.shade_round(c, w)
        rec = {"wrapper_ms": [], "kernel_ms": [], "args_us": []}
        for _ in range(REPS):
            rec["wrapper_ms"].append(cuda_ms(wrapper))
            rec["kernel_ms"].append(cuda_ms(kernel))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                shade.shade_args(c, w)
            rec["args_us"].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        print(json.dumps({"root": root, "round": r,
                          "n": int(w.origin.shape[0]), **rec}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", action="append", default=None)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        child(args.child)
        return 0
    roots = args.root or [REPO]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    recs = []
    for root in roots + roots[::-1]:
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], capture_output=True,
                             text=True)
        if got.returncode != 0:
            print(got.stderr[-4000:], file=sys.stderr)
            return got.returncode
        for line in got.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                recs.append(json.loads(line))
    summary = {}
    for root in roots:
        for r in ROUNDS:
            mine = [x for x in recs if x["root"] == root and x["round"] == r]
            summary[f"{root} round {r}"] = {
                k: statistics.mean(v for x in mine for v in x[k])
                for k in ("wrapper_ms", "kernel_ms", "args_us")}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
