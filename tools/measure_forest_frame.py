"""Time the forest frame of one checkout of the port, on one card.

    python3 tools/measure_forest_frame.py [CHECKOUT]

Imports ``ray_tracer_tpu_torch`` from CHECKOUT (a directory holding the
package; default: this repository), compiles ``sponza_proxy`` as a forest
(``flatten_instances=False``) and renders chip_smoke's benchmark frame
(1920x1080, spp 2, bounce limit 8, one whole-frame tile, frame index 1):
a warm-up frame, then three timed frames (host clock between two
``torch.cuda.synchronize()`` calls), then one frame under
``torch.profiler`` for the card's kernel launches.  Rounds are counted
by wrapping the integrator's two round functions.  Prints the card's name
and power limit and one JSON line: the frame times, the image's sum, the
port's own launch counts of one frame, the rounds and the kernel launches
a round.  To compare two checkouts in one call, run it on each in turns
(parent, change, change, parent), one process each.  Needs a CUDA device;
imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

CHECKOUT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, CHECKOUT)

import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch import bench  # noqa: E402
from ray_tracer_tpu_torch.integrator import wavefront  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

TIMED = 3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_forest_frame.py needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    if not trt.__file__.startswith(CHECKOUT):
        raise SystemExit(f"imported {trt.__file__}, not from {CHECKOUT}")
    rounds = {"n": 0}
    for name in ("_fused_round", "_torch_round"):
        fn = getattr(wavefront, name)

        def counted(*args, fn=fn, **kw):
            rounds["n"] += 1
            return fn(*args, **kw)

        setattr(wavefront, name, counted)
    t0 = time.perf_counter()
    sc = presets.sponza_proxy().compile(flatten_instances=False)
    compile_s = time.perf_counter() - t0
    cfg = trt.RenderConfig(width=1920, height=1080, samples_per_pixel=2,
                           bounce_limit=8, max_rays_per_batch=1 << 21)
    trt.render(sc, cfg)  # warm-up: builds the kernels
    torch.cuda.synchronize()
    times = []
    for k in range(TIMED):
        if k == 0:
            bench.reset_launches()
            rounds["n"] = 0
        t0 = time.perf_counter()
        img = trt.render(sc, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if k == 0:
            launches = {m: v for m, v in bench.all_launches().items() if v}
            n_rounds = rounds["n"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trt.render(sc, cfg)
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps({
        "checkout": CHECKOUT, "n_objects": sc.meta["n_objects"],
        "compile_s": compile_s, "frame_s": statistics.median(times),
        "frame_s_all": times, "checksum": float(img.sum()),
        "finite": bool(torch.isfinite(img).all()), "launches": launches,
        "rounds": n_rounds, "kernels": kernels,
        "kernels_per_round": kernels / n_rounds}), flush=True)


if __name__ == "__main__":
    main()
