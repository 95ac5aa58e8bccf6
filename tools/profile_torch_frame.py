"""Profile the benchmark frame of ray_tracer_tpu_torch, one route at a time.

    python3 tools/profile_torch_frame.py \
        [group|packet|cluster|cluster_boxes|narrow|lanewalk|two_phase ...]

The frame is chip_smoke.py's (sponza_proxy, 1920x1080, spp 2, bounce limit
8, one whole-frame tile).  For each route: one warm-up frame, then one
frame of bench.py's measure (frame index 1) under ``torch.profiler``.
Prints one JSON line per route: wall seconds, device busy seconds (the
union of the kernels' intervals), the idle share, the kernel launches,
and device milliseconds by kernel (the top 12, and the port's own CUDA
kernels with their launches).  The profiler inflates host time, so the idle share is an
upper bound.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch.api import _camera_arrays, scene_camera  # noqa: E402
from ray_tracer_tpu_torch.integrator import wavefront  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

ROUTES = {
    "group": trt.Routing(),
    "packet": trt.Routing(groups=0, anyhit_group=False),
    "cluster": trt.Routing(cluster="on"),
    "cluster_boxes": trt.Routing(cluster="on", cluster_enum="boxes"),
    "narrow": trt.Routing(wide=False),
    "lanewalk": trt.Routing(lanewalk="force"),
    "two_phase": trt.Routing(two_phase=True),
}
# the port's CUDA kernels, by a part of their names ("walk_kernel" matches
# both kernels of bvh8_walk.cu, group_walk_kernel and walk_kernel in every
# mode, emit, TOP and DEEP included, and bvh2_walk_kernel and lanewalk_kernel)
OWN_KERNELS = ("walk_kernel", "cluster_pairs_kernel",
               "box_hits_kernel")


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main(routes) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    sc = presets.sponza_proxy().compile(
        clusters=True, rope_streams="lanewalk" in routes)
    dev = sc.device
    for name in routes:
        cfg = trt.RenderConfig(width=1920, height=1080, samples_per_pixel=2,
                               bounce_limit=8, max_rays_per_batch=1 << 21,
                               routing=ROUTES[name])
        cam = _camera_arrays(scene_camera(sc), cfg, dev)
        ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
        run = lambda: wavefront.trace_wave(sc, *cam, ids, 1, 0, 2, cfg)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = defaultdict(float)
        count = defaultdict(int)
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        busy = union_us((e.time_range.start, e.time_range.end)
                        for e in kernels) / 1e6
        # names cut to 90 characters; kernels that share a prefix are summed
        short = defaultdict(float)
        for k, v in by_name.items():
            short[k[:90]] += v
        top = sorted(short.items(), key=lambda kv: -kv[1])[:12]
        own = {k: v / 1e3 for k, v in by_name.items()
               if any(o in k for o in OWN_KERNELS)}
        print(json.dumps({
            "route": name, "device": smi, "wall_s": wall, "busy_s": busy,
            "idle_share": 1.0 - busy / wall, "launches": len(kernels),
            "own_kernels_ms": own,
            "own_kernels_launches": {k: count[k] for k in own},
            "top_ms": {k: v / 1e3 for k, v in top},
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["group"])
