"""Per-bounce occupancy of the port's static scan, and its time, on one
NVIDIA GPU (the port's counterpart of ``tools/measure_occupancy.py``).

    python3 tools/measure_torch_occupancy.py [--width 1920] [--height 1080]
        [--n-tris 260000] [--reps 3] [--cpu]

Traces one sample of every pixel of ``presets.sponza_proxy()`` (bounce
limit 8) through ``wavefront.trace(..., with_profile=True)``, the static
scan, and reads its counts: per bounce, the lanes still alive and the NEE
shadow rays traced, as shares of the lanes.  Times the trace (median of
``--reps`` after one warm-up, ``torch.cuda.synchronize`` around each) and
prints the card's name and power limit, one line per bounce and a JSON
summary line.  ``--cpu`` runs it on the CPU at the size given (use a small
one: ``--width 64 --height 36 --n-tris 8000``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch.api import _camera_arrays  # noqa: E402
from ray_tracer_tpu_torch.integrator import wavefront  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402


def occupancy(scene, cfg):
    """One static-scan sample of every pixel: ``(color, n_rays, alive,
    nee)``, the last two the per-bounce counts as host lists."""
    dev = scene.device
    rot, pos, fov, aspect, near = _camera_arrays(trt.scene_camera(scene),
                                                 cfg, dev)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
    rays = wavefront.raygen(rot, pos, fov, aspect, near, ids, cfg.width,
                            cfg.height)
    color, n_rays, (alive, nee) = wavefront.trace(
        scene, rays, ids, 0, 0, cfg, with_profile=True)
    return color, n_rays, alive.tolist(), nee.tolist()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--n-tris", type=int, default=260_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip())
    scene = presets.sponza_proxy(n_tris_target=args.n_tris).compile(
        device=device)
    cfg = trt.RenderConfig(width=args.width, height=args.height,
                           samples_per_pixel=1, bounce_limit=8,
                           path_regen=False)

    def sync():
        if scene.device.type == "cuda":
            torch.cuda.synchronize()

    occupancy(scene, cfg)  # warm-up: kernel builds, allocator
    times = []
    for _ in range(args.reps):
        sync()
        t0 = time.perf_counter()
        _, n_rays, alive, nee = occupancy(scene, cfg)
        sync()
        times.append(time.perf_counter() - t0)
    n = cfg.n_pixels
    print(f"{'bounce':>6} {'alive%':>8} {'nee%':>8}")
    for j, (a, e) in enumerate(zip(alive, nee)):
        print(f"{j:>6} {100 * a / n:>7.2f}% {100 * e / n:>7.2f}%")
    traced = n + sum(alive) + sum(nee)  # + the camera rays
    static = n * (1 + 2 * len(alive))
    dt = statistics.median(times)
    print(json.dumps({
        "resolution": f"{cfg.width}x{cfg.height}",
        "lanes": n, "alive": alive, "nee": nee,
        "occupancy": traced / static,
        "frame_s": dt, "frame_s_all": times,
        "rays_sem": float(n_rays[0]), "rays_traced": float(n_rays[1]),
        "mrays_sem_per_s": float(n_rays[0]) / dt / 1e6,
        "device": (torch.cuda.get_device_name(0)
                   if scene.device.type == "cuda" else "cpu"),
    }))


if __name__ == "__main__":
    main()
