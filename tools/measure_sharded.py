"""Frame time of the sharded render against the mesh shape, one process
per NVIDIA GPU.

    torchrun --nproc-per-node 4 tools/measure_sharded.py
    python3 tools/measure_sharded.py          # a world of one

Every rank compiles ``presets.sponza_proxy()`` on its card and renders the
benchmark frame (1920x1080, spp 2, bounce limit 8) with
``parallel/mesh.py::render_frame_sharded`` on each (data, sample) mesh the
world allows: (n, 1), (n/2, 2) where n is even, and (1, n) where n
divides the spp.  Per mesh: one warm-up frame (the NCCL communicators'
set-up), then the median of three (``torch.cuda.synchronize`` and a
barrier around each).  Rank 0 prints the card's name and power limit and
one JSON line per mesh: its frame seconds, and the images' largest
difference from the first mesh's.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch.parallel import mesh  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402


def main() -> None:
    rank, world, device = mesh.init_from_env()
    try:
        if rank == 0:
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip(), flush=True)
        t0 = time.perf_counter()
        sc = presets.sponza_proxy().compile(device=device)
        compile_s = time.perf_counter() - t0
        cfg = trt.RenderConfig(width=1920, height=1080, samples_per_pixel=2,
                               bounce_limit=8)
        shapes = [(world, 1)]
        if world % 2 == 0 and world > 2:
            shapes.append((world // 2, 2))
        if world > 1 and cfg.samples_per_pixel % world == 0:
            shapes.append((1, world))
        first = None
        for n_data, n_sample in shapes:
            m = mesh.make_mesh(n_data=n_data, n_sample=n_sample)
            times = []
            for i in range(4):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                img = mesh.render_frame_sharded(sc, cfg, m)
                torch.cuda.synchronize()
                dist.barrier()
                if i:
                    times.append(time.perf_counter() - t0)
                else:
                    setup_s = time.perf_counter() - t0
            first = img if first is None else first
            if rank == 0:
                print(json.dumps({
                    "mesh": [n_data, n_sample], "world": world,
                    "frame_s": statistics.median(times),
                    "frame_s_all": times, "first_frame_s": setup_s,
                    "compile_s": compile_s,
                    "image_mean": float(img.mean()),
                    "max_abs_diff_vs_first_mesh": float(
                        (img - first).abs().max()),
                    "device": torch.cuda.get_device_name(device),
                }), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
