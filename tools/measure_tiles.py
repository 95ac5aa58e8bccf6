"""Frame time against the tile size on one NVIDIA GPU.

    python3 tools/measure_tiles.py

``render_frame`` splits the image into tiles of
``RenderConfig.max_rays_per_batch`` pixels and traces each tile's
wavefront to its end before the next starts.  This times
``presets.sponza_proxy()`` at 1920x1080, bounce limit 8, at spp 1 (the
viewer's full frame) and spp 2 (the CLI's bench line), with tiles of 2^17
pixels (the JAX package's default, its TPU memory ceiling) and 2^21
pixels (the whole frame in one tile), in turns: 2^17, 2^21, 2^21, 2^17,
three rounds, after one warm-up frame each.  Prints the card's name and
power limit, then one JSON line per (spp, tile) and the ratio.
"""

from __future__ import annotations

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
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

TILES = (1 << 17, 1 << 21)


def frame_s(sc, cfg) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trt.render_frame(sc, cfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_tiles.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    sc = presets.sponza_proxy().compile()
    for spp in (1, 2):
        cfgs = {t: trt.RenderConfig(width=1920, height=1080,
                                    samples_per_pixel=spp, bounce_limit=8,
                                    max_rays_per_batch=t) for t in TILES}
        for cfg in cfgs.values():
            frame_s(sc, cfg)  # warm-up
        times = {t: [] for t in TILES}
        for _ in range(3):
            for t in (TILES[0], TILES[1], TILES[1], TILES[0]):
                times[t].append(frame_s(sc, cfgs[t]))
        med = {t: statistics.median(v) for t, v in times.items()}
        for t in TILES:
            print(json.dumps({"spp": spp, "tile": t,
                              "tiles": -(-1920 * 1080 // t),
                              "frame_s_median": med[t],
                              "frame_s": times[t]}), flush=True)
        print(json.dumps({"spp": spp,
                          "ratio_small_over_whole": med[TILES[0]]
                          / med[TILES[1]]}), flush=True)


if __name__ == "__main__":
    main()
