"""Time the cluster route's chunk kernels, their walk settings and the
design they replaced, on one card.

    python3 tools/measure_cluster_test.py

Builds ``tools/cluster_test_variants.cu`` (the kernels before the
redesign, the shipped kernels' walk at other settings: chunks per tile of
a block's walk, most blocks per SM; see tools/cluster_test_variants.py)
and the package's libraries, in parallel.  Then, on the benchmark frame's
scene (sponza_proxy), on the chunks the cluster route builds for
chip_smoke's camera, bounce and shadow sets at 2^18 lanes (each slice of
2^17: the cluster test of the packet enumeration, both box levels of the
box enumeration), times every variant against the shipped entry points of
the same library in turns (CUDA events over 10 launches: in order, then
reversed).  Every output must equal the package's kernel's
(``torch.equal``).

Prints the card's name and power limit, the variants' ptxas lines, then
one JSON line per chunk set.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import cluster_test_variants as variants  # noqa: E402
from ray_tracer_tpu_torch.kernels import bvh8, cluster  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

RUNS = ("shipped", *variants.VARIANTS)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_cluster_test.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(3) as pool:
        path, _, _ = pool.map(lambda build: build(),
                              (variants.build, cluster.build, bvh8.build))
    print(json.dumps({"ptxas": [
        [w["entry"], *w["lines"][-2:]] for kernel in ("walk_kernel", "old_kernel",
                                       "cluster_pairs_kernel",
                                       "box_hits_kernel")
        for w in chip_smoke.ptxas_of(path, kernel)]}), flush=True)

    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile(clusters=True)
    sets = chip_smoke.check_rays(sc, sc.device)
    for ray_set, anyhit in (("camera", False), ("bounce", False),
                            ("shadow", True)):
        for kernel, slice_, args in variants.route_chunks(
                sc, *sets[ray_set], anyhit=anyhit):
            if kernel == "cluster_pairs":
                want = cluster.cluster_pairs_test(*args)
                runs = {name: (lambda name=name: variants.cluster_pairs(
                    name, *args)) for name in RUNS}
            else:
                want = (cluster.box_hits(*args),)
                runs = {name: (lambda name=name: (variants.box_hits(
                    name, *args),)) for name in RUNS}
            ids = args[2]
            for name, run in runs.items():
                for a, b in zip(run(), want):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name} differs on {ray_set} "
                                             f"{kernel} slice {slice_}")
            times = {name: [] for name in runs}
            for name in RUNS + RUNS[::-1]:
                times[name].append(chip_smoke.cuda_ms(runs[name], 10))
            ms = {name: statistics.mean(t) for name, t in times.items()}
            print(json.dumps({
                "rays": ray_set, "kernel": kernel, "slice": slice_,
                "chunks": int(ids.numel()),
                "live_chunks": int((ids >= 0).sum()), "equal": True,
                "ms": ms,
                "vs_shipped": {n: m / ms["shipped"] for n, m in ms.items()},
                "ms_runs": times,
            }), flush=True)


if __name__ == "__main__":
    main()
