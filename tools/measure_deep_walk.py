"""Time what each design element of deep_walk_kernel buys, on one card.

    python3 tools/measure_deep_walk.py

Builds ``csrc/bvh8_walk.cu`` (the library as it ships) and
``tools/deep_walk_variants.cu`` (the DEEP walk before its redesign, "old",
and deep_walk_kernel with each design element switched; see
tools/deep_walk_variants.py) in parallel.  Then, on the benchmark frame's
scene (sponza_proxy), on the two DEEP launches (rounds 1 and 2) that the
two-phase route makes for chip_smoke's bounce set (closest hit) and shadow
set (occlusion) at 2^18 rays, holds every variant against the shipped
kernel (dst and prim bit for bit; the nearest-first variant, which visits
the entries in another order: hit masks equal, dst and the hit triangle
equal on all but 1e-3 of the lanes, see deep_walk_variants.compare_near)
and times them all in turns
(CUDA events over 10 launches: in order, then reversed).

Prints the card's name and power limit, the ptxas lines of the shipped
DEEP kernel and of the variants, then one JSON line per launch.  Needs a
CUDA device; imports no JAX.
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
import deep_walk_variants as variants  # noqa: E402
from ray_tracer_tpu_torch.kernels import bvh8, packet  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

RUNS = ("shipped", *variants.VARIANTS)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_deep_walk.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(2) as pool:
        shipped, path = pool.map(lambda build: build(),
                                 (bvh8.build, variants.build))
    print(json.dumps({"ptxas": {
        "shipped": [[w["entry"], *w["lines"][-2:]] for w in
                    chip_smoke.ptxas_of(shipped, "deep_walk_kernel")],
        "variants": [[w["entry"], *w["lines"][-2:]]
                     for name in ("variant_deep_kernel", "old_deep_kernel")
                     for w in chip_smoke.ptxas_of(path, name)],
    }}), flush=True)

    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile()
    leaf_map = sc.leaf_map.long()
    box = torch.from_numpy(variants.entry_boxes(
        sc.wide_packed.cpu().numpy())).to(sc.device)
    sets = chip_smoke.check_rays(sc, sc.device)
    for ray_set, anyhit in (("bounce", False), ("shadow", True)):
        calls = variants.route_deep_calls(sc, *sets[ray_set], anyhit=anyhit)
        for round_, (args, kw) in enumerate(calls, 1):
            runs = {"shipped": lambda args=args, kw=kw:
                    packet.packet_traverse_wide(*args, **kw)}
            for name in variants.VARIANTS:
                runs[name] = lambda name=name, args=args, kw=kw: \
                    variants.run(name, *args, **kw, entry_box=box)
            want = runs["shipped"]()
            ties = {}
            for name in variants.VARIANTS:
                if name in variants.NEAR_ORDER:
                    ties[name] = variants.compare_near(
                        f"{name} on {ray_set} round {round_}", runs[name](),
                        want, leaf_map)
                else:
                    variants.compare(f"{name} on {ray_set} round {round_}",
                                     runs[name](), want)
            times = {name: [] for name in RUNS}
            for name in RUNS + RUNS[::-1]:
                times[name].append(chip_smoke.cuda_ms(runs[name], 10))
            ms = {name: statistics.mean(t) for name, t in times.items()}
            tmax0 = args[4]
            print(json.dumps({
                "rays": ray_set, "round": round_, "anyhit": anyhit,
                "device": smi, "lanes": int(tmax0.numel()),
                "live": int((tmax0 > 0).sum()), "equal": True,
                "near_order_differs": ties, "ms": ms,
                "vs_shipped": {n: m / ms["shipped"] for n, m in ms.items()},
                "ms_runs": times,
            }), flush=True)


if __name__ == "__main__":
    main()
