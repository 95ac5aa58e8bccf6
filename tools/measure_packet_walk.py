"""Time the packet walk from the root against the design it replaced and
at other register pins, on one card.

    python3 tools/measure_packet_walk.py

Builds ``csrc/bvh8_walk.cu`` (the library as it ships) and
``tools/packet_walk_variants.cu`` (the old walk, ``walk_kernel``'s loop,
and ``group_walk_kernel`` pinned at 48-72 registers or left free, or in
the while-while order; see tools/packet_walk_variants.py) in parallel.
Then, on the benchmark frame's scene (sponza_proxy) with one-row slots
and, compiled with
``merge_wide_leaves=True``, with two-row (16-record) slots, on
chip_smoke's bounce set (closest hit) and shadow set (occlusion) at 2^18
and 2^22 lanes, holds every variant against the shipped kernel
(``packet_traverse_wide``; dst and prim bit for bit) and times them all in
turns (CUDA events over 10 launches: in order, then reversed).

Prints the card's name and power limit, the ptxas lines of the shipped
walk and of the variants, then one JSON line per (size, slot rows, ray
set).  Needs a CUDA device; imports no JAX.
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
import packet_walk_variants as variants  # noqa: E402
from ray_tracer_tpu_torch.kernels import bvh8, packet  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

RUNS = ("shipped", *variants.VARIANTS)
SIZES = (chip_smoke.N_CHECK, chip_smoke.N_WIDE)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_packet_walk.py needs a CUDA device")
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
                    chip_smoke.ptxas_of(shipped, "group_walk_kernel")],
        "variants": [[w["entry"], *w["lines"][-2:]]
                     for name in ("pinned_walk_kernel", "free_walk_kernel",
                                  "while_walk_kernel", "walk_kernel")
                     for w in chip_smoke.ptxas_of(path, name)],
    }}), flush=True)

    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile()
    sc16 = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile(
        merge_wide_leaves=True)
    for n in SIZES:
        sets = chip_smoke.check_rays(sc, sc.device, n)
        for rows, s in ((1, sc), (2, sc16)):
            recs = s.meta["wide_leaf_recs"]
            if (recs > 8) != (rows == 2):
                raise AssertionError(f"{recs}-record slots for rows {rows}")
            for ray_set, anyhit in (("bounce", False), ("shadow", True)):
                args = (s.wide_packed, s.leaf_rows, *sets[ray_set], recs)
                runs = {"shipped": lambda args=args, anyhit=anyhit:
                        packet.packet_traverse_wide(*args, anyhit=anyhit)}
                for name in variants.VARIANTS:
                    runs[name] = (lambda name=name, args=args, anyhit=anyhit:
                                  variants.run(name, *args, anyhit=anyhit))
                want = runs["shipped"]()
                for name in variants.VARIANTS:
                    variants.compare(f"{name} on {ray_set}, rows {rows}, "
                                     f"{n} lanes", runs[name](), want)
                times = {name: [] for name in RUNS}
                for name in RUNS + RUNS[::-1]:
                    times[name].append(chip_smoke.cuda_ms(runs[name], 10))
                ms = {name: statistics.mean(t) for name, t in times.items()}
                print(json.dumps({
                    "rays": ray_set, "n": n, "rows": rows, "anyhit": anyhit,
                    "device": smi, "equal": True,
                    "active": int((args[4] > -chip_smoke.BIG).sum()),
                    "ms": ms,
                    "vs_shipped": {k: m / ms["shipped"]
                                   for k, m in ms.items()},
                    "ms_runs": times,
                }), flush=True)
        del sets


if __name__ == "__main__":
    main()
