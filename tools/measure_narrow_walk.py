"""Time what each design element of the narrow walk buys, on one card.

    python3 tools/measure_narrow_walk.py

Builds ``csrc/bvh2_walk.cu`` (the kernel as it ships) and
``tools/narrow_walk_variants.cu`` (the narrow walk before its redesign,
"old", and bvh2_walk_kernel with each design element switched; see
tools/narrow_walk_variants.py) in parallel.  Then, on the benchmark
frame's scene (sponza_proxy), on chip_smoke's bounce set (closest hit)
and shadow set (closest hit clipped at the light, as the narrow route
answers occlusion) at 2^18 and 2^22 lanes, holds every variant against
the shipped kernel (``packet_traverse``; all five outputs bit for bit)
and times them all in turns (CUDA events over 10 launches: in order,
then reversed).

Prints the card's name and power limit, the ptxas lines of the shipped
kernel and of the variants, then one JSON line per (size, ray set).
Needs a CUDA device; imports no JAX.
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
import narrow_walk_variants as variants  # noqa: E402
from ray_tracer_tpu_torch.kernels import packet  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

RUNS = ("shipped", *variants.VARIANTS)
SIZES = (chip_smoke.N_CHECK, chip_smoke.N_WIDE)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_narrow_walk.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(2) as pool:
        shipped, path = pool.map(lambda build: build(),
                                 (packet.build_narrow, variants.build))
    print(json.dumps({"ptxas": {
        "shipped": [[w["entry"], *w["lines"][-2:]] for w in
                    chip_smoke.ptxas_of(shipped, "bvh2_walk_kernel")],
        "variants": [[w["entry"], *w["lines"][-2:]]
                     for name in ("variant_bvh2_kernel", "old_bvh2_kernel")
                     for w in chip_smoke.ptxas_of(path, name)],
    }}), flush=True)

    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile()
    tables = (sc.bvh_packed, sc.bvh_axis, sc.tri_packed)
    root = (sc.meta["bvh_root"], sc.meta["bvh_root_word"])
    for n in SIZES:
        sets = chip_smoke.check_rays(sc, sc.device, n)
        for ray_set in ("bounce", "shadow"):
            args = (*tables, *sets[ray_set], *root)
            runs = {"shipped": lambda args=args:
                    packet.packet_traverse(*args)}
            for name in variants.VARIANTS:
                runs[name] = lambda name=name, args=args: variants.run(
                    name, *args)
            want = runs["shipped"]()
            for name in variants.VARIANTS:
                variants.compare(f"{name} on {ray_set} at {n} lanes",
                                 runs[name](), want)
            times = {name: [] for name in RUNS}
            for name in RUNS + RUNS[::-1]:
                times[name].append(chip_smoke.cuda_ms(runs[name], 10))
            ms = {name: statistics.mean(t) for name, t in times.items()}
            print(json.dumps({
                "rays": ray_set, "n": n, "device": smi, "equal": True,
                "active": int((args[5] > -chip_smoke.BIG).sum()),
                "ms": ms,
                "vs_shipped": {k: m / ms["shipped"] for k, m in ms.items()},
                "ms_runs": times,
            }), flush=True)
        del sets


if __name__ == "__main__":
    main()
