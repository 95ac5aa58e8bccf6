"""Time the TOP walk of two-phase traversal against the design it replaced
and with each of its design elements switched off, on one card.

    python3 tools/measure_top_walk.py

Builds ``csrc/bvh8_walk.cu`` (the library as it ships) and
``tools/top_walk_variants.cu`` (the old walk, walk_kernel's TOP mode, and
top_walk_kernel with each element switched; see tools/top_walk_variants.py)
in parallel.  Then, on the benchmark frame's scene (sponza_proxy) at the
route's top_k, on chip_smoke's bounce set (closest hit) and shadow set
(occlusion) at 2^18 and 2^22 lanes, as the two-phase route hands them to
its TOP walk, holds every variant against the shipped kernel
(``packet_traverse_wide`` with ``top_k`` and the scene's TOP table; dst,
prim, slots and ovf bit for bit) and times them all in turns (CUDA events
over 10 launches: in order, then reversed); and, on the bounce set at
2^18, the shipped kernel, the old walk and the rows written in place at
top_k 1, 5, 16, 120, 300 and 400 (the block sizes that stage the rows,
and past them).

Prints the card's name and power limit, the ptxas lines of the shipped
walk and of the variants, the TOP table's size, then one JSON line per
(size, ray set) and per top_k.  Needs a CUDA device; imports no JAX.
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
import ray_tracer_tpu_torch as trt  # noqa: E402
import top_walk_variants as variants  # noqa: E402
from ray_tracer_tpu_torch.kernels import bvh8, packet  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

SIZES = (chip_smoke.N_CHECK, chip_smoke.N_WIDE)
TOP_KS = (1, 5, 16, 120, 300, 400)
# the variants at every top_k (the others stage the rows, which has no
# launch past 384)
ANY_K = ("old", "rows_in_place")


def timed(runs) -> dict:
    """Every run of ``runs`` timed in turns: in order, then reversed."""
    names = tuple(runs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(chip_smoke.cuda_ms(runs[name], 10))
    ms = {name: statistics.mean(t) for name, t in times.items()}
    return dict(ms=ms, vs_shipped={k: m / ms["shipped"]
                                   for k, m in ms.items()},
                ms_runs=times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_top_walk.py needs a CUDA device")
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
                    chip_smoke.ptxas_of(shipped, "top_walk_kernel")],
        "variants": [[w["entry"], *w["lines"][-2:]]
                     for name in ("11walk_kernel", "variant_top_kernel",
                                  "free_top_kernel")
                     for w in chip_smoke.ptxas_of(path, name)],
    }}), flush=True)

    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile()
    tables = variants.scene_args(sc)
    recs = sc.meta["wide_leaf_recs"]
    k = trt.Routing().top_k
    print(json.dumps({"top_rows": int(sc.wide_top.shape[0]),
                      "top_bytes": chip_smoke.nbytes(sc.wide_top),
                      "W": int(sc.wide_packed.shape[0]),
                      "n_treelets": sc.meta["n_treelets"]}), flush=True)

    def shipped_run(o, d, tmax0, top_k, anyhit):
        return packet.packet_traverse_wide(
            sc.wide_packed, sc.leaf_rows, o, d, tmax0, recs, anyhit=anyhit,
            top_k=top_k, troot=sc.wide_troot, wide_top=sc.wide_top)

    def variant_run(name, o, d, tmax0, top_k, anyhit):
        return variants.run(name, *tables, o, d, tmax0, recs, top_k,
                            anyhit=anyhit)

    for n in SIZES:
        sets = chip_smoke.check_rays(sc, sc.device, n)
        for ray_set, anyhit in (("bounce", False), ("shadow", True)):
            o, d, tmax0 = sets[ray_set]
            runs = {"shipped": lambda o=o, d=d, t=tmax0, a=anyhit:
                    shipped_run(o, d, t, k, a)}
            for name in variants.VARIANTS:
                runs[name] = (lambda name=name, o=o, d=d, t=tmax0, a=anyhit:
                              variant_run(name, o, d, t, k, a))
            want = runs["shipped"]()
            for name in variants.VARIANTS:
                variants.compare(f"{name} on {ray_set}, {n} lanes",
                                 runs[name](), want)
            print(json.dumps({
                "rays": ray_set, "n": n, "top_k": k, "anyhit": anyhit,
                "device": smi, "equal": True,
                "active": int((tmax0 > -chip_smoke.BIG).sum()),
                "mean_entries": float((want[2] >= 0).sum()) / n,
                "overflow_share": float((want[3] > 0).float().mean()),
                **timed(runs),
            }), flush=True)
        if n == chip_smoke.N_CHECK:
            o, d, tmax0 = sets["bounce"]
            for top_k in TOP_KS:
                runs = {"shipped": lambda o=o, d=d, t=tmax0, kk=top_k:
                        shipped_run(o, d, t, kk, False)}
                for name in ANY_K:
                    runs[name] = (lambda name=name, o=o, d=d, t=tmax0,
                                  kk=top_k: variant_run(name, o, d, t, kk,
                                                        False))
                want = runs["shipped"]()
                for name in ANY_K:
                    variants.compare(f"{name} at top_k {top_k}",
                                     runs[name](), want)
                print(json.dumps({
                    "rays": "bounce", "n": n, "top_k": top_k,
                    "device": smi, "equal": True,
                    "overflow_share": float((want[3] > 0).float().mean()),
                    **timed(runs),
                }), flush=True)
        del sets


if __name__ == "__main__":
    main()
