"""Time the rope walk against the design it replaced and with each of its
design elements switched off, on one card.

    python3 tools/measure_rope_walk.py

Builds ``csrc/lanewalk.cu`` (the library as it ships) and
``tools/rope_walk_variants.cu`` (the old kernel on the old 64 B-row
streams, and rope_walk_kernel with each element switched; see
tools/rope_walk_variants.py) in parallel.  Then, on the benchmark frame's
scene (sponza_proxy, compiled with its rope streams; the old streams
built from the same tree), on chip_smoke's bounce set (closest hit) and
shadow set (occlusion) at 2^18 and 2^22 lanes, holds every variant
against the shipped kernel (``lanewalk_traverse``; dst and prim bit for
bit) and times them all in turns (CUDA events over 10 launches: in order,
then reversed).  Beside them, the shipped kernel and the old one with the
L2 cleared before every launch (a 256 MiB fill, outside the timed span):
how much of each kernel's streams the L2 keeps from one launch to the
next.

Prints the card's name and power limit, the ptxas lines of the shipped
walk and of the variants, the streams' sizes, then one JSON line per
(size, ray set).  Needs a CUDA device; imports no JAX.
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
import rope_walk_variants as variants  # noqa: E402
from ray_tracer_tpu_torch.kernels import lanewalk  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

SIZES = (chip_smoke.N_CHECK, chip_smoke.N_WIDE)
RUNS = ("shipped", *variants.VARIANTS)


def cold_ms(fn, reps: int, flush) -> float:
    """Mean device milliseconds of ``fn()``, the L2 cleared by ``flush()``
    before each call (outside the timed span)."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_rope_walk.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(2) as pool:
        shipped, path = pool.map(lambda build: build(),
                                 (lanewalk.build, variants.build))
    print(json.dumps({"ptxas": {
        "shipped": [[w["entry"], *w["lines"][-2:]] for w in
                    chip_smoke.ptxas_of(shipped, "rope_walk_kernel")],
        "variants": [[w["entry"], *w["lines"][-2:]]
                     for name in ("old_lanewalk_kernel", "copy_rope_kernel",
                                  "variant_rope_kernel", "free_rope_kernel")
                     for w in chip_smoke.ptxas_of(path, name)],
    }}), flush=True)

    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile(
        rope_streams=True)
    rows = sc.meta["rope_rows"]
    old = variants.old_streams(sc)
    print(json.dumps({
        "rope_rows": rows, "rope_bytes": chip_smoke.nbytes(sc.rope_streams),
        "tri_packed_bytes": chip_smoke.nbytes(sc.tri_packed),
        "old_rope_rows": old[1], "old_rope_bytes": chip_smoke.nbytes(old[0]),
    }), flush=True)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=sc.device)
    flush = lambda: scratch.fill_(1)  # noqa: E731
    for n in SIZES:
        sets = chip_smoke.check_rays(sc, sc.device, n)
        for ray_set, anyhit in (("bounce", False), ("shadow", True)):
            o, d, tmax0 = sets[ray_set]
            # every run finds the rays' octants itself; the shipped one
            # takes a flag, read after the timing, so that its time holds
            # no host read (as on the route)
            flag = lanewalk.error_flag(sc.device)
            runs = {"shipped": lambda o=o, d=d, t=tmax0, a=anyhit, f=flag:
                    lanewalk.lanewalk_traverse(
                        sc.rope_streams, sc.tri_packed, rows, o, d, t,
                        anyhit=a, err=f)}
            for name in variants.VARIANTS:
                streams, n_rows = (old if name in variants.OLD_LAYOUT
                                   else (sc.rope_streams, rows))
                runs[name] = (lambda name=name, s=streams, r=n_rows, o=o,
                              d=d, t=tmax0, a=anyhit: variants.run(
                                  name, s, sc.tri_packed, r, o, d, t,
                                  anyhit=a))
            want = runs["shipped"]()
            for name in variants.VARIANTS:
                variants.compare(f"{name} on {ray_set}, {n} lanes",
                                 runs[name](), want)
            times = {name: [] for name in RUNS}
            for name in RUNS + RUNS[::-1]:
                times[name].append(chip_smoke.cuda_ms(runs[name], 10))
            ms = {name: statistics.mean(t) for name, t in times.items()}
            cold = {"shipped": [], "old": []}
            for name in ("shipped", "old", "old", "shipped"):
                cold[name].append(cold_ms(runs[name], 10, flush))
            print(json.dumps({
                "rays": ray_set, "n": n, "anyhit": anyhit, "device": smi,
                "equal": True,
                "active": int((tmax0 > -chip_smoke.BIG).sum()),
                "ms": ms,
                "vs_shipped": {k: m / ms["shipped"] for k, m in ms.items()},
                "l2_cleared_ms": cold,
                "ms_runs": times,
            }), flush=True)
            lanewalk.raise_on_flag(int(flag.item()), rows)
        del sets


if __name__ == "__main__":
    main()
