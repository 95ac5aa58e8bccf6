"""Time what each design element of group_walk_kernel buys, on one card.

    python3 tools/measure_group_walk.py

Builds ``csrc/bvh8_walk.cu`` (the library as it ships) and
``tools/group_walk_variants.cu`` (the kernel with each design element
switched, and the eight-lanes-per-ray design) in parallel, then, on the
benchmark frame's scene (sponza_proxy), on chip_smoke's bounce and shadow
sets at 2^18, 2^20 and 2^22 lanes, times ``group_walk_kernel``
("shipped"), each variant, and ``walk_kernel``'s loop ("old", the design
it replaced: the old packet walk with one-row slots, built from
tools/packet_walk_variants.cu).  Every output must equal
the shipped kernel's (``torch.equal``).  CUDA events over 10 launches, in
turns: in order, then in reverse.

Prints the card's name and power limit, the variants' ptxas lines, then
one JSON line per ray set.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import packet_walk_variants  # noqa: E402
from ray_tracer_tpu_torch.kernels import bvh8, group  # noqa: E402
from ray_tracer_tpu_torch.native_build import (  # noqa: E402
    build_shared,
    nvcc_path,
)
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

# rt_group_variant's variant ids, in order (tools/group_walk_variants.cu)
VARIANTS = ("shipped_copy", "fminf_select_minmax", "all_records",
            "direct_descent", "shared_stack", "none", "regs80", "regs48",
            "regs40", "lanes8")
SIZES = (chip_smoke.N_CHECK, 1 << 20, chip_smoke.N_WIDE)
_SRC = os.path.join(REPO, "tools", "group_walk_variants.cu")


def build_variants() -> ctypes.CDLL:
    # keyed by the hash of the variants and of the shipped source they
    # include
    path = build_shared(_SRC, "group_walk_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))
    lib = ctypes.CDLL(path)
    lib.rt_group_variant.restype = ctypes.c_int
    lib.rt_group_variant.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    lib.path = path
    return lib


def wide_depth(nodes) -> int:
    """Wide nodes on the longest root-to-node path of the BVH8 table: the
    shared-memory stacks of the variants hold one word per level."""
    codes = nodes[:, 6:64:8].cpu().numpy()
    level, depth = np.zeros(1, np.int64), 0
    while level.size:
        depth += 1
        child = codes[level]
        level = np.unique(child[child > 0].astype(np.int64))
    return depth


def launch_variant(lib, v, args, anyhit, depth):
    origin = args[2]
    n = origin.shape[0]
    dst = torch.empty(n, dtype=torch.float32, device=origin.device)
    prim = torch.empty(n, dtype=torch.int32, device=origin.device)
    err = lib.rt_group_variant(
        v, int(anyhit), *(t.data_ptr() for t in args), dst.data_ptr(),
        prim.data_ptr(), n, depth,
        torch.cuda.current_stream(origin.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{VARIANTS[v]}: CUDA error {err}")
    return dst, prim


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_group_walk.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(2) as pool:
        shipped = pool.submit(bvh8.build)
        variants = pool.submit(build_variants)
    lib = variants.result()
    print(json.dumps({"ptxas": {
        "shipped": [w["lines"] for w in chip_smoke.ptxas_of(
            shipped.result(), "group_walk_kernel")],
        "variants": [[w["entry"], *w["lines"]]
                     for name in ("variant_walk_kernel", "lanes8_walk_kernel")
                     for w in chip_smoke.ptxas_of(lib.path, name)],
    }}), flush=True)

    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile()
    depth = wide_depth(sc.wide_packed)
    recs = sc.meta["wide_leaf_recs"]
    for n in SIZES:
        rays = chip_smoke.check_rays(sc, sc.device, n)
        for name, anyhit in (("bounce", False), ("shadow", True)):
            args = (sc.wide_packed, sc.leaf_rows, *rays[name])
            runs = {"shipped": lambda: group.group_traverse(
                *args, anyhit=anyhit)}
            for v, k in enumerate(VARIANTS):
                runs[k] = lambda v=v: launch_variant(lib, v, args, anyhit,
                                                     depth)
            runs["old"] = lambda: packet_walk_variants.run(
                "old", *args, recs, anyhit=anyhit)
            want = runs["shipped"]()
            for k, run in runs.items():
                for a, b in zip(run(), want):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{k} differs from the shipped "
                                             f"kernel on {name} at {n} lanes")
            order = list(runs)
            times = {k: [] for k in order}
            for k in order + order[::-1]:
                times[k].append(chip_smoke.cuda_ms(runs[k], 10))
            print(json.dumps({
                "rays": name, "n": n, "anyhit": anyhit, "device": smi,
                "wide_depth": depth,
                "active": int((args[4] > -chip_smoke.BIG).sum()),
                "ms": {k: statistics.mean(v) for k, v in times.items()},
                "ms_runs": times,
            }), flush=True)
        del rays


if __name__ == "__main__":
    main()
