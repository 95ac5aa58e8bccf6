"""Time the wavefront round's state permute and NEE resolve against the
kernels they replaced, and the torch round's gather of the lane rows in
each of its forms, on one card.

    python3 tools/measure_permute.py

Builds ``csrc/shade_round.cu`` (the library as it ships) and
``tools/shade_round_variants.cu`` (the old kernels and the TMA floor; see
tools/shade_round_variants.py) in parallel, compiles the benchmark
frame's scene (sponza_proxy) and renders chip_smoke's main frame once
with the permute's and the NEE resolve's arguments captured.  On rounds 0
and 6 of that frame it holds the shipped kernels against their plain
versions and the old kernels, bit for bit, then times them in turns (CUDA
events over 20 launches on arguments packed once: in order, then
reversed), the permute beside the floor (the rows gathered, nothing
unpacked) and torch's ``index_select`` of the rows, each beside its share
of chip_smoke's bound for the round.

Then the torch round (``integrator/wavefront.py::_torch_round``, here the
``bin_mode="leaf"`` frame of chip_smoke's ``config_values``), whose state
permute is torch's own gather, in three forms (GATHERS): ``split``, the
f32 and i32 words as two arrays of 136 B and 24 B rows (as it ships,
``wavefront._gather_lanes``); ``aligned``, the 40-word rows of
``shading.pack_lanes`` as torch allocates them (16-byte aligned);
``offset``, those rows 4 bytes past a 16-byte boundary.  Each form's lanes must equal the others' bit for
bit; each is timed in turns on rounds 0 and 6 of that frame, and whole
frames are timed in turns with each form in place (host clock between two
synchronizes; the images must equal the main frame's).

Prints the card's name and power limit, the ptxas lines of both
libraries' permute and NEE kernels, the permute kernels' registers and
blocks per SM as the runtime reports them, then one JSON line per kernel
and round, per gather round and for the frames.  Needs a CUDA device;
imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import shade_round_variants as variants  # noqa: E402
import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch.integrator import shading, wavefront  # noqa: E402
from ray_tracer_tpu_torch.kernels import shade  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

F32 = torch.float32


def gather_aligned(lanes, order):
    """The 40-word rows as torch allocates them, gathered."""
    return shading.unpack_lanes(shading.pack_lanes(lanes)[order])


def gather_offset(lanes, order):
    """The 40-word rows 4 bytes past a 16-byte boundary, gathered."""
    n = order.shape[0]
    buf = torch.empty(n * shading.ROW + 1, dtype=F32, device=order.device)
    packed_f, packed_i = shading.pack_split(lanes)
    rows = torch.cat([packed_f, packed_i.view(F32)], dim=1,
                     out=buf[1:].view(n, shading.ROW))
    return shading.unpack_lanes(rows[order])


GATHERS = {"split": wavefront._gather_lanes, "aligned": gather_aligned,
           "offset": gather_offset}


def same_lanes(a, b) -> bool:
    return all(torch.equal(x.contiguous().view(torch.int32)
                           if x.is_floating_point() else x,
                           y.contiguous().view(torch.int32)
                           if y.is_floating_point() else y)
               for x, y in zip(a, b))


def kernels(sc) -> None:
    with chip_smoke.captured(shade, "permute_rows") as permutes, \
            chip_smoke.captured(shade, "nee_resolve") as nees:
        trt.render(sc, chip_smoke.frame_cfg())
        torch.cuda.synchronize()
    for r in chip_smoke.CHECK_ROUNDS:
        (packed, order, skey, word), _ = permutes[r]
        n = int(order.shape[0])
        want = shade.permute_rows(packed, order, skey, torch.zeros_like(word))
        variants.compare(
            f"round {r}: permute against the plain version", want,
            shade.permute_rows_reference(packed, order, skey,
                                         torch.zeros_like(word)))
        variants.compare(f"round {r}: permute against the old kernel", want,
                         variants.permute_run("old", packed, order, skey))
        variants.compare(
            f"round {r}: floor",
            [variants.permute_run("floor_tma", packed, order, skey)],
            [packed[order]])
        runs = {name: variants.permute_launcher(name, packed, order, skey)[0]
                for name in ("shipped", "old", "floor_tma")}
        runs["index_select"] = lambda: packed.index_select(0, order)
        ms, times = chip_smoke.turns(runs)
        cost = chip_smoke.permute_cost(packed, order, skey, word)
        print(json.dumps({
            "kernel": "permute", "round": r, "n": n, "equal": True, **cost,
            "floor_bound_ms": chip_smoke.bound(
                chip_smoke.nbytes(packed, order, packed), 0)["bound_ms"],
            "ms": ms, "vs_shipped": {k: m / ms["shipped"]
                                     for k, m in ms.items()},
            "share_of_bound": {k: cost["bound_ms"] / m
                               for k, m in ms.items()},
            "ms_runs": times}), flush=True)

        args, _ = nees[r]
        got = variants.nee_run("shipped", *args)
        variants.compare(f"round {r}: NEE against the plain version", [got],
                         [shade.nee_resolve_reference(*args)])
        variants.compare(f"round {r}: NEE against the old kernel", [got],
                         [variants.nee_run("old", *args)])
        ms, times = chip_smoke.turns(
            {name: variants.nee_launcher(name, *args)[0]
             for name in ("shipped", "old")})
        cost = chip_smoke.nee_cost(*args)
        print(json.dumps({
            "kernel": "nee_resolve", "round": r,
            "n": int(args[1].l_dir.shape[0]), "equal": True, **cost, "ms": ms,
            "share_of_bound": {k: cost["bound_ms"] / m
                               for k, m in ms.items()},
            "ms_runs": times}), flush=True)
    del permutes, nees


def torch_round(sc) -> None:
    cfg = chip_smoke.frame_cfg(routing=trt.Routing(bin_mode="leaf"))
    main = trt.render(sc, chip_smoke.frame_cfg())
    with chip_smoke.captured(wavefront, "_gather_lanes") as calls:
        trt.render(sc, cfg)
        torch.cuda.synchronize()
    shipped = wavefront._gather_lanes
    for r in chip_smoke.CHECK_ROUNDS:
        (lanes, order), _ = calls[r]
        want = shipped(lanes, order)
        for name, fn in GATHERS.items():
            if not same_lanes(fn(lanes, order), want):
                raise AssertionError(f"round {r}: gather {name} differs")
        ms, times = chip_smoke.turns(
            {name: (lambda fn=fn: fn(lanes, order))
             for name, fn in GATHERS.items()})
        print(json.dumps({"gather": r, "n": int(order.shape[0]), "ms": ms,
                          "ms_runs": times}), flush=True)
    del calls
    frames = {name: [] for name in GATHERS}
    try:
        for name in (*GATHERS, *reversed(GATHERS)) * 3:
            wavefront._gather_lanes = GATHERS[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = trt.render(sc, cfg)
            torch.cuda.synchronize()
            frames[name].append(time.perf_counter() - t0)
            if not torch.equal(img, main):
                raise AssertionError(f"torch round, {name}: the frame "
                                     "differs from the main frame")
    finally:
        wavefront._gather_lanes = shipped
    print(json.dumps({"torch_round_frames": {
        "median_s": {k: statistics.median(v) for k, v in frames.items()},
        "s": frames}}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("measure_permute.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda build: build(),
                             (shade.build, variants.build)))
    for lib in libs:
        for name in ("permute", "floor", "nee"):
            for k in chip_smoke.ptxas_of(lib, name):
                print(json.dumps({"ptxas": k["entry"], "lines": [
                    ln for ln in k["lines"]
                    if "registers" in ln or "spill" in ln]}), flush=True)
    print(json.dumps({"info": {v: variants.permute_info(v)
                               for v in ("shipped", *variants.PERMUTES)}}),
          flush=True)
    sc = presets.sponza_proxy(chip_smoke.SCENE_TRIS).compile()
    kernels(sc)
    torch_round(sc)


if __name__ == "__main__":
    main()
