"""Profile the benchmark frame of ray_tracer_tpu_torch, one route at a time.

    python3 tools/profile_torch_frame.py [--root DIR] [--stages] \
        [group|packet|cluster|cluster_boxes|narrow|lanewalk|two_phase ...]

The frame is chip_smoke.py's (sponza_proxy, 1920x1080, spp 2, bounce limit
8, one whole-frame tile).  For each route: one warm-up frame, then one
frame of bench.py's measure (frame index 1) under ``torch.profiler``.
Prints one JSON line per route: wall seconds, device busy seconds (the
union of the kernels' intervals), the idle share, the kernel launches,
and device milliseconds by kernel (the top 12, and the port's own CUDA
kernels with their launches).  The profiler inflates host time, so the idle share is an
upper bound.  Needs a CUDA device; imports no JAX.

``--root DIR`` profiles the package of another checkout (an unpacked
parent commit, say) with this script.  ``--stages`` also splits the
device time of the frame by stage of the wavefront round: each kernel
goes to the stage whose call launched it, the outermost where calls nest
(``traverse.traverse`` and ``_occlusion``: traversal; ``_bin_order`` and
``torch.argsort``: sort, the key included;
``_shade_fetch``, ``shading.shade_lanes`` and ``shade.shade_round``:
shade; ``shade.permute_rows``: permute; ``_analytic_nee``,
``_resolve_direct`` and ``shade.nee_resolve``: NEE resolve, each where the
checkout has it), by the CPU time of its launch inside a
``record_function`` span around that call (the chrome trace's
correlation ids); a kernel launched outside them goes by its name: sorts
to sort, concatenations and index gathers (the torch round's packed
state permute) to permute, the rest (the round's other torch ops, the
device-to-host read of the live count) to shade.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import functools
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

ROUTES = {
    "group": {},
    "packet": dict(groups=0, anyhit_group=False),
    "cluster": dict(cluster="on"),
    "cluster_boxes": dict(cluster="on", cluster_enum="boxes"),
    "narrow": dict(wide=False),
    "lanewalk": dict(lanewalk="force"),
    "two_phase": dict(two_phase=True),
}
# the port's CUDA kernels, by a part of their names ("walk_kernel" matches
# the four kernels of bvh8_walk.cu, group_walk_kernel (the group route and
# the packet walk from the root), deep_walk_kernel, emit_walk_kernel and
# top_walk_kernel, and bvh2_walk_kernel and rope_walk_kernel)
OWN_KERNELS = ("walk_kernel", "cluster_pairs_kernel",
               "box_hits_kernel", "shade_kernel", "permute_kernel",
               "nee_resolve_kernel")
# --stages: stage -> the (module, function) calls whose launches it takes
STAGE_CALLS = {
    "traversal": (("ray_tracer_tpu_torch.ops.traverse", "traverse"),
                  ("ray_tracer_tpu_torch.integrator.wavefront",
                   "_occlusion")),
    "sort": (("ray_tracer_tpu_torch.integrator.wavefront", "_bin_order"),
             ("torch", "argsort"), ("torch", "sort")),
    "shade": (("ray_tracer_tpu_torch.integrator.wavefront", "_shade_fetch"),
              ("ray_tracer_tpu_torch.integrator.shading", "shade_lanes"),
              ("ray_tracer_tpu_torch.kernels.shade", "shade_round")),
    "permute": (("ray_tracer_tpu_torch.kernels.shade", "permute_rows"),),
    "nee_resolve": (("ray_tracer_tpu_torch.integrator.wavefront",
                     "_analytic_nee"),
                    ("ray_tracer_tpu_torch.integrator.wavefront",
                     "_resolve_direct"),
                    ("ray_tracer_tpu_torch.kernels.shade", "nee_resolve")),
}


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


@contextlib.contextmanager
def stage_spans():
    """Wrap each call of STAGE_CALLS (where the package has it) in a
    ``record_function`` span named ``stage:<stage>``."""
    undo = []
    for stage, calls in STAGE_CALLS.items():
        for mod_name, fn_name in calls:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                continue
            fn = getattr(mod, fn_name, None)
            if fn is None:
                continue

            def spanned(*a, _fn=fn, _stage=stage, **kw):
                with torch.profiler.record_function(f"stage:{_stage}"):
                    return _fn(*a, **kw)

            functools.update_wrapper(spanned, fn)
            setattr(mod, fn_name, spanned)
            undo.append((mod, fn_name, fn))
    try:
        yield
    finally:
        for mod, fn_name, fn in undo:
            setattr(mod, fn_name, fn)


def stage_of_name(name: str) -> str:
    low = name.lower()
    if "sort" in low:
        return "sort"
    if "catarray" in low or "index" in low or "gather" in low:
        return "permute"
    return "shade"


def split_stages(trace_path: str) -> dict:
    """Device milliseconds and launches by stage, from a chrome trace of
    a frame profiled under :func:`stage_spans`."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("stage:"))
    starts = [sp[0] for sp in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    ms, n = defaultdict(float), defaultdict(int)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memset", "gpu_memcpy"):
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        stage = None
        if ts is not None:
            k = bisect.bisect_right(starts, ts)
            inside = [sp for sp in spans[max(0, k - 64):k] if sp[1] >= ts]
            if inside:  # the outermost span holding the launch
                stage = max(inside, key=lambda sp: sp[1] - sp[0])[2]
        stage = stage or stage_of_name(e.get("name", ""))
        ms[stage] += e["dur"] / 1e3
        n[stage] += 1
    return {"stage_ms": dict(ms), "stage_launches": dict(n)}


def main(routes, stages=False) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    import ray_tracer_tpu_torch as trt
    from ray_tracer_tpu_torch.api import _camera_arrays, scene_camera
    from ray_tracer_tpu_torch.integrator import wavefront
    from ray_tracer_tpu_torch.scene import presets

    sc = presets.sponza_proxy().compile(
        clusters=True, rope_streams="lanewalk" in routes)
    dev = sc.device
    for name in routes:
        cfg = trt.RenderConfig(width=1920, height=1080, samples_per_pixel=2,
                               bounce_limit=8, max_rays_per_batch=1 << 21,
                               routing=trt.Routing(**ROUTES[name]))
        cam = _camera_arrays(scene_camera(sc), cfg, dev)
        ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
        run = lambda: wavefront.trace_wave(sc, *cam, ids, 1, 0, 2, cfg)
        run()
        torch.cuda.synchronize()
        spans = stage_spans() if stages else contextlib.nullcontext()
        with spans, profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = defaultdict(float)
        count = defaultdict(int)
        for e in kernels:
            by_name[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        busy = union_us((e.time_range.start, e.time_range.end)
                        for e in kernels) / 1e6
        # names cut to 90 characters; kernels that share a prefix are summed
        short = defaultdict(float)
        for k, v in by_name.items():
            short[k[:90]] += v
        top = sorted(short.items(), key=lambda kv: -kv[1])[:12]
        own = {k: v / 1e3 for k, v in by_name.items()
               if any(o in k for o in OWN_KERNELS)}
        split = {}
        if stages:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                split = split_stages(path)
        print(json.dumps({
            "route": name, "root": os.path.dirname(os.path.dirname(
                trt.__file__)), "device": smi, "wall_s": wall, "busy_s": busy,
            "idle_share": 1.0 - busy / wall, "launches": len(kernels),
            "own_kernels_ms": own,
            "own_kernels_launches": {k: count[k] for k in own},
            "top_ms": {k: v / 1e3 for k, v in top}, **split,
        }), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--stages", action="store_true")
    parser.add_argument("routes", nargs="*", default=["group"])
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    main(args.routes, args.stages)
