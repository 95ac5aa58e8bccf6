"""Smoke run of ray_tracer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel library from this checkout (in parallel), prints
the main path's kernel (group_walk_kernel, which the packet walk from the
root launches too) as ptxas reports it, holds it against walk_kernel's
loop, the design it replaced (tools/packet_walk_variants.cu), and times
both in turns on bounce and shadow rays at 2^18 and 2^22 lanes (the
frame's widest round) and through the packet walk with one- and two-row
leaf slots at 2^18 (packet_vs_old), prints the narrow walk's kernel
(bvh2_walk_kernel) as ptxas reports it and holds it against the design it
replaced (tools/narrow_walk_variants.cu), timed in turns at 2^18 and 2^22
(narrow_vs_old), prints the cluster enumeration walk (emit_walk_kernel)
and the rope walk (rope_walk_kernel) as ptxas reports them and holds each
against the design it replaced (tools/emit_walk_variants.cu,
tools/rope_walk_variants.cu, the latter on the old 64 B-row streams),
timed in turns at 2^18 and 2^22 (emit_vs_old, lanewalk_vs_old), prints
the cluster route's chunk kernels
(cluster_pairs_kernel, box_hits_kernel) as ptxas reports them and holds
each against the design it replaced (tools/cluster_test_variants.cu) on
the route's chunks, timed in turns, prints the two-phase route's DEEP
kernel (deep_walk_kernel) as ptxas reports it and holds it against the
walk it replaced (tools/deep_walk_variants.cu) on the route's DEEP
launches, timed in turns, prints the route's TOP kernel (top_walk_kernel)
as ptxas reports it and holds it against its plain twin over the scene's
TOP table and the walk it replaced (walk_kernel's TOP mode,
tools/top_walk_variants.cu) on the route's TOP inputs at 2^18 and 2^22
lanes, timed in turns (top_vs_old), checks each kernel mode against its plain torch
version on the card at the main path's shapes, holds the wavefront
round's three kernels (csrc/shade_round.cu: shade, state permute, NEE
resolve) against their plain versions on the main frame's own rounds
(round_kernels, with each kernel's bound on every round and summed over
the frame: round_bounds), holds the shade kernel, the state permute and
the NEE resolve each against the kernel it replaced
(tools/shade_round_variants.cu) on the main frame's rounds 0 and 6, bit
for bit and timed in turns with both kernels' ptxas lines (shade_vs_old,
permute_vs_old with the TMA floor gather's and torch's index_select times
beside it, nee_vs_old), and requires the main frame to launch each round
kernel once a round,
checks small card renders
against the same renders on the CPU, and renders the benchmark frame
(sponza_proxy, 1920x1080, spp 2, bounce limit 8, one whole-frame tile)
through each traversal route of the port: the group kernel (the default),
the cluster route with packet and with box enumeration, the packet walk,
the narrow binary-BVH walk, the rope walk and two-phase treelet
traversal.  Then it drives what a user calls besides ``render`` on the
same scene: ``ProgressiveRenderer`` at the benchmark frame (three steps,
a checkpoint after the second resumed by a fresh renderer, and two
steps at 64x36 against the CPU), the static-scan integrator
(``path_regen=False``) at the benchmark frame and each estimator at 64x36
against the CPU, the debug heatmap at the viewer's preview size with
its counts at 64x36 against the CPU's, the CLI as subprocesses (a
progressive render with a checkpoint, run twice so that the second
resumes, and the bench line) and the viewer (its render loop and HTTP
server in threads, every endpoint requested), and the bench
(``python -m ray_tracer_tpu_torch.bench``, by default and with
``RT_TWO_PHASE=1``, each held to the main frame).  The configuration values
(``config_values``: the leaf and hier bin keys, pre-permute NEE sorted
and not, the unbinned wavefront, each equal to the main frame bit for
bit; closest-hit NEE within 1% of it and at 64x36 against the CPU), bump
maps on a scene built here (``normal_maps``, through the shade kernel's
maps instance once a round), texture, metalness, alpha and bump maps on a
scene built here with generated 1024x1024 maps (``maps``: the round
kernels against their plain versions on the frame's rounds 0, 2 and 6,
bit for bit, with bounds, the maps instance also timed alone; cutout,
bumped, bilinear and nearest lanes counted;
the frame equal to the torch round's, both timed, with the launches a
round and both shade kernel instances' ptxas lines), ``sponza_proxy`` compiled
as a forest (``forest``: 64x36 against the CPU; forest_walk_kernel
against its plain version on 2^18 rays of the forest frame's camera,
bounce and shadow sets, bit for bit, with bounds from its audit instance,
which must count no instance culled whose root test passes; against the
per-instance composition it replaced, ``tools/measure_forest_walk.py``,
timed in turns, ``forest_vs_old``; against the kernel before the cull,
tools/forest_walk_variants.cu, bit for bit and timed in turns, with the
ptxas lines, ``forest_vs_unculled``; the benchmark frame on the round
kernels, one forest-walk launch a traversal, equal to the torch round's
frame bit for bit, both timed, with the launches a round, on the
kernel before the cull and this one in turns, and with the audit after
every traversal for the frame bound), the static scan's occupancy
profile, and an NCCL world of one (``sharded``: ``render_frame_sharded``
on a (1, 1) mesh equal to ``render_frame``, then the port's
``dryrun_multichip(1)``).  Every phase prints one
line; any failure raises, so the exit code is non-zero and no result
line is printed.  The line before the last
lists the kernels; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.append(os.path.join(REPO, "tools"))

import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch import api, bench  # noqa: E402
from ray_tracer_tpu_torch.api import _camera_arrays, scene_camera  # noqa: E402
from ray_tracer_tpu_torch.integrator import (  # noqa: E402
    film, shading, wavefront,
)
from ray_tracer_tpu_torch.kernels import (  # noqa: E402
    bvh8, cluster, group, lanewalk, packet, shade,
)
from ray_tracer_tpu_torch.ops import (  # noqa: E402
    cluster_trace, intersect, traverse,
)
from ray_tracer_tpu_torch.sampling import bsdf, lights, rng  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

import cluster_test_variants  # noqa: E402
import deep_walk_variants  # noqa: E402
import emit_walk_variants  # noqa: E402
import forest_walk_variants  # noqa: E402
import measure_forest_walk  # noqa: E402
import narrow_walk_variants  # noqa: E402
import packet_walk_variants  # noqa: E402
import rope_walk_variants  # noqa: E402
import shade_round_variants  # noqa: E402
import top_walk_variants  # noqa: E402

BIG = group.BIG
FRAME = (1920, 1080)  # the benchmark frame: spp 2, bounce limit 8
SMALL = (64, 36)  # the card-vs-CPU frame
PREVIEW = (480, 270)  # the viewer's preview of the benchmark frame
N_CHECK = 1 << 18  # rays per kernel-vs-plain check
N_WIDE = 1 << 22  # the frame's widest round (4,147,200 lanes), rounded up
SCENE_TRIS = 260_000  # sponza_proxy's triangle target (its default)
TIMED_FRAMES = 3  # main frame and cluster frame: median of 3
ROUTES = {  # frame phase -> routing, timed frames
    "frame_cluster": (trt.Routing(cluster="on"), 3),
    "frame_cluster_boxes": (trt.Routing(cluster="on", cluster_enum="boxes"),
                            1),
    "frame_packet": (trt.Routing(groups=0, anyhit_group=False), 1),
    "frame_narrow": (trt.Routing(wide=False), 1),
    "frame_lanewalk": (trt.Routing(lanewalk="force"), 1),
    "frame_two_phase": (trt.Routing(two_phase=True), 1),
}
# one nvcc build each
LIBRARIES = (bvh8.build, cluster.build, packet.build_narrow, lanewalk.build,
             shade.build, cluster_test_variants.build,
             deep_walk_variants.build, packet_walk_variants.build,
             narrow_walk_variants.build, emit_walk_variants.build,
             rope_walk_variants.build, top_walk_variants.build,
             shade_round_variants.build, forest_walk_variants.build)
BVH8 = "ray_tracer_tpu_torch/csrc/bvh8_walk.cu"
PACKET8 = "ray_tracer_tpu/kernels/packet.py:301"
SHADE = "ray_tracer_tpu_torch/csrc/shade_round.cu"
JAX_ROUND = "ray_tracer_tpu/integrator/wavefront.py:1003-1400"
JAX_FOREST = "ray_tracer_tpu/ops/traverse.py:603-627"
# the main frame's rounds checked: the widest (every lane's first hit) and
# one past russian roulette's start (bounce 5)
CHECK_ROUNDS = (0, 6)
KERNELS = {  # mode -> (source, its CUDA kernel, the TPU kernel it replaces)
    "group_traverse": (BVH8, "group_walk_kernel",
                       "ray_tracer_tpu/kernels/group.py:89"),
    "group_anyhit": (BVH8, "group_walk_kernel",
                     "ray_tracer_tpu/kernels/group.py:89"),
    "packet8_wide": (BVH8, "group_walk_kernel", PACKET8),
    "packet8_anyhit": (BVH8, "group_walk_kernel", PACKET8),
    "packet8_emit": (BVH8, "emit_walk_kernel", PACKET8),
    "cluster_pairs": ("ray_tracer_tpu_torch/csrc/cluster_test.cu",
                      "cluster_pairs_kernel",
                      "ray_tracer_tpu/kernels/cluster.py:36"),
    "box_hits": ("ray_tracer_tpu_torch/csrc/cluster_test.cu",
                 "box_hits_kernel", "ray_tracer_tpu/kernels/cluster.py:164"),
    "packet_narrow": ("ray_tracer_tpu_torch/csrc/bvh2_walk.cu",
                      "bvh2_walk_kernel",
                      "ray_tracer_tpu/kernels/packet.py:53"),
    "lanewalk_closest": ("ray_tracer_tpu_torch/csrc/lanewalk.cu",
                         "rope_walk_kernel",
                         "ray_tracer_tpu/kernels/lanewalk.py:167"),
    "lanewalk_anyhit": ("ray_tracer_tpu_torch/csrc/lanewalk.cu",
                        "rope_walk_kernel",
                        "ray_tracer_tpu/kernels/lanewalk.py:167"),
    "packet8_top": (BVH8, "top_walk_kernel", PACKET8),
    "packet8_top_anyhit": (BVH8, "top_walk_kernel", PACKET8),
    "packet8_deep": (BVH8, "deep_walk_kernel", PACKET8),
    "packet8_deep_anyhit": (BVH8, "deep_walk_kernel", PACKET8),
    # the wavefront round, which the JAX package leaves to XLA's fusions
    "shade_round": (SHADE, "shade_kernel<false>", JAX_ROUND),
    "shade_round_maps": (SHADE, "shade_kernel<true>", JAX_ROUND),
    "permute_rows": (SHADE, "permute_kernel", JAX_ROUND),
    "nee_resolve": (SHADE, "nee_resolve_kernel", JAX_ROUND),
    # the forest walk, which the JAX package leaves to XLA's fusion of its
    # lax.scan over the instances
    "forest_walk": ("ray_tracer_tpu_torch/csrc/bvh2_walk.cu",
                    "forest_walk_kernel<false, false>", JAX_FOREST),
    "forest_anyhit": ("ray_tracer_tpu_torch/csrc/bvh2_walk.cu",
                      "forest_walk_kernel<true, false>", JAX_FOREST),
}

# The least time the card could take for a kernel's work: the larger of
# its bytes over the HBM rate and its FP32 operations over the FP32 rate
# outside the tensor cores (H100 SXM data sheet, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# FP32 operations the function needs per unit of work (comparisons not
# counted), summed over what this run's data holds: real child boxes,
# records, triangles and boxes, never the padding.
OPS_CHILD = 22  # one child's slab test: 6 mul, 6 sub, 10 min/max
OPS_RECORD = 40  # one Moller-Trumbore record test: 39 mul/add, a divide
OPS_PAIR = 12  # one live pair's set-up: o - anchor, o' x d
OPS_PAIR_TRI = 39  # one pair x triangle: the non-zero page terms (T 6,
# B 5, U 11, V 11 mul/add; FO is a copy), a divide, 3 mul, 2 sub
OPS_BOX_RAY = 6  # one live lane's set-up: 1/d, o/d
OPS_RAY_BOX = 22  # one ray x box: 6 plane products (one non-zero page row
# each), 6 sub, 10 min/max
OPS_SCAN = 36  # one ray taken to an instance's object space: the point 18,
# the direction 15, three reciprocals (the root's box test is a box)
OPS_CULL = 29  # one world-box test of the forest walk's cull: the
# origin's margin 1, the grown planes 6, 6 sub, 6 mul, 10 min/max
OPS_WORLD_RAY = 6  # one ray's world-space set-up: three reciprocals, |o|
# max 3
INSTANCE_BYTES = 88  # an instance as the forest walk reads it: inverse
# transform rows 48, root 4, word 4, root's row 32
TREE_NODE_BYTES = 32  # a chunk tree's node: its box, eta and word
# Bytes the function needs per unit: a node's 8 child boxes with codes
# and axis, a record's v0|e1|e2|n|front_only, a triangle's non-zero page
# coefficients (T 4, B 3, U 6, V 6, FO 1), a box's 6 planes, a binary
# node's bvh_packed row, a rope-stream BOX row's box, miss row and leaf
# word.
NODE_BYTES = 64 * 4
RECORD_BYTES = 13 * 4
TRI_BYTES = 20 * 4
BOX_BYTES = 6 * 4
NODE2_BYTES = 8 * 4
ROPE_BOX_BYTES = 7 * 4
# The round kernels' FP32 operations per lane, counted from
# csrc/shade_round.cu (a divide, square root or transcendental as one):
# the shade kernel on a flattened scene without spheres (the fetch 70, the
# sky 44, the light sample 36, the three lobes 130, roulette 6, the camera
# ray 32, ...), and the NEE resolve with rect lights.  The permute does
# none.  Bytes: the shade kernel reads 29 floats of each distinct shade row
# its lanes hit.
OPS_SHADE = 369
OPS_NEE = 23
SHADE_ROW_BYTES = 29 * 4
# The maps instance (shade_kernel<true>) besides: 12 more floats of each
# shade row (the uv and its flag, the map ids and the sampler), 3 bytes of
# each distinct texel its taps read and the 1 KiB sRGB table; FP32
# operations: the uv 10 a lane, each texture fetch's set-up 13 (wrap,
# scale, floor or round), each bilinear channel 15 (the weights 4, four
# products of three factors, three sums), each bumped lane's frame and
# tilt 113.
SHADE_MAPS_ROW_BYTES = 41 * 4
OPS_UV = 10
OPS_TAP = 13
OPS_BILINEAR_CH = 15
OPS_BUMP = 113


def phase(title: str, /, **fields) -> None:
    print(json.dumps({"phase": title, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(bytes_moved: float, ops: float) -> dict:
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=bytes_moved, bound_ops=ops)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@contextlib.contextmanager
def captured(module, name):
    """Record the arguments of every call of ``module.name``."""
    calls = []
    fn = getattr(module, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def check_rays(sc, dev, n=N_CHECK):
    """The three ray sets of one wavefront round at ``n`` lanes: camera
    rays over the frame, cosine bounce rays from their hits, and shadow
    rays toward the rect light, each ordered by the integrator's bin key.
    Up to the frame's pixel count the pixels are spread over the frame;
    past it every pixel takes samples 0, 1, ... in turn, as in a round of
    the frame at spp 2."""
    cfg = trt.RenderConfig(width=FRAME[0], height=FRAME[1])
    cam = _camera_arrays(scene_camera(sc), cfg, dev)
    if n <= cfg.n_pixels:
        ids = torch.linspace(0, cfg.n_pixels - 1, n, device=dev).to(
            torch.int32)
        sample = 0
    else:
        lane = torch.arange(n, device=dev)
        ids = (lane % cfg.n_pixels).to(torch.int32)
        sample = lane // cfg.n_pixels
    cam_rays = wavefront.raygen(*cam, ids, cfg.width, cfg.height)
    o = cam_rays.origin.contiguous()
    d = cam_rays.direction.contiguous()
    hit = traverse.traverse(sc, o, d, torch.ones(n, dtype=torch.bool,
                                                 device=dev))
    hp, normal = wavefront._shade_fetch(
        sc, wavefront.CameraRays(o, d), hit, traverse.prim_space(sc))[:2]
    u = rng.uniforms(0, ids, 0, sample, 0, 7)
    hit_any = hit.did_hit
    b_dir = bsdf.cosine_hemisphere_dir(normal, u[:, 3], u[:, 4])
    b_org = hp + normal * 1e-5
    s_org = hp + normal * 0.01
    s_dir, _, _, s_dist = lights.sample_rect_light(
        sc, s_org, u[:, 0], u[:, 1], u[:, 2])
    s_active = hit_any & (intersect.dot(normal, s_dir) > 0.0)

    def binned(org, dirs, tmax, active):
        key = wavefront._bin_key(sc, org, dirs, active, 6, 0)
        order = torch.argsort(key, stable=True)
        t0 = torch.where(active, tmax, -BIG)
        return [x[order].contiguous() for x in (org, dirs, t0)]

    full = torch.full((n,), BIG, device=dev)
    return {
        "camera": (o, d, full),
        "bounce": binned(b_org, b_dir, full, hit_any),
        "shadow": binned(s_org, s_dir, s_dist * (1.0 - 1e-3), s_active),
    }


def measure(name, run, plain, compare, cost, err=None, **fields):
    """Run a kernel and its plain version on the same inputs, hold them
    together with ``compare`` (raises), time both, and print the check.
    The plain version runs once: its time is that of the call compared.
    ``err(out, ref)``: the largest difference (default: of the outputs'
    values)."""
    out = run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = plain()
    stop.record()
    torch.cuda.synchronize()
    compare(out, ref)
    err = max(
        (float((a.float() - b.float()).abs().max()) if a.numel() else 0.0)
        for a, b in zip(out, ref)
    ) if err is None else err(out, ref)
    ms = cuda_ms(run, 20)
    plain_ms = start.elapsed_time(stop)
    rec = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, **cost(), **fields)
    phase("kernel_vs_plain", kernel=name, exact=True, **rec)
    return rec


def same_values(a, b) -> bool:
    """Equal shapes and dtypes, and equal values where NaN equals NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def values_err(out, ref) -> float:
    """The largest |difference| of the outputs' values, NaN against NaN
    counted as 0 (``measure``'s ``err`` where outputs may hold NaN)."""
    worst = 0.0
    for a, b in zip(out, ref):
        a, b = a.float(), b.float()
        same = (a == b) | (a.isnan() & b.isnan())
        if not bool(same.all()):
            worst = max(worst, float((a - b).abs()[~same].max()))
    return worst


def equal_values(name):
    """``measure``'s compare for outputs that may hold NaN: each output
    equal (``same_values``), else raise."""
    def compare(out, ref):
        for k, (a, b) in enumerate(zip(out, ref)):
            if not same_values(a, b):
                raise AssertionError(f"{name}: output {k} differs from the "
                                     "plain version's")
    return compare


def shade_cost(c, w) -> dict:
    """The shade kernel's bound on the wave ``w``: its lane state in, the
    29 floats it needs of each distinct shade row its lanes hit, its
    packed rows and key out; OPS_SHADE a lane.  Where the maps instance
    runs, also what ``maps_usage`` counts: the rows' 12 more floats, the
    distinct texel bytes and the table, and the maps' operations."""
    n = w.origin.shape[0]
    hit = w.hit
    rows = torch.unique(torch.where(hit.kind == traverse.KIND_TRI,
                                    hit.prim, 0)).numel()
    state = nbytes(w.origin, w.direction, hit.dst, hit.kind, hit.prim,
                   hit.front, w.atten, w.total, w.direct, w.acc, w.bad,
                   w.alive, w.j, w.s, w.sb, w.pix, w.slot, c.consts)
    outs = (4 * shading.ROW + 4) * n
    if not shade.maps_on(c.scene, c.cfg):
        return dict(bound(state + rows * SHADE_ROW_BYTES + outs,
                          OPS_SHADE * n), shade_rows=rows)
    maps = maps_usage(c, w)
    moved = (state + rows * SHADE_MAPS_ROW_BYTES + maps["texel_bytes"]
             + nbytes(c.srgb) + outs)
    return dict(bound(moved, OPS_SHADE * n + maps.pop("ops")),
                shade_rows=rows, **maps)


def maps_usage(c, w) -> dict:
    """What the maps instance reads and does on the wave ``w``, by the
    plain versions' own values (``shading.shade_fetch``,
    ``apply_material_maps``, ``bump``'s mask): the distinct texels of its
    taps and the distinct bytes they read, its FP32 operations beyond OPS_SHADE, and the live lanes with a
    hit that are cut out, bumped, or sample their albedo map bilinear or
    nearest.  A tap reads the channels its map needs: 3 B of an albedo
    texel, the red byte of a metalness, alpha or bump texel."""
    scene, cfg, hit = c.scene, c.cfg, w.hit
    meta = scene.meta
    (_, _, uv, albedo, emission, refl, _, tex_id, sampler, metal_tex,
     alpha_tex, _) = shading.shade_fetch(
        scene, shading.CameraRays(w.origin, w.direction), hit, c.space, cfg)
    cutout = shading.apply_material_maps(
        scene, cfg, uv, sampler, albedo, emission, refl, tex_id, metal_tex,
        alpha_tex)[3]
    fetches = [(tex_id, uv, 3, sampler)]  # (texture, uv, channels, sampler)
    if meta.get("n_metalness_maps", 0):
        fetches.append((metal_tex, uv, 1, sampler))
    if meta.get("n_alpha_maps", 0):
        fetches.append((alpha_tex, uv, 1, sampler))
    bump = torch.zeros_like(cutout)
    if cfg.enable_normal_maps and meta.get("flattened", False) and meta.get(
            "n_bump_maps", 0):
        is_tri = hit.kind == traverse.KIND_TRI
        table = scene.shade_tri if c.space == "tri" else scene.shade_slot
        srow = table[torch.where(is_tri, hit.prim, 0).long()]
        duv1 = srow[:, 11:13] - srow[:, 9:11]
        duv2 = srow[:, 13:15] - srow[:, 9:11]
        det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        bump_tex = srow[:, 31].to(torch.int32)
        bump = is_tri & (bump_tex >= 0) & (torch.abs(det) > 1e-12)
        hw = scene.tex_size[torch.clamp(bump_tex, min=0).long()].to(
            torch.float32)
        step_u = 1.0 / torch.clamp(hw[:, 1], min=2.0)
        step_v = 1.0 / torch.clamp(hw[:, 0], min=2.0)
        zero = torch.zeros_like(step_u)
        smp = srow[:, 25].to(torch.int32)
        for du, dv in ((zero, zero), (step_u, zero), (zero, step_v)):
            fetches.append((torch.where(bump, bump_tex, -1),
                            uv + torch.stack([du, dv], 1), 1, smp))
    rows, cols = scene.tex_data.shape[1:3]
    texels, channels = [], []  # each tap's texel and the bytes it reads
    ops = OPS_UV * w.origin.shape[0] + OPS_BUMP * int(bump.sum())
    for tex, at_uv, ch, smp in fetches:
        use = tex >= 0
        bil = smp[use] == 1
        # the texels shading.sample_texture reads, by its own index code
        tid, near, quad, _, _ = shading.texel_taps(scene, tex[use],
                                                   at_uv[use])
        at = lambda tap: (tid * rows + tap[0]) * cols + tap[1]
        t = torch.cat([at(near)[~bil]] + [at(q)[bil] for q in quad])
        texels.append(t)
        channels.append((3 * t[:, None] + torch.arange(
            ch, device=t.device)).reshape(-1))
        ops += OPS_TAP * int(use.sum()) + ch * OPS_BILINEAR_CH * int(
            bil.sum())
    live = w.alive & hit.did_hit
    textured = live & (tex_id >= 0)
    return dict(texels=int(torch.unique(torch.cat(texels)).numel()),
                texel_bytes=int(torch.unique(torch.cat(channels)).numel()),
                ops=ops,
                cutout_lanes=int((live & cutout).sum()),
                bump_lanes=int((live & bump).sum()),
                bilinear_lanes=int((textured & (sampler == 1)).sum()),
                nearest_lanes=int((textured & (sampler != 1)).sum()))


def permute_cost(packed, order, skey, runs) -> dict:
    """The permute's bound: the packed rows, the order and the sorted keys
    (4 B a lane, for their runs) in, the next wave's columns out (nine
    (N,3) f32, two f32, five flags, six i32) and the runs word."""
    n = order.shape[0]
    out = (4 * 3 * shading.N_VEC + 4 * 2 + 5 + 4 * shading.PACKED_I) * n
    return bound(nbytes(packed, order, skey, runs) + out, 0)


def nee_cost(scene, lanes, occluded) -> dict:
    """The NEE resolve's bound: the bytes its function needs of each lane
    and the next ``direct`` out.  A lane's fresh_direct flag; where it is
    false, direct_base; where it is true, the diffuse flag; on a diffuse
    lane with rect lights the light's index (more than one light), the
    NEE flag and nee_k, where its shadow ray was traced the occlusion, and
    where that reached the light the pdf's direction and distance and
    cos_pdf_at_l (elsewhere the pdf is 0 and the weight 0 whatever they
    hold); the light and material tables once.  Without lights a diffuse
    lane's ``direct`` is NaN (the pdf divided by 0 lights) whatever it
    holds."""
    n = lanes.l_dir.shape[0]
    fresh = lanes.fresh_direct
    diff = fresh & lanes.is_diff
    count = lambda m: int(m.sum())
    need = n + 12 * count(~fresh) + count(fresh)
    if scene.n_lights:
        traced = diff & lanes.nee_active
        reached = traced & ~occluded
        need += ((4 * (scene.n_lights > 1) + 1 + 12) * count(diff)
                 + count(traced) + (12 + 4 + 4) * count(reached)
                 + nbytes(scene.light_mat, scene.light_normal,
                          scene.light_area, scene.mat_emission,
                          scene.mat_emission_strength))
    return dict(bound(need + 12 * n, OPS_NEE * count(diff)),
                resolved=count(diff))


def round_checks(sc, key="", old=True, check_rounds=CHECK_ROUNDS, **kw):
    """The round kernels (``csrc/shade_round.cu``) on a benchmark frame's
    own rounds (``kw``: more RenderConfig values; ``key`` names the frame,
    empty for the main frame): one frame through ``render`` with the
    wrappers' arguments captured; each kernel's bound on every round and
    summed over the frame (``round_bounds``); then on rounds
    ``check_rounds`` each kernel (the shade kernel's maps instance where
    textures are in use) against its plain version on the captured inputs
    (every output equal, NaN to NaN) and timed.  Also prints whether the
    outputs are equal bit for bit and how many NaN each holds, and, with
    ``old``, holds the shade kernel against the one it replaced
    (``shade_vs_old``), else times the shade kernel alone
    (``shade_alone``).  Returns the checks by kernel and round (keys
    prefixed by ``key``) and the bounds of every round by kernel."""
    cfg = frame_cfg(**kw)
    shade_name = ("shade_round_maps" if shade.maps_on(sc, cfg)
                  else "shade_round")
    with captured(shade, "shade_round") as shades, \
            captured(shade, "permute_rows") as permutes, \
            captured(shade, "nee_resolve") as nees:
        trt.render(sc, cfg)
        torch.cuda.synchronize()
    rounds = len(shades)
    if not rounds or not len(permutes) == len(nees) == rounds:
        raise AssertionError(f"round_checks: {rounds} shade, "
                             f"{len(permutes)} permute, {len(nees)} NEE "
                             "calls")
    costs = {"shade_round": [shade_cost(*args) for args, _ in shades],
             "permute_rows": [permute_cost(*args) for args, _ in permutes],
             "nee_resolve": [nee_cost(*args) for args, _ in nees]}
    phase("round_bounds", frame=key.rstrip("_") or "main", shade_kernel=shade_name,
          rounds=rounds,
          lanes=[int(args[1].origin.shape[0]) for args, _ in shades],
          **{name: dict(frame_bound_ms=sum(c["bound_ms"] for c in cs),
                        bound_ms=[c["bound_ms"] for c in cs])
             for name, cs in costs.items()})
    out = {}
    for r in (r for r in check_rounds if r < rounds):
        (c, w), _ = shades[r]
        n = w.origin.shape[0]
        out[f"{key}{shade_name}_{r}"] = measure(
            shade_name, lambda: shade.shade_round(c, w),
            lambda: shade.shade_round_reference(c, w),
            equal_values(shade_name),
            lambda: costs["shade_round"][r], err=values_err, round=r, n=n,
            frame=key.rstrip("_") or "main")
        pargs, _ = permutes[r]
        # the frame's own runs word (the round's tally's last) holds its
        # count: each call here adds into a zeroed word of its own
        packed, order, skey, frame_runs = pargs
        word = lambda: torch.zeros_like(frame_runs)
        out[f"{key}permute_rows_{r}"] = measure(
            "permute_rows",
            lambda: shade.permute_rows(packed, order, skey, word()),
            lambda: shade.permute_rows_reference(packed, order, skey, word()),
            equal_values("permute_rows"), lambda: costs["permute_rows"][r],
            err=values_err, round=r, n=n, frame=key.rstrip("_") or "main")
        nargs, _ = nees[r]
        out[f"{key}nee_resolve_{r}"] = measure(
            "nee_resolve", lambda: (shade.nee_resolve(*nargs),),
            lambda: (shade.nee_resolve_reference(*nargs),),
            equal_values("nee_resolve"), lambda: costs["nee_resolve"][r],
            err=values_err, round=r, n=n, frame=key.rstrip("_") or "main")
        got_runs, want_runs = word(), word()
        got = (*shade.shade_round(c, w),
               *shade.permute_rows(packed, order, skey, got_runs),
               shade.nee_resolve(*nargs), got_runs)
        want = (*shade.shade_round_reference(c, w),
                *shade.permute_rows_reference(packed, order, skey,
                                              want_runs),
                shade.nee_resolve_reference(*nargs), want_runs)
        bitwise = all(
            torch.equal(a.contiguous().view(torch.int32),
                        b.contiguous().view(torch.int32))
            if a.is_floating_point() else torch.equal(a, b)
            for a, b in zip(got, want))
        nan = sum(int(a.isnan().sum()) for a in got if a.is_floating_point())
        runs_equal = torch.equal(got_runs, frame_runs)
        phase("round_kernels", frame=key.rstrip("_") or "main", round=r, rounds=rounds,
              n=n, bitwise=bitwise, nan_values=nan, key_runs=int(got_runs),
              frame_key_runs=int(frame_runs))
        if not bitwise:
            raise AssertionError(f"round {r}: a round kernel's output "
                                 "differs in its bits from the plain "
                                 "version's")
        if not runs_equal:
            raise AssertionError(f"round {r}: the permute counts "
                                 f"{int(got_runs)} key runs, the frame's "
                                 f"round {int(frame_runs)}")
        if old:
            shade_vs_old(c, w, r, costs["shade_round"][r])
            permute_vs_old(pargs, r, costs["permute_rows"][r])
            nee_vs_old(nargs, r, costs["nee_resolve"][r])
        else:
            shade_alone(c, w, r, costs["shade_round"][r], key)
    del shades, permutes, nees
    return out, costs


def shade_alone(c, w, r, cost, key):
    """The shade kernel alone on round ``r``'s wave: 20 launches on
    arguments packed once (no wrapper time), twice, against its bound."""
    run = shade_round_variants.launcher("shipped", c, w)[0]
    runs = [cuda_ms(run, 20) for _ in range(2)]
    ms = statistics.mean(runs)
    phase("shade_alone", frame=key.rstrip("_"), round=r,
          n=int(w.origin.shape[0]), ms=ms, ms_runs=runs,
          bound_ms=cost["bound_ms"], share=cost["bound_ms"] / ms)


def shade_vs_old(c, w, r, cost):
    """shade_kernel against the kernel it replaced (old_shade_kernel of
    tools/shade_round_variants.cu) on round ``r``'s wave: all three
    outputs equal bit for bit, then each timed in turns (new, old, old,
    new; 20 launches each on arguments packed once, so no wrapper time),
    with both kernels' registers and spills as ptxas reports them and
    their blocks per SM as the runtime does."""
    shade_round_variants.compare(
        f"shade kernel, round {r}", shade_round_variants.run("shipped", c, w),
        shade_round_variants.run("old", c, w))
    ms, times = turns({name: shade_round_variants.launcher(name, c, w)[0]
                       for name in ("shipped", "old")})
    new_ms, old_ms = ms["shipped"], ms["old"]
    ptx = {"new": shade_ptxas(maps=False),
           "old": ptxas_of(shade_round_variants.build(), "old_shade_kernel")}
    regs = {k: [ln for x in v for ln in x["lines"] if "registers" in ln]
            for k, v in ptx.items()}
    phase("shade_vs_old", round=r, n=int(w.origin.shape[0]), equal=True,
          new_ms=new_ms, old_ms=old_ms, new_ms_runs=times["shipped"],
          old_ms_runs=times["old"], speedup=old_ms / new_ms,
          bound_ms=cost["bound_ms"], new_share=cost["bound_ms"] / new_ms,
          old_share=cost["bound_ms"] / old_ms, new_ptxas=regs["new"],
          old_ptxas=regs["old"],
          new_spill_store_bytes=[x["spill_store_bytes"] for x in ptx["new"]],
          old_spill_store_bytes=[x["spill_store_bytes"] for x in ptx["old"]],
          new_occupancy=shade_round_variants.info("shipped"),
          old_occupancy=shade_round_variants.info("old"))
    if len(ptx["new"]) != 1 or ptx["new"][0]["spill_store_bytes"] != 0:
        raise AssertionError(f"shade_kernel spills: {ptx['new']}")


def turns(runs) -> tuple:
    """``runs`` (name -> launch) timed in turns: in order, then reversed,
    20 launches each time: each one's mean and its times."""
    names = tuple(runs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cuda_ms(runs[name], 20))
    return {name: statistics.mean(t) for name, t in times.items()}, times


def registers(lib, name) -> list:
    """The ptxas lines with the registers of ``lib``'s entries named
    ``name``; raises where there is none or one spills."""
    ptx = ptxas_of(lib, name)
    if not ptx or any(x["spill_store_bytes"] for x in ptx):
        raise AssertionError(f"{name}: no ptxas entry, or it spills: {ptx}")
    return [ln for x in ptx for ln in x["lines"] if "registers" in ln]


def permute_vs_old(pargs, r, cost):
    """permute_kernel against the kernel it replaced (old_permute_kernel
    of tools/shade_round_variants.cu, on the same rows split into its two
    arrays) on round ``r``'s rows and order: every column equal bit for
    bit to the old kernel's and the plain version's, then both timed in
    turns (new, old, old, new; 20 launches each on arguments packed once;
    the new kernel counts the sorted keys' runs, as in the frame),
    beside two yardsticks of a gather of these bytes, timed in turns too:
    the floor (tools' tma_floor_kernel: the rows gathered into a
    contiguous copy by the TMA engine, nothing unpacked; its rows equal
    ``packed[order]``) and torch's ``index_select`` of the rows; with both
    kernels' ptxas lines and blocks per SM."""
    packed, order, skey, runs = pargs
    variants = shade_round_variants
    new = variants.permute_run("shipped", packed, order, skey)
    plain = shade.permute_rows_reference(packed, order, skey,
                                         torch.zeros_like(runs))
    for name, want in (("old", variants.permute_run("old", packed, order,
                                                    skey)),
                       ("plain", plain)):
        variants.compare(f"permute, round {r}: new against {name}", new, want)
    variants.compare(f"permute floor, round {r}",
                     [variants.permute_run("floor_tma", packed, order, skey)],
                     [packed[order]])
    ms, times = turns({name: variants.permute_launcher(name, packed, order,
                                                       skey)[0]
                       for name in ("shipped", "old")})
    yard, yard_times = turns({
        "floor_tma": variants.permute_launcher("floor_tma", packed, order,
                                               skey)[0],
        "index_select": lambda: packed.index_select(0, order)})
    phase("permute_vs_old", round=r, n=int(order.shape[0]), equal=True,
          new_ms=ms["shipped"], old_ms=ms["old"], new_ms_runs=times["shipped"],
          old_ms_runs=times["old"], speedup=ms["old"] / ms["shipped"],
          bound_ms=cost["bound_ms"],
          new_share=cost["bound_ms"] / ms["shipped"],
          old_share=cost["bound_ms"] / ms["old"],
          floor_ms=yard["floor_tma"],
          floor_bound_ms=bound(nbytes(packed, order, packed), 0)["bound_ms"],
          new_vs_floor=ms["shipped"] / yard["floor_tma"],
          index_select_ms=yard["index_select"], yardstick_ms_runs=yard_times,
          new_ptxas=registers(shade.build(), "permute_kernel"),
          old_ptxas=registers(variants.build(), "old_permute_kernel"),
          new_occupancy=variants.permute_info("shipped"),
          old_occupancy=variants.permute_info("old"))


def nee_vs_old(nargs, r, cost):
    """nee_resolve_kernel against the kernel it replaced (old_nee_kernel
    of tools/shade_round_variants.cu) on round ``r``'s lanes: ``direct``
    equal bit for bit to the old kernel's and the plain version's, then
    both timed in turns (new, old, old, new; 20 launches each on arguments
    packed once), with both kernels' ptxas lines."""
    variants = shade_round_variants
    new = variants.nee_run("shipped", *nargs)
    for name, want in (("old", variants.nee_run("old", *nargs)),
                       ("plain", shade.nee_resolve_reference(*nargs))):
        variants.compare(f"NEE, round {r}: new against {name}", [new],
                         [want])
    runs = {name: variants.nee_launcher(name, *nargs)[0]
            for name in ("shipped", "old")}
    ms, times = turns(runs)
    phase("nee_vs_old", round=r, n=int(nargs[1].l_dir.shape[0]), equal=True,
          new_ms=ms["shipped"], old_ms=ms["old"],
          new_ms_runs=times["shipped"], old_ms_runs=times["old"],
          speedup=ms["old"] / ms["shipped"], bound_ms=cost["bound_ms"],
          resolved=cost["resolved"],
          new_share=cost["bound_ms"] / ms["shipped"],
          old_share=cost["bound_ms"] / ms["old"],
          new_ptxas=registers(shade.build(), "nee_resolve_kernel"),
          old_ptxas=registers(variants.build(), "old_nee_kernel"))


def shade_ptxas(maps: bool) -> list:
    """ptxas's report for shade_kernel<maps> (``ptxas_of``'s entries)."""
    return [x for x in ptxas_of(shade.build(), "shade_kernel")
            if f"shade_kernelILb{int(maps)}E" in x["entry"]]


def equal_all(name):
    def compare(out, ref):
        for a, b in zip(out, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: kernel and plain differ")
    return compare


def walk_cost(stats, tmax0, leaf_rows=None, rows=1, emit_k=0, nodes=None,
              extra_bytes=0):
    """Bytes and FP32 operations of one walk, from the plain walk's
    ``stats``: active rays read o, d (every lane its tmax and its
    outputs: dst and prim, and ``emit_k`` slots and a flag where it
    emits), the distinct nodes (256 B rows) and the real records of the
    distinct leaf slots the rays visited are read once, and every real
    child box and record visited is tested.  ``nodes`` (the TOP walk's
    tree, its (W,128) rows or its TOP table, as ``stats`` counted them):
    the troot flags of the visited nodes' interior children are read too,
    the old layout's bound; ``extra_bytes``: other inputs read once (DEEP
    entry lists)."""
    out = (0 if leaf_rows is None else 8) + (4 * emit_k + 4 if emit_k else 0)
    rec_bytes = 0
    if leaf_rows is not None:
        first = stats["slot_seen"].nonzero()[:, 0] * 8
        ids = first[:, None] + torch.arange(8 * rows, device=first.device)
        rec = leaf_rows.reshape(-1, 16)[ids.reshape(-1), 0]
        rec_bytes = int((~rec.isnan()).sum()) * RECORD_BYTES
    seen = stats["node_seen"]
    node_bytes = int(seen.sum()) * NODE_BYTES
    if nodes is not None:
        node_bytes += int((nodes[seen][:, 6:64:8] > 0).sum()) * 4
    ops = stats["children"] * OPS_CHILD + stats["records"] * OPS_RECORD
    return bound(ray_bytes(tmax0, out) + node_bytes + rec_bytes + extra_bytes,
                 ops)


def ray_bytes(tmax0, out) -> int:
    """Active rays read o, d; every lane reads its tmax and writes ``out``
    bytes."""
    active = int((tmax0 > -BIG).sum())
    return 24 * active + (4 + out) * tmax0.numel()


def narrow_args(sc, rays, name):
    """The narrow walk's arguments for one ray set, less the root word."""
    return (sc.bvh_packed, sc.bvh_axis, sc.tri_packed, *rays[name],
            sc.meta["bvh_root"])


def narrow_checks(sc, rays):
    """The narrow walk (all five outputs) on the bounce set and, clipped at
    the light, on the shadow set, exact against the plain walk.  Bytes:
    the rays, the distinct node rows whose boxes were tested and the
    distinct triangle records tested; operations: 22 per box and 40 per
    triangle tested."""
    out = {}
    word = sc.meta["bvh_root_word"]
    for name in ("bounce", "shadow"):
        args = narrow_args(sc, rays, name)
        stats = {}

        def cost(args=args, stats=stats):
            return bound(
                ray_bytes(args[5], 17)
                + int(stats["node_seen"].sum()) * NODE2_BYTES
                + int(stats["tri_seen"].sum()) * RECORD_BYTES,
                stats["boxes"] * OPS_CHILD + stats["tris"] * OPS_RECORD)

        out["narrow_" + name] = measure(
            "packet_narrow", lambda: packet.packet_traverse(*args, word),
            lambda: packet.packet_traverse_reference(*args, stats=stats),
            equal_all(f"narrow {name}"), cost,
            rays=name, n=N_CHECK, active=int((args[5] > -BIG).sum()),
        )
    return out


def lanewalk_checks(sc, rays):
    """The rope walk, closest hit on the bounce set and occlusion on the
    shadow set, exact against the plain walk.  Bytes: the rays, the
    distinct BOX rows stepped on (28 B: box, miss row, leaf word) and the
    distinct triangles tested (52 B records); operations: 22 per BOX step
    and 40 per triangle test."""
    out = {}
    for name, anyhit in (("bounce", False), ("shadow", True)):
        args = (sc.rope_streams, sc.tri_packed, sc.meta["rope_rows"],
                *rays[name])
        stats = {}

        def cost(args=args, stats=stats):
            box_rows = int(stats["row_seen"].sum())
            tris = int(stats["tri_seen"].sum())
            return dict(
                bound(ray_bytes(args[5], 8) + box_rows * ROPE_BOX_BYTES
                      + tris * RECORD_BYTES,
                      stats["box"] * OPS_CHILD + stats["tri"] * OPS_RECORD),
                box_steps=stats["box"], tri_tests=stats["tri"],
                box_rows=box_rows, tris=tris)

        # the kernel's time without the host read of its flag, which the
        # route defers to the round's count read; the flag is read after
        flag = lanewalk.error_flag(args[3].device)
        out["lanewalk_" + name] = measure(
            "lanewalk_anyhit" if anyhit else "lanewalk_closest",
            lambda: lanewalk.lanewalk_traverse(*args, anyhit=anyhit,
                                               err=flag),
            lambda: lanewalk.lanewalk_traverse_reference(
                *args, anyhit=anyhit, stats=stats),
            equal_all(f"lanewalk {name}"), cost,
            rays=name, n=N_CHECK, anyhit=anyhit,
            active=int((args[5] > -BIG).sum()),
        )
        lanewalk.raise_on_flag(int(flag.item()), sc.meta["rope_rows"])
    return out


def group_checks(sc, rays):
    """The group kernel (group_walk_kernel), exact on the camera, bounce
    and shadow sets: ``dst`` and ``prim`` equal to the plain walk's, and
    against the order-free contract (hit masks, ``dst``, ``prim`` off only
    on exact-t ties)."""
    leaf_map = sc.leaf_map.long()
    out = {}
    for name, anyhit in (("camera", False), ("bounce", False),
                         ("shadow", True)):
        args = (sc.wide_packed, sc.leaf_rows, *rays[name])
        stats = {}

        def compare(got, want, name=name, anyhit=anyhit):
            (dst, prim), (rdst, rprim) = got, want
            if anyhit:
                if not torch.equal(dst < -1.0, rdst < -1.0):
                    raise AssertionError("occlusion masks differ")
            else:
                hit, rhit = prim >= 0, rprim >= 0
                if not torch.equal(hit, rhit):
                    raise AssertionError(f"{name}: hit masks differ")
                tri = leaf_map[prim.clamp(min=0).long()]
                rtri = leaf_map[rprim.clamp(min=0).long()]
                differ = hit & (tri != rtri)
                if not torch.equal(dst[differ], rdst[differ]):
                    raise AssertionError(f"{name}: prim differs off a tie")
                tie_share = float(differ.float().mean())
                if tie_share >= 1e-3:
                    raise AssertionError(f"{name}: {tie_share:.2%} ties")
            if not torch.equal(dst, rdst):
                raise AssertionError(f"{name}: dst differs")
            if not torch.equal(prim, rprim):
                raise AssertionError(f"{name}: prim differs")

        out["group_" + name] = measure(
            "group_anyhit" if anyhit else "group_traverse",
            lambda: group.group_traverse(*args, anyhit=anyhit),
            lambda: group.group_traverse_reference(*args, anyhit=anyhit,
                                                   stats=stats),
            compare,
            lambda: walk_cost(stats, args[4], sc.leaf_rows),
            rays=name, n=N_CHECK, anyhit=anyhit,
            active=int((args[4] > -BIG).sum()),
        )
    return out


def in_turns(new, old) -> dict:
    """``new()`` and ``old()`` timed in turns (old, new, new, old; 10
    launches each): their mean times, each turn's, and the speed-up."""
    times = {"new": [], "old": []}
    for which in ("old", "new", "new", "old"):
        times[which].append(cuda_ms(new if which == "new" else old, 10))
    rec = dict(new_ms=statistics.mean(times["new"]),
               old_ms=statistics.mean(times["old"]),
               new_ms_runs=times["new"], old_ms_runs=times["old"])
    rec["speedup"] = rec["old_ms"] / rec["new_ms"]
    return rec


def group_vs_old(sc, rays, n):
    """group_walk_kernel against walk_kernel's loop, the design it replaced
    (the old packet walk with one-row slots, tools/packet_walk_variants.cu),
    on the bounce and shadow sets of ``n`` lanes: equal outputs
    (``torch.equal``), then each timed in turns.  The plain walk does not
    run here."""
    recs = sc.meta["wide_leaf_recs"]
    if recs > 8:
        raise AssertionError(f"the group walk reads one-row slots, not {recs}")
    for name, anyhit in (("bounce", False), ("shadow", True)):
        args = (sc.wide_packed, sc.leaf_rows, *rays[name])

        def new(args=args, anyhit=anyhit):
            return group.group_traverse(*args, anyhit=anyhit)

        def old(args=args, anyhit=anyhit):
            return packet_walk_variants.run("old", *args, recs, anyhit=anyhit)

        packet_walk_variants.compare(f"group walk, {name} at {n} lanes",
                                     new(), old())
        phase("group_vs_old", rays=name, n=n, anyhit=anyhit, equal=True,
              active=int((args[4] > -BIG).sum()), **in_turns(new, old))


def packet_vs_old(sc, sc16, rays):
    """The packet walk from the root (group_walk_kernel through
    ``packet_traverse_wide``) against walk_kernel's loop, the design it
    replaced (tools/packet_walk_variants.cu), with one-row (``sc``) and
    two-row (``sc16``) leaf slots, closest hit on the bounce set and
    occlusion on the shadow set: dst and prim equal (``torch.equal``),
    then each timed in turns.  Returns the records by (rows, ray set)."""
    out = {}
    for rows, s in ((1, sc), (2, sc16)):
        recs = s.meta["wide_leaf_recs"]
        for name, anyhit in (("bounce", False), ("shadow", True)):
            args = (s.wide_packed, s.leaf_rows, *rays[name], recs)

            def new(args=args, anyhit=anyhit):
                return packet.packet_traverse_wide(*args, anyhit=anyhit)

            def old(args=args, anyhit=anyhit):
                return packet_walk_variants.run("old", *args, anyhit=anyhit)

            packet_walk_variants.compare(f"packet walk, rows {rows}, {name}",
                                         new(), old())
            rec = in_turns(new, old)
            phase("packet_vs_old", rows=rows, records=recs, rays=name,
                  n=int(args[2].shape[0]), anyhit=anyhit, equal=True,
                  active=int((args[4] > -BIG).sum()), **rec)
            out[rows, name] = rec
    return out


def narrow_vs_old(sc, rays, n):
    """The narrow walk (bvh2_walk_kernel) against the design it replaced
    (old_bvh2_kernel of tools/narrow_walk_variants.cu) on the bounce set
    and, clipped at the light, the shadow set of ``n`` lanes: all five
    outputs equal (``torch.equal``), then each timed in turns."""
    word = sc.meta["bvh_root_word"]
    for name in ("bounce", "shadow"):
        args = (*narrow_args(sc, rays, name), word)

        def new(args=args):
            return packet.packet_traverse(*args)

        def old(args=args):
            return narrow_walk_variants.run("old", *args)

        narrow_walk_variants.compare(f"narrow walk, {name} at {n} lanes",
                                     new(), old())
        phase("narrow_vs_old", rays=name, n=n, equal=True,
              active=int((args[5] > -BIG).sum()), **in_turns(new, old))


def emit_vs_old(sc, rays, n):
    """emit_walk_kernel against the enumeration walk it replaced
    (walk_kernel's emit mode, tools/emit_walk_variants.cu's "old") on the
    cluster BVH8, at the route's top_k, for the bounce and shadow sets of
    ``n`` lanes: slots and ovf equal (``torch.equal``), then each timed in
    turns."""
    k = trt.Routing().cluster_k
    for name in ("bounce", "shadow"):
        o, d, tmax0 = rays[name]
        args = (sc.cwide_packed, sc.cwide_packed, o, d, tmax0, 8)

        def new(args=args):
            return packet.packet_traverse_wide(*args, top_k=k,
                                               emit_leaves=True)

        def old(o=o, d=d, tmax0=tmax0):
            return emit_walk_variants.run("old", sc.cwide_packed, o, d,
                                          tmax0, k)

        emit_walk_variants.compare(f"emit walk, {name} at {n} lanes",
                                   new(), old())
        phase("emit_vs_old", rays=name, n=n, top_k=k, equal=True,
              active=int((tmax0 > -BIG).sum()), **in_turns(new, old))


def lanewalk_vs_old(sc, old_rope, rays, n):
    """rope_walk_kernel on the scene's BOX-row streams against the kernel
    it replaced on the old 64 B-row streams (``old_rope``: the streams and
    their rows, tools/rope_walk_variants.py), closest hit on the bounce set
    and occlusion on the shadow set of ``n`` lanes: dst and prim equal
    (``torch.equal``), then each timed in turns."""
    streams, rows = old_rope
    for name, anyhit in (("bounce", False), ("shadow", True)):
        o, d, tmax0 = rays[name]
        # both find the rays' octants; the new one takes a flag, read
        # after the timing, so that its time holds no host read (as on
        # the route)
        flag = lanewalk.error_flag(d.device)

        def new(o=o, d=d, tmax0=tmax0, anyhit=anyhit, flag=flag):
            return lanewalk.lanewalk_traverse(
                sc.rope_streams, sc.tri_packed, sc.meta["rope_rows"], o, d,
                tmax0, anyhit=anyhit, err=flag)

        def old(o=o, d=d, tmax0=tmax0, anyhit=anyhit):
            return rope_walk_variants.run("old", streams, sc.tri_packed,
                                          rows, o, d, tmax0, anyhit=anyhit)

        rope_walk_variants.compare(f"rope walk, {name} at {n} lanes",
                                   new(), old())
        rec = in_turns(new, old)
        lanewalk.raise_on_flag(int(flag.item()), sc.meta["rope_rows"])
        phase("lanewalk_vs_old", rays=name, n=n, anyhit=anyhit, equal=True,
              active=int((tmax0 > -BIG).sum()), **rec)


def ptxas_of(lib, name):
    """``-Xptxas -v``'s report for each entry function of ``lib`` whose
    name holds ``name``: its lines, its stack frame and spill store
    bytes."""
    with open(lib[:-3] + ".log") as f:
        lines = [ln.strip() for ln in f]
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and name in ln:
            body = []
            for nxt in lines[i + 1:]:
                if "Compiling entry function" in nxt:
                    break
                body.append(nxt)
            size = lambda what: next(
                (int(x.split(what)[0].split()[-1]) for x in body
                 if what in x), None)
            out.append(dict(entry=ln.split("'")[1], lines=body,
                            stack_frame_bytes=size(" bytes stack frame"),
                            spill_store_bytes=size(" bytes spill stores")))
    return out


def packet_checks(sc, sc16, rays):
    """The packet walk (8- and 16-record slots, closest and occlusion) and
    its emit mode over the cluster BVH8, exact against the plain walk."""
    out = {}
    cases = (("camera", sc, False), ("bounce", sc, False),
             ("bounce", sc16, False), ("shadow", sc, True))
    for name, s, anyhit in cases:
        recs = s.meta["wide_leaf_recs"]
        rows = 2 if recs > 8 else 1
        args = (s.wide_packed, s.leaf_rows, *rays[name], recs)
        stats = {}
        rec = measure(
            "packet8_anyhit" if anyhit else "packet8_wide",
            lambda: packet.packet_traverse_wide(*args, anyhit=anyhit),
            lambda: packet.packet_traverse_wide_reference(
                *args, anyhit=anyhit, stats=stats),
            equal_all(f"packet {name} {recs}"),
            lambda: walk_cost(stats, args[4], s.leaf_rows, rows),
            rays=name, n=N_CHECK, anyhit=anyhit, records=recs,
            active=int((args[4] > -BIG).sum()),
        )
        out["packet_" + name + ("16" if recs == 16 else "")] = rec

    k = trt.Routing().cluster_k
    args = (sc.cwide_packed, sc.cwide_packed, *rays["bounce"], 8)
    stats = {}

    out["packet_emit"] = measure(
        "packet8_emit",
        lambda: packet.packet_traverse_wide(*args, top_k=k,
                                            emit_leaves=True),
        lambda: packet.packet_traverse_wide_reference(
            *args, top_k=k, emit_leaves=True, stats=stats),
        equal_all("emit"),
        lambda: walk_cost(stats, args[4], emit_k=k),
        rays="bounce", n=N_CHECK, k=k,
        active=int((args[4] > -BIG).sum()),
    )
    slots, ovf = packet.packet_traverse_wide(*args, top_k=k,
                                             emit_leaves=True)
    phase("emit_stats", rays="bounce",
          mean_candidates=float((slots >= 0).sum()) / N_CHECK,
          overflow_share=float((ovf > 0).float().mean()))
    return out


def treelet_checks(sc, rays):
    """The TOP walk (bounce set, and its occlusion form on the shadow set)
    and the DEEP walks of both rounds that the two-phase route builds
    from those sets, exact against the plain walk."""
    out = {}
    rt = ROUTES["frame_two_phase"][0]
    recs = sc.meta["wide_leaf_recs"]
    for name, anyhit in (("bounce", False), ("shadow", True)):
        with captured(packet, "packet_traverse_wide") as calls:
            traverse._two_phase_wide(sc, *rays[name], rt, anyhit=anyhit)
        torch.cuda.synchronize()
        if len(calls) != 3:
            raise AssertionError(f"two-phase {name}: {len(calls)} walks")
        for (args, kw), step in zip(calls, ("top", "deep1", "deep2")):
            kernel = "packet8_" + step[:4] + ("_anyhit" if anyhit else "")
            stats = {}
            plain_kw = {k: v for k, v in kw.items()
                        if k not in ("deep_e", "wide_top")}

            def cost(args=args, kw=kw, stats=stats):
                if "troot" in kw:
                    return top_cost(stats, args[4], sc.leaf_rows, recs,
                                    kw["top_k"], sc.wide_packed)
                return walk_cost(stats, args[4], sc.leaf_rows,
                                 extra_bytes=nbytes(kw["entries"]))

            rec = measure(
                kernel,
                lambda args=args, kw=kw: packet.packet_traverse_wide(
                    *args, **kw),
                lambda args=args, kw=plain_kw, stats=stats:
                    packet.packet_traverse_wide_reference(*args, **kw,
                                                          stats=stats),
                equal_all(f"{kernel} {name}"), cost,
                rays=name, step=step, n=int(args[2].shape[0]),
                anyhit=anyhit, active=int((args[4] > -BIG).sum()),
                records=recs,
            )
            out[f"{step}_{name}"] = rec
            if step == "top":
                twin = bvh8.top_walk_reference(
                    kw["wide_top"], args[1], *args[2:5], anyhit,
                    2 if recs > 8 else 1, kw["top_k"])
                equal_all(f"{kernel} {name} against its twin")(
                    packet.packet_traverse_wide(*args, **kw), twin)
                slots, ovf = packet.packet_traverse_wide(*args, **kw)[2:]
                phase("two_phase_stats", rays=name, anyhit=anyhit,
                      n_treelets=sc.meta["n_treelets"], top_k=kw["top_k"],
                      mean_entries=float((slots >= 0).sum()) / N_CHECK,
                      overflow_share=float((ovf > 0).float().mean()))
    return out


def deep_vs_old(sc, rays):
    """deep_walk_kernel against the DEEP walk it replaced (old_deep_kernel
    of tools/deep_walk_variants.cu), on the two DEEP launches of the
    two-phase route for the bounce set (closest hit) and the shadow set
    (occlusion): dst and prim equal (``torch.equal``; both walk the
    entries in list order), then each timed in turns (old, new, new, old;
    10 launches each).  The plain walk does not run here."""
    for name, anyhit in (("bounce", False), ("shadow", True)):
        calls = deep_walk_variants.route_deep_calls(sc, *rays[name],
                                                    anyhit=anyhit)
        for round_, (args, kw) in enumerate(calls, 1):
            runs = {
                "new": lambda args=args, kw=kw: packet.packet_traverse_wide(
                    *args, **kw),
                "old": lambda args=args, kw=kw: deep_walk_variants.run(
                    "old", *args, **kw),
            }
            deep_walk_variants.compare(f"DEEP round {round_} {name}",
                                       runs["new"](), runs["old"]())
            tmax0 = args[4]
            phase("deep_vs_old", rays=name, round=round_, anyhit=anyhit,
                  lanes=int(tmax0.numel()), live=int((tmax0 > 0).sum()),
                  equal=True, **in_turns(runs["new"], runs["old"]))


def top_cost(stats, tmax0, leaf_rows, recs, top_k, nodes) -> dict:
    """The TOP walk's bound in the TOP table's layout (256 B rows, no flag
    bytes; ``bound_ms``) and in the layout it replaced (the same rows and
    a troot flag per interior child of a visited node; ``old_layout``),
    from the plain walk's ``stats`` over ``nodes``."""
    rows = 2 if recs > 8 else 1
    new = walk_cost(stats, tmax0, leaf_rows, rows, emit_k=top_k)
    old = walk_cost(stats, tmax0, leaf_rows, rows, emit_k=top_k, nodes=nodes)
    return dict(new, old_layout=old)


def top_vs_old(sc, rays, n):
    """top_walk_kernel (``packet_traverse_wide`` with the scene's TOP table)
    against its plain twin over the table (``bvh8.top_walk_reference``) and
    the walk it replaced (walk_kernel's TOP mode, tools/top_walk_variants.cu)
    on the TOP walk's inputs of the two-phase route (the bounce set for
    closest hit, the shadow set for occlusion, at the route's top_k), ``n``
    lanes each: dst, prim, slots and ovf equal (``torch.equal``), then the
    new and the old walk timed in turns, with the bound in both layouts
    (from the twin's counts) and the share of each."""
    k = ROUTES["frame_two_phase"][0].top_k
    recs = sc.meta["wide_leaf_recs"]
    rows = 2 if recs > 8 else 1
    for name, anyhit in (("bounce", False), ("shadow", True)):
        o, d, tmax0 = rays[name]
        args = (sc.wide_packed, sc.leaf_rows, o, d, tmax0, recs)
        kw = dict(anyhit=anyhit, top_k=k, troot=sc.wide_troot,
                  wide_top=sc.wide_top)

        def new(args=args, kw=kw):
            return packet.packet_traverse_wide(*args, **kw)

        def old(o=o, d=d, tmax0=tmax0, anyhit=anyhit):
            return top_walk_variants.run(
                "old", *top_walk_variants.scene_args(sc), o, d, tmax0, recs,
                k, anyhit=anyhit)

        stats = {}
        got = new()
        twin = bvh8.top_walk_reference(sc.wide_top, sc.leaf_rows, o, d,
                                       tmax0, anyhit, rows, k, stats=stats)
        top_walk_variants.compare(f"TOP walk, {name} at {n} lanes, twin",
                                  got, twin)
        top_walk_variants.compare(f"TOP walk, {name} at {n} lanes, old",
                                  got, old())
        del twin
        cost = top_cost(stats, tmax0, sc.leaf_rows, recs, k, sc.wide_top)
        rec = in_turns(new, old)
        old_bound = cost["old_layout"]["bound_ms"]
        phase("top_vs_old", rays=name, n=n, top_k=k, anyhit=anyhit,
              equal=True, active=int((tmax0 > -BIG).sum()),
              mean_entries=float((got[2] >= 0).sum()) / n,
              overflow_share=float((got[3] > 0).float().mean()),
              top_rows=int(sc.wide_top.shape[0]), max_stack=stats["max_sp"],
              bound_ms=cost["bound_ms"], bound_by=cost["bound_by"],
              old_layout_bound_ms=old_bound,
              share_new=cost["bound_ms"] / rec["new_ms"],
              share_new_old_bound=old_bound / rec["new_ms"],
              share_old=old_bound / rec["old_ms"], **rec)


def chunk_cost(feats, ids, per_page, unit_bytes, ops_unit, ops_lane,
               feat_rows, out_bytes):
    """Bytes and operations of one chunk-kernel call.  ``per_page`` (P,)
    holds the real triangles (or boxes) of each page.  Live lanes (feature
    row 9 is 1 on a ray, 0 on padding; row 13, the ray's tmax, is -BIG on
    an inactive ray) read ``feat_rows`` feature floats and meet every real
    unit of their chunk's page; every lane writes ``out_bytes``; each
    distinct page's real units are read once."""
    live_lanes = ((feats[:, 9, :] == 1.0)
                  & (feats[:, 13, :] > -BIG / 2)).sum(dim=1)
    live = ids >= 0
    units = torch.where(live, per_page[ids.clamp(min=0).long()], 0)
    pages = torch.unique(ids[live]).long()
    page_bytes = int(per_page[pages].sum()) * unit_bytes
    n_live = int(live_lanes.sum())
    ops = int((live_lanes * units).sum()) * ops_unit + n_live * ops_lane
    return bound(n_live * feat_rows * 4 + nbytes(ids)
                 + ids.numel() * 128 * out_bytes + page_bytes, ops)


def cluster_chunks(sc, rays):
    """The chunk-kernel calls the cluster route makes for the bounce rays
    (its first slice of 2^17): the cluster test's arguments, and both box
    levels' arguments of the box enumeration."""
    calls = cluster_test_variants.route_chunks(sc, *rays["bounce"])
    return {kernel: args for kernel, slice_, args in calls if slice_ == 0}


def cluster_checks(sc, chunks):
    """The cluster test and both box levels on the route's chunks."""
    pages, feats, cid, count, t_c = chunks["cluster_pairs"]
    if int(count.min()) < 1 or int(count.max()) > t_c:
        raise AssertionError("cluster triangle counts out of range")
    out = {"cluster_pairs": measure(
        "cluster_pairs",
        lambda: cluster.cluster_pairs_test(pages, feats, cid, count, t_c),
        lambda: cluster.cluster_pairs_test_reference(pages, feats, cid,
                                                     count, t_c),
        equal_all("cluster_pairs"),
        lambda: chunk_cost(feats, cid, count.long(), TRI_BYTES,
                           OPS_PAIR_TRI, OPS_PAIR, 6, 8),
        rays="bounce", slice=cluster_trace.SLICE, chunks=int(cid.numel()),
        live_chunks=int((cid >= 0).sum()),
    )}
    for level in (1, 2):
        pages, feats, pid, count = chunks[f"box_hits_{level}"]
        out[f"box_hits_{level}"] = measure(
            "box_hits",
            lambda: cluster.box_hits(pages, feats, pid, count),
            lambda: cluster.box_hits_reference(pages, feats, pid, count),
            equal_all(f"box_hits level {level}"),
            lambda: chunk_cost(feats, pid, count.long(), BOX_BYTES,
                               OPS_RAY_BOX, OPS_BOX_RAY, 7, 16),
            rays="bounce", level=level, chunks=int(pid.numel()),
            live_chunks=int((pid >= 0).sum()),
        )
    return out


def cluster_vs_old(chunks):
    """Each chunk kernel against the design it replaced, on the route's
    chunks (the bounce slice, both box levels): equal outputs
    (``torch.equal``), then each timed in turns (old, new, new, old; 10
    launches each).  The plain versions do not run here."""
    pages, feats, cid, count, t_c = chunks["cluster_pairs"]
    cases = {"cluster_pairs": (
        lambda: cluster.cluster_pairs_test(pages, feats, cid, count, t_c),
        lambda: cluster_test_variants.cluster_pairs(
            "old", pages, feats, cid, count, t_c), cid)}
    for level in (1, 2):
        bp, bf, pid, bc = chunks[f"box_hits_{level}"]
        cases[f"box_hits_{level}"] = (
            lambda bp=bp, bf=bf, pid=pid, bc=bc: (
                cluster.box_hits(bp, bf, pid, bc),),
            lambda bp=bp, bf=bf, pid=pid, bc=bc: (
                cluster_test_variants.box_hits("old", bp, bf, pid, bc),),
            pid)
    out = {}
    for name, (new, old, ids) in cases.items():
        for a, b in zip(new(), old()):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: the new kernel and the old "
                                     "one differ")
        rec = in_turns(new, old)
        phase("cluster_vs_old", kernel=name, equal=True,
              chunks=int(ids.numel()), live_chunks=int((ids >= 0).sum()),
              **rec)
        out[name] = rec
    return out


def card_vs_cpu(sc, sc_cpu, title, routing=None, **kw):
    cfg = trt.RenderConfig(width=SMALL[0], height=SMALL[1],
                           samples_per_pixel=2, bounce_limit=8,
                           routing=routing, **kw)
    t0 = time.perf_counter()
    gpu = trt.render(sc, cfg).cpu()
    t1 = time.perf_counter()
    cpu = trt.render(sc_cpu, cfg)
    t2 = time.perf_counter()
    images_agree(title, gpu, cpu, card_s=t1 - t0, cpu_s=t2 - t1, **kw)


def images_agree(title, gpu, cpu, spp=2, **fields):
    """The card's image against the CPU's by the bench's gate
    (``bench.images_agree``: a finite card image, >= 99% of pixels within
    2e-3 and a mean |diff| below 1e-3), else raise."""
    stats = bench.images_agree(gpu, cpu)
    phase(title, size=f"{SMALL[0]}x{SMALL[1]}", spp=spp, bounce=8,
          **stats, **fields)
    if not stats["agree"]:
        raise AssertionError(f"{title}: card and CPU renders disagree")


def frame(sc, dev, title, routing, timed, main=None, **kw):
    """The benchmark frame through ``render`` (the launch counts are this
    call's; its image is kept as ``image``, not printed), then ``timed``
    frames of the bench's measure (``bench.measure``: frame index 1, ray
    counts from the wavefront; ``render`` was its warm-up): their median
    time, and the checksum and ray counts, which must agree with
    ``main``'s within 1%.  ``kw``: more RenderConfig values."""
    cfg = trt.RenderConfig(width=FRAME[0], height=FRAME[1],
                           samples_per_pixel=2, bounce_limit=8,
                           max_rays_per_batch=1 << 21, routing=routing, **kw)
    bench.reset_launches()
    torch.cuda.synchronize()
    t_render = time.perf_counter()
    img = trt.render(sc, cfg)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t_render
    launches = bench.all_launches()
    finite = bool(torch.isfinite(img).all())
    if img.shape != (FRAME[1], FRAME[0], 3) or not finite:
        raise AssertionError(f"{title}: bad frame {tuple(img.shape)} "
                             f"finite={finite}")
    m = bench.measure(sc, cfg, 2, timed, warmup=False)
    dt, rays_sem, rays_traced = m["frame_s"], m["rays_sem"], m["rays_traced"]
    rec = dict(frame_s=dt, frame_s_all=m["frame_s_all"], render_s=render_s,
               rays_sem=rays_sem, rays_traced=rays_traced,
               checksum=m["checksum"], repeats_bitwise=m["repeats_bitwise"],
               launches=launches)
    if main is not None:
        rec["vs_main"] = {
            k: rec[k] / main[k] - 1.0 for k in ("checksum", "rays_sem")}
    phase(title, size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          mrays_sem=rays_sem / dt / 1e6, mrays_traced=rays_traced / dt / 1e6,
          image_mean=float(img.mean()),
          peak_mem_gib=m["max_memory_allocated"] / 2**30,
          finite=finite, **rec)
    if main is not None and max(abs(v) for v in rec["vs_main"].values()) \
            >= 0.01:
        raise AssertionError(f"{title}: checksum or rays_sem off the main "
                             f"frame's by 1% or more: {rec['vs_main']}")
    rec["image"] = img
    return rec


def frame_cfg(**kw):
    """The benchmark frame's configuration (one whole-frame tile)."""
    return trt.RenderConfig(width=FRAME[0], height=FRAME[1],
                            samples_per_pixel=2, bounce_limit=8,
                            max_rays_per_batch=1 << 21, **kw)


def nondeterministic_ops(fn) -> list:
    """The ops of ``fn`` that torch flags as nondeterministic on the card
    (its deterministic-algorithms check, as warnings)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0] for w in caught
                   if "deterministic" in str(w.message)})


def progressive(sc, sc_cpu, tmp):
    """ProgressiveRenderer at the benchmark frame: three steps with the
    state saved after the second; a fresh renderer loads it and steps
    once, and its accumulation must be the third step's (bit for bit when
    two renders of the frame on the card are).  Then two steps at 64x36
    on the card against the CPU."""
    cfg = frame_cfg()
    first = trt.render_frame(sc, cfg)
    again = trt.render_frame(sc, cfg)
    deterministic = bool(torch.equal(first, again))
    render_diff = float((first - again).abs().max())
    del first, again
    pr = trt.ProgressiveRenderer(sc, cfg)
    state = os.path.join(tmp, "progressive.npz")
    bench.reset_launches()
    step_s = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pr.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 1:
            pr.save_state(state)
    launches = bench.all_launches()
    resumed = trt.ProgressiveRenderer(sc, cfg)
    resumed.load_state(state)
    if resumed.frame != 2 or resumed.accum.device != sc.device:
        raise AssertionError(f"progressive: resumed at frame "
                             f"{resumed.frame} on {resumed.accum.device}")
    resumed.step()
    equal = bool(torch.equal(resumed.accum, pr.accum))
    resume_diff = float((resumed.accum - pr.accum).abs().max())
    ops = [] if deterministic else nondeterministic_ops(
        lambda: trt.render_frame(sc, cfg))
    phase("progressive", size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          step_s=step_s, launches=launches, renders_bit_identical=deterministic,
          render_max_abs_diff=render_diff, resumed_equal=equal,
          resumed_max_abs_diff=resume_diff, nondeterministic_ops=ops,
          finite=bool(torch.isfinite(pr.accum).all()))
    if launches["group_traverse"] <= 0 or launches["group_anyhit"] <= 0:
        raise AssertionError(f"progressive: the group walk never ran: "
                             f"{launches}")
    if not bool(torch.isfinite(pr.accum).all()):
        raise AssertionError("progressive: accumulation not finite")
    if deterministic and not equal:
        raise AssertionError(f"progressive: the resumed step differs from "
                             f"the third by {resume_diff}")
    if not deterministic:
        images_agree("progressive_resumed", resumed.accum, pr.accum.cpu())
    del pr, resumed
    small = trt.RenderConfig(width=SMALL[0], height=SMALL[1],
                             samples_per_pixel=2, bounce_limit=8)
    card = trt.ProgressiveRenderer(sc, small)
    host = trt.ProgressiveRenderer(sc_cpu, small)
    for _ in range(2):
        card.step()
        host.step()
    images_agree("card_vs_cpu_progressive", card.accum, host.accum, steps=2)


def static_scan(sc, sc_cpu):
    """The static-scan integrator (path_regen=False) at the benchmark
    frame, then each estimator at 64x36 on the card against the CPU."""
    cfg = frame_cfg(path_regen=False)
    trt.render(sc, cfg)  # warm-up
    bench.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = trt.render(sc, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = bench.all_launches()
    finite = bool(torch.isfinite(img).all())
    # the occupancy profile: one sample of every pixel
    rot, pos, fov, aspect, near = _camera_arrays(scene_camera(sc), cfg,
                                                 sc.device)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=sc.device)
    rays = wavefront.raygen(rot, pos, fov, aspect, near, ids, cfg.width,
                            cfg.height)
    _, n_rays, (alive, nee) = wavefront.trace(sc, rays, ids, 0, 0, cfg,
                                              with_profile=True)
    profile = dict(lanes=cfg.n_pixels, alive=alive.tolist(),
                   nee_active=nee.tolist(), rays=n_rays.tolist())
    phase("static_scan", size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          frame_s=dt, checksum=float(img.sum()), image_mean=float(img.mean()),
          finite=finite, launches=launches, profile=profile)
    if len(profile["alive"]) != 9 or profile["alive"][0] <= 0 or \
            profile["alive"][-1] != 0.0:
        raise AssertionError(f"static_scan: bad profile {profile}")
    if img.shape != (FRAME[1], FRAME[0], 3) or not finite:
        raise AssertionError(f"static_scan: bad frame {tuple(img.shape)}")
    if launches["group_traverse"] <= 0 or launches["group_anyhit"] <= 0:
        raise AssertionError(f"static_scan: the group walk never ran: "
                             f"{launches}")
    del img
    for est in ("mis", "cosine", "uniform"):
        card_vs_cpu(sc, sc_cpu, f"card_vs_cpu_static_{est}",
                    path_regen=False, estimator=est)


def debug_heatmap(sc, sc_cpu):
    """render_debug (mode 2) at the viewer's preview size, and the box and
    triangle counts at 64x36 on the card against the CPU's."""
    cfg = trt.RenderConfig(width=PREVIEW[0], height=PREVIEW[1],
                           samples_per_pixel=1, bounce_limit=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = trt.render_debug(sc, cfg, mode=2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    small = cfg.replace(width=SMALL[0], height=SMALL[1])
    box, tri = (x.cpu() for x in api.debug_counts(sc, small))
    box_c, tri_c = api.debug_counts(sc_cpu, small)
    differ = (box != box_c) | (tri != tri_c)
    phase("debug_heatmap", size=f"{PREVIEW[0]}x{PREVIEW[1]}", spp=1,
          bounce=8, seconds=dt, image_mean=float(img.mean()),
          small=f"{SMALL[0]}x{SMALL[1]}", pixels_differ=int(differ.sum()),
          pixels=int(differ.numel()),
          max_box_diff=float((box - box_c).abs().max()),
          max_tri_diff=float((tri - tri_c).abs().max()),
          mean_box_tests=float(box_c.mean()),
          mean_tri_tests=float(tri_c.mean()))
    if img.shape != (PREVIEW[1], PREVIEW[0], 3) or not bool(
            torch.isfinite(img).all()) or float(img.max()) <= 0.0:
        raise AssertionError("debug_heatmap: bad heatmap")
    if float(differ.float().mean()) > 0.01:
        raise AssertionError(f"debug_heatmap: {int(differ.sum())} pixels' "
                             "counts differ from the CPU's")


def png_size(data: bytes):
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError("not a PNG")
    return struct.unpack(">II", data[16:24])


def cli(tmp):
    """The port's CLI as a user runs it: a progressive render with a
    checkpoint, twice (the second resumes), and the bench line."""
    base = [sys.executable, "-m", "ray_tracer_tpu_torch.cli"]
    frame_args = ["--preset", "sponza_proxy", "--width", str(FRAME[0]),
                  "--height", str(FRAME[1]), "--spp", "2"]
    out_png = os.path.join(tmp, "o.png")
    render = base + ["render", *frame_args, "--progressive", "2",
                     "--checkpoint", os.path.join(tmp, "s.npz"),
                     "-o", out_png]
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        out = subprocess.run(render, capture_output=True, text=True,
                             cwd=REPO, timeout=300)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"cli render: rc {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        report = json.loads(out.stdout.strip().splitlines()[-1])
        resumed = "resumed at frame 2" in out.stderr
        if resumed != (i == 1):
            raise AssertionError(f"cli render run {i}: resumed={resumed}")
        with open(out_png, "rb") as f:
            size = png_size(f.read(24))
        if size != FRAME:
            raise AssertionError(f"cli render: PNG of {size}")
        runs.append(dict(process_s=wall, report=report, resumed=resumed))
    t0 = time.perf_counter()
    out = subprocess.run(base + ["bench", *frame_args], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"cli bench: rc {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    bench = json.loads(out.stdout.strip().splitlines()[-1])
    phase("cli", render=runs, bench=bench, bench_process_s=wall)
    if bench["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"cli bench: device {bench['device']!r}")


BENCH_LINES = {  # bench line -> its environment, the modes it must launch,
    # and how far its checksum and rays_sem may lie from the main frame's
    "default": ({}, ("group_traverse", "group_anyhit"), bench.REPEAT_RTOL),
    "two_phase": ({"RT_TWO_PHASE": "1"},
                  ("packet8_top", "packet8_top_anyhit", "packet8_deep",
                   "packet8_deep_anyhit"), 0.01),
}


def bench_phase(main):
    """The bench as a user runs it, ``python -m ray_tracer_tpu_torch.bench``
    in a subprocess, by default and with ``RT_TWO_PHASE=1``: each line's
    gate must pass, its device be this card, its launches name the
    route's kernels, and its checksum and rays_sem agree with the main
    frame's."""
    lines = {}
    for name, (extra, modes, rtol) in BENCH_LINES.items():
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "ray_tracer_tpu_torch.bench"],
            capture_output=True, text=True, cwd=REPO, timeout=600,
            env={**os.environ, **extra})
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"bench {name}: rc {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        line = json.loads(out.stdout.strip().splitlines()[-1])
        vs_main = {k: line[k] / main[k] - 1.0 for k in ("checksum",
                                                         "rays_sem")}
        phase("bench", line=name, process_s=wall, vs_main=vs_main, **line)
        if line["gate"] != "pass" or \
                line["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"bench {name}: gate {line['gate']!r} on "
                                 f"{line['device']!r}")
        if min(line["launches"][m] for m in modes) <= 0:
            raise AssertionError(f"bench {name}: a mode of the route never "
                                 f"launched: {line['launches']}")
        if max(abs(v) for v in vs_main.values()) > rtol:
            raise AssertionError(f"bench {name}: checksum or rays_sem off "
                                 f"the main frame's by more than {rtol}: "
                                 f"{vs_main}")
        lines[name] = line
    return lines


def viewer_phase():
    """The viewer over the sponza_proxy builder at the benchmark frame's
    size (spp 1) on the card: its render loop and an HTTP server on
    127.0.0.1:0, each in a thread, and every endpoint requested."""
    import urllib.request

    from ray_tracer_tpu_torch import viewer

    cfg = trt.RenderConfig(width=FRAME[0], height=FRAME[1],
                           samples_per_pixel=1, bounce_limit=8)
    t0 = time.perf_counter()
    state = viewer.ViewerState(presets.sponza_proxy(SCENE_TRIS), cfg)
    build_s = time.perf_counter() - t0
    ticks = []
    tick = state._tick

    def timed_tick():
        tick()
        ticks.append((state.latest_is_preview, state.frame_ms))

    state._tick = timed_tick
    srv = viewer._make_server(state, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    threads = [threading.Thread(target=srv.serve_forever, daemon=True),
               threading.Thread(target=state.loop, daemon=True)]
    for t in threads:
        t.start()

    def get(path, timeout=120):
        return urllib.request.urlopen(url + path, timeout=timeout).read()

    def wait(cond, what, limit=120.0):
        end = time.perf_counter() + limit
        while not cond():
            if time.perf_counter() > end:
                raise AssertionError(f"viewer: timed out waiting for {what}")
            time.sleep(0.01)

    try:
        page = get("/")
        if b"ray_tracer_tpu_torch" not in page:
            raise AssertionError("viewer: bad page")
        wait(lambda: ticks, "the first tick")
        sizes = [png_size(get("/image.png"))]  # the preview
        wait(lambda: state.renderer.frame >= 3, "three full frames")
        sizes.append(png_size(get("/image.png")))
        stats = json.loads(get("/stats"))
        before = stats["frame"]
        get("/set?py=-1.9")
        after = json.loads(get("/stats"))["frame"]
        req = urllib.request.Request(
            url + "/edit", method="POST",
            data=json.dumps({"materials": {"1": {
                "albedo": [0.8, 0.1, 0.1]}}}).encode())
        t1 = time.perf_counter()
        edit = json.loads(urllib.request.urlopen(req, timeout=300).read())
        edit_s = time.perf_counter() - t1
        albedo = state.renderer.scene.mat_albedo[1].tolist()
        t1 = time.perf_counter()
        dbg = png_size(get("/debug.png?mode=2", timeout=600))
        debug_s = time.perf_counter() - t1
        wait(lambda: state.renderer.frame >= 2, "frames after the edit")
    finally:
        state.running = False
        srv.shutdown()
        for t in threads:
            t.join(timeout=120)
        srv.server_close()
    full = [ms for preview, ms in ticks if not preview]
    # a tick's parts: the sRGB bytes to the host, and the PNG at the
    # viewer's zlib level (0, stored), at 1 and at 6 (Pillow's default)
    accum = state.renderer.accum
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rgb = film.to_uint8_srgb(accum)
    encode = {"srgb_to_host_s": time.perf_counter() - t1}
    for level in sorted({viewer.PNG_LEVEL, 1, 6}):
        t1 = time.perf_counter()
        data = film.encode_png_uint8(rgb, level)
        encode[f"deflate_level{level}"] = dict(
            s=time.perf_counter() - t1, bytes=len(data))
    phase("viewer", size=f"{FRAME[0]}x{FRAME[1]}", spp=1, bounce=8,
          build_s=build_s, image_sizes=sizes, frame_before_set=before,
          frame_after_set=after, edit=edit, edit_s=edit_s,
          debug_png=dbg, debug_s=debug_s,
          encode=encode,
          ticks=[dict(preview=p, frame_ms=ms) for p, ms in ticks],
          full_frame_ms_median=statistics.median(full))
    preview = (state.preview.cfg.width, state.preview.cfg.height)
    if sizes != [preview, FRAME] or FRAME[0] >= 64 * 4 and preview != \
            PREVIEW:
        raise AssertionError(f"viewer: image sizes {sizes}")
    if not edit.get("ok") or albedo != [0.800000011920929,
                                        0.10000000149011612,
                                        0.10000000149011612]:
        raise AssertionError(f"viewer: edit {edit}, albedo {albedo}")
    if after >= before or dbg != (FRAME[0] // 2, FRAME[1] // 2):
        raise AssertionError(f"viewer: /set left frame {after} (was "
                             f"{before}); debug PNG {dbg}")
    if any(t.is_alive() for t in threads):
        raise AssertionError("viewer: a thread did not stop")


CONFIG_VALUES = {  # phase key -> the RenderConfig values of a frame
    "bin_leaf": dict(routing=trt.Routing(bin_mode="leaf")),
    "bin_hier": dict(routing=trt.Routing(bin_mode="hier")),
    "prebin_sort": dict(routing=trt.Routing(nee_prebin="sort")),
    "prebin_nosort": dict(routing=trt.Routing(nee_prebin="nosort")),
    "unbinned": dict(bin_rays=False),
}


def config_values(sc, sc_cpu, dev, main):
    """The wavefront's configuration values at the benchmark frame: the
    bin modes, pre-permute NEE and the unbinned wavefront only re-order
    lanes, so each image must equal the main frame's bit for bit; the
    closest-hit NEE resolve (``nee_anyhit=False``) must agree with its
    checksum and ray counts within 1%, and at 64x36 with the CPU."""
    out = {}
    for key, kw in CONFIG_VALUES.items():
        bench.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = trt.render(sc, frame_cfg(**kw))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        equal = bool(torch.equal(img, main["image"]))
        out[key] = dict(frame_s=dt, equal_to_main=equal,
                        launches=bench.all_launches())
        del img
        if not equal:
            raise AssertionError(f"config_values: {key}'s frame differs "
                                 "from the main frame")
    closest = frame(sc, dev, "frame_closest_nee", None, 1, main=main,
                    nee_anyhit=False)
    del closest["image"]
    phase("config_values", size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          main_render_s=main["render_s"], **out)
    card_vs_cpu(sc, sc_cpu, "card_vs_cpu_closest_nee", nee_anyhit=False)
    return closest


def wall_obj(tmp):
    """A 48x48-quad wall, 3 units square at z = 0, facing -z, its uv tiled
    4 times (an OBJ file in ``tmp``)."""
    n, tiles = 48, 4.0
    verts, uvs, faces = [], [], []
    for j in range(n + 1):
        for i in range(n + 1):
            verts.append((3.0 * i / n - 1.5, 3.0 * j / n - 1.5, 0.0))
            uvs.append((tiles * i / n, tiles * j / n))
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i + 1
            faces.append((a, a + n + 2, a + 1))
            faces.append((a, a + n + 1, a + n + 2))
    lines = [f"v {x} {y} {z}\n" for x, y, z in verts]
    lines += [f"vt {u} {v}\n" for u, v in uvs]
    lines += ["vn 0 0 -1\n"]
    lines += [f"f {a}/{a}/1 {b}/{b}/1 {c}/{c}/1\n" for a, b, c in faces]
    wall = os.path.join(tmp, "bump_wall.obj")
    with open(wall, "w") as f:
        f.write("".join(lines))
    return wall


def back_obj(tmp, z):
    """An 18-unit square at depth ``z`` facing +z (an OBJ file in
    ``tmp``)."""
    back = os.path.join(tmp, f"back_{z}.obj")
    with open(back, "w") as f:
        f.write(f"v -9 -9 {z}\nv 9 -9 {z}\nv 9 9 {z}\nv -9 9 {z}\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
                "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")
    return back


def png_file(tmp, name, rgb):
    """``rgb`` ((H, W, 3) u8 tensor) as a PNG written by ``film``."""
    path = os.path.join(tmp, name)
    with open(path, "wb") as f:
        f.write(film.encode_png_uint8(rgb.contiguous().numpy()))
    return path


def bumps(size, period):
    """A gray (size, size, 3) u8 height map of round bumps, ``period``
    texels apart."""
    y, x = torch.meshgrid(torch.arange(float(size)),
                          torch.arange(float(size)), indexing="ij")
    height = 0.5 + 0.5 * torch.cos(x * (2 * torch.pi / period)) * torch.cos(
        y * (2 * torch.pi / period))
    return (height * 255).round().to(torch.uint8)[..., None].expand(
        -1, -1, 3)


def bump_scene(tmp):
    """A scene built here with a generated height map: a 48x48-quad wall
    facing the camera (``wall_obj``), its uv tiled 4 times over a 128x128
    height map of round bumps (a PNG written by ``film``), a dark wall
    behind the camera and a rect light in front of the textured wall,
    offset to +x."""
    wall = wall_obj(tmp)
    back = back_obj(tmp, -3.2)
    png = png_file(tmp, "bump_height.png", bumps(128, 32))
    b = trt.SceneBuilder()
    tex = b.add_texture(png)
    mat = b.add_material(trt.Material(albedo=(0.8, 0.8, 0.8), bump_tex=tex))
    dark = b.add_material(trt.Material(albedo=(0.25, 0.25, 0.25)))
    glow = b.add_material(trt.Material(emission_color=(1, 1, 1),
                                       emission_strength=6.0))
    b.add_obj(wall, material=mat, sampler=1)
    b.add_obj(back, material=dark)
    b.add_rect_light((1.8, -0.6, -1.6), (0.6, 0.0, 0.0), (0.0, 1.2, 0.0),
                     (0.0, 0.0, -1.0), glow)
    b.set_environment(trt.Environment(enabled=False))
    b.set_camera(trt.Camera(position=(0, 0, -2.8), angles_deg=(0, 0, 0)))
    return b


def normal_maps(tmp):
    """Bump mapping on a scene built here (``bump_scene``): 64x36 on the
    card against the CPU with the map on, and the 1920x1080 frame's time
    with the map on and off; the map must move the image."""
    b = bump_scene(tmp)
    sc = b.compile()
    if sc.tex_size.tolist() != [[128, 128]] or sc.meta["n_bump_maps"] != 1:
        raise AssertionError(f"normal_maps: the height map did not load: "
                             f"{sc.tex_size.tolist()}")
    on = dict(enable_normal_maps=True, bump_scale=4.0)
    card_vs_cpu(sc, b.compile(device="cpu"), "card_vs_cpu_normal_maps", **on)
    times, imgs, launches = {}, {}, {}
    for key, kw in (("on", on), ("off", {})):
        trt.render(sc, frame_cfg(**kw))  # warm-up
        torch.cuda.synchronize()
        bench.reset_launches()
        t0 = time.perf_counter()
        imgs[key] = trt.render(sc, frame_cfg(**kw))
        torch.cuda.synchronize()
        times[key] = time.perf_counter() - t0
        launches[key] = bench.all_launches()
    moved = float((imgs["on"] - imgs["off"]).abs().mean())
    phase("normal_maps", size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          n_tris=sc.meta["n_tris"], frame_s_on=times["on"],
          frame_s_off=times["off"], image_mean_on=float(imgs["on"].mean()),
          image_mean_off=float(imgs["off"].mean()), mean_abs_moved=moved,
          launches_on=launches["on"], launches_off=launches["off"])
    if not bool(torch.isfinite(imgs["on"]).all()) or moved < 1e-3:
        raise AssertionError(f"normal_maps: the map moved the frame by "
                             f"{moved}")
    for key, got in launches.items():  # the maps instance, once a round
        once_a_round(f"normal_maps ({key})", got, "shade_round_maps")


def once_a_round(title, got, shade_key, walk="group_traverse"):
    """Raise unless a frame's launches (``bench.all_launches``) ran each
    round kernel once in each of its rounds, the shade kernel's instance
    ``shade_key`` and not the other: one closest-hit walk (``walk``) a
    round, after the camera rays' own.  Returns the rounds."""
    rounds = got[walk] - 1
    other = ({"shade_round", "shade_round_maps"} - {shade_key}).pop()
    want = {shade_key: rounds, other: 0, "permute_rows": rounds,
            "nee_resolve": rounds}
    if rounds <= 0 or any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{title}: the round kernels did not run once "
                             f"in each of its {rounds} rounds: {got}")
    return rounds


def maps_scene(tmp):
    """A scene built here with generated 1024x1024 maps on one material:
    an albedo gradient with a checker, a metalness map of stripes (one in
    four metal), an alpha map with cutout stripes (one band in four cut)
    and a height map of round bumps.  Two instances of ``wall_obj``'s
    wall side by side, bilinear on the left and nearest on the right,
    under the sky, a dark wall behind the camera and a rect light in front
    of the walls."""
    size = 1024
    y, x = torch.meshgrid(torch.arange(size), torch.arange(size),
                          indexing="ij")
    albedo = torch.stack([x * 255 // (size - 1), y * 255 // (size - 1),
                          ((x // 64 + y // 64) % 2) * 200 + 30], -1)
    metal = (((x // 128) % 4 == 0).to(torch.int64) * 255)
    alpha = (((y // 96) % 4 != 3).to(torch.int64) * 255)
    gray = lambda v: v[..., None].expand(-1, -1, 3).to(torch.uint8)
    b = trt.SceneBuilder()
    mat = b.add_material(trt.Material(
        albedo=(0.9, 0.85, 0.8),
        albedo_tex=b.add_texture(png_file(tmp, "maps_albedo.png",
                                          albedo.to(torch.uint8))),
        metalness_tex=b.add_texture(png_file(tmp, "maps_metal.png",
                                             gray(metal))),
        alpha_tex=b.add_texture(png_file(tmp, "maps_alpha.png", gray(alpha))),
        bump_tex=b.add_texture(png_file(tmp, "maps_height.png",
                                        bumps(size, 64)))))
    dark = b.add_material(trt.Material(albedo=(0.25, 0.25, 0.25)))
    glow = b.add_material(trt.Material(emission_color=(1, 1, 1),
                                       emission_strength=6.0))
    wall = wall_obj(tmp)
    b.add_obj(wall, material=mat, position=(-1.55, 0.0, 0.0), sampler=1)
    b.add_obj(wall, material=mat, position=(1.55, 0.0, 0.0), sampler=0)
    b.add_obj(back_obj(tmp, -7.0), material=dark)
    b.add_rect_light((-0.3, 1.0, -2.5), (0.6, 0.0, 0.0), (0.0, 0.0, 0.6),
                     (0.0, -1.0, 0.0), glow)
    b.set_environment(trt.Environment(enabled=True))
    b.set_camera(trt.Camera(position=(0, 0, -5.2), angles_deg=(0, 0, 0)))
    return b


def frame_launches(sc, cfg, kernels=()):
    """One frame through ``render`` under ``torch.profiler``: the card's
    kernel launches in it (every kernel, torch's own included), and the
    device ms and launches of each kernel whose name holds one of
    ``kernels``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trt.render(sc, cfg)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    in_frame = {k: dict(
        ms=sum(e.time_range.elapsed_us() for e in events if k in e.name)
        / 1e3,
        launches=sum(1 for e in events if k in e.name)) for k in kernels}
    return len(events), in_frame


def maps_phase(tmp):
    """Texture, metalness, alpha and bump maps through the round kernels
    at the benchmark frame (``maps_scene``, enable_normal_maps): every
    round kernel against its plain version on the frame's rounds 0, 2 and
    6, bit for bit (``round_checks``; its round 6 is the drain's 16,200
    lanes, so round 2 shows a wide wave past the first bounce too), the
    shade kernel alone on those rounds, the cutout, bumped, bilinear and
    nearest lanes over all rounds (each must be above 0), the frame equal
    to the torch round's bit for bit, both frames' times, the round
    kernels once a round, every kernel launch a round of both (the
    profiler's count), and both shade_kernel instances as ptxas reports
    them.  Returns the checks and the fused frame's launches."""
    b = maps_scene(tmp)
    t0 = time.perf_counter()
    sc = b.compile()
    compile_s = time.perf_counter() - t0
    meta = sc.meta
    if (sc.tex_size.tolist() != [[1024, 1024]] * 4
            or not meta["n_metalness_maps"] == meta["n_alpha_maps"]
            == meta["n_bump_maps"] == 1):
        raise AssertionError(f"maps: the maps did not load: "
                             f"{sc.tex_size.tolist()}, {meta}")
    on = dict(enable_normal_maps=True, bump_scale=4.0)
    cfg = frame_cfg(**on)
    if not wavefront._fused_round_ok(sc, cfg, cfg.resolved_routing()):
        raise AssertionError("maps: the frame does not take the round "
                             "kernels")
    checks, costs = round_checks(sc, "maps_", old=False,
                                 check_rounds=(0, 2, 6), **on)
    lanes = {k: sum(c[k] for c in costs["shade_round"])
             for k in ("cutout_lanes", "bump_lanes", "bilinear_lanes",
                       "nearest_lanes")}
    frames, times, launches, kernels, in_frame = {}, {}, {}, {}, {}
    fused_ok = wavefront._fused_round_ok
    try:
        for key in ("fused", "torch"):
            if key == "torch":
                wavefront._fused_round_ok = lambda *a: False
            trt.render(sc, cfg)  # warm-up
            torch.cuda.synchronize()
            bench.reset_launches()
            t0 = time.perf_counter()
            frames[key] = trt.render(sc, cfg)
            torch.cuda.synchronize()
            times[key] = time.perf_counter() - t0
            launches[key] = bench.all_launches()
            kernels[key], in_frame[key] = frame_launches(
                sc, cfg, ("shade_kernel",))
    finally:
        wavefront._fused_round_ok = fused_ok
    rounds = once_a_round("maps", launches["fused"], "shade_round_maps")
    if any(launches["torch"][k] for k in shade.launches):
        raise AssertionError(f"maps: the torch round launched a round "
                             f"kernel: {launches['torch']}")
    equal = bool(torch.equal(frames["fused"], frames["torch"]))
    ptx = {"maps": shade_ptxas(maps=True), "plain": shade_ptxas(maps=False)}
    phase("maps", size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          n_tris=meta["n_tris"], n_textures=meta["n_textures"],
          compile_s=compile_s, rounds=rounds, **lanes,
          frame_s_fused=times["fused"], frame_s_torch=times["torch"],
          speedup=times["torch"] / times["fused"], equal_to_torch=equal,
          image_mean=float(frames["fused"].mean()),
          finite=bool(torch.isfinite(frames["fused"]).all()),
          launches_fused=launches["fused"], launches_torch=launches["torch"],
          kernels_per_round_fused=kernels["fused"] / rounds,
          kernels_per_round_torch=kernels["torch"] / rounds,
          kernels_fused=kernels["fused"], kernels_torch=kernels["torch"],
          shade_maps_in_frame=in_frame["fused"]["shade_kernel"],
          shade_maps_ptxas=[x["lines"] for x in ptx["maps"]],
          shade_plain_ptxas=[x["lines"] for x in ptx["plain"]],
          shade_maps_spill_store_bytes=[x["spill_store_bytes"]
                                        for x in ptx["maps"]],
          frame_bound_ms=sum(c["bound_ms"] for c in costs["shade_round"]))
    if min(lanes.values()) <= 0:
        raise AssertionError(f"maps: a map never ran: {lanes}")
    if not equal or not bool(torch.isfinite(frames["fused"]).all()):
        raise AssertionError("maps: the round kernels' frame differs from "
                             "the torch round's, or is not finite")
    if len(ptx["maps"]) != 1 or len(ptx["plain"]) != 1:
        raise AssertionError(f"maps: shade_kernel instances: {ptx}")
    return checks, launches["fused"]


def forest_cost(counts, tmax0, anyhit, n_obj, stats=None) -> dict:
    """The forest walk's bound from its audit's counts (the work the
    culling kernel does on these rays): the rays, every instance and its
    chunk tree's nodes read once (and, where the plain walk's ``stats`` are
    given, the distinct node rows and triangle records it tested);
    ``OPS_WORLD_RAY`` a lane, ``OPS_CULL`` a box test of the trees, a
    candidate taken to object space (``OPS_SCAN``) and its root's box
    tested, 22 a child box and 40 a triangle the walks test."""
    seen = 0 if stats is None else (
        int(stats["node_seen"].sum()) * NODE2_BYTES
        + int(stats["tri_seen"].sum()) * RECORD_BYTES)
    chunks = -(-n_obj // packet.FOREST_CHUNK)
    tree_bytes = (2 * n_obj - chunks) * TREE_NODE_BYTES
    return bound(
        ray_bytes(tmax0, 1 if anyhit else 21) + n_obj * INSTANCE_BYTES
        + tree_bytes + seen,
        int((tmax0 > -BIG).sum()) * OPS_WORLD_RAY
        + counts["tree_tests"] * OPS_CULL
        + counts["world_pass"] * (OPS_SCAN + OPS_CHILD)
        + (counts["boxes"] - counts["roots"]) * OPS_CHILD
        + counts["tris"] * OPS_RECORD)


def forest_audit(args, anyhit, kernel_out, stats=None) -> dict:
    """The audit instance on one traversal's arguments: its outputs must
    equal the kernel's ``kernel_out`` and it must count no violation (an
    instance culled whose root test passes); with the plain walk's
    ``stats``, its scans, box and triangle tests must equal them.
    Returns its counts."""
    out, counts = packet.forest_audit(*args, anyhit=anyhit)
    if not all(torch.equal(a, b) for a, b in zip(_tuple(out),
                                                 _tuple(kernel_out))):
        raise AssertionError("forest audit: its outputs differ from the "
                             "kernel's")
    if counts["violations"]:
        raise AssertionError(f"forest audit: the cull dropped an instance "
                             f"whose root test passes: {counts}")
    if stats is not None and any(counts[k] != stats[k]
                                 for k in ("scans", "boxes", "tris")):
        raise AssertionError(f"forest audit: counts {counts} differ from "
                             f"the plain walk's stats")
    return counts


def forest_checks(sc, rays):
    """The forest walk (forest_walk_kernel) against its plain version
    (``packet.forest_traverse_reference``, which walks the instances one
    after the other: about a minute a set), closest hit on the camera and
    bounce sets and occlusion on the shadow set, every output equal; then
    the audit instance on the same rays (``forest_audit``: equal outputs,
    no violation, its scans, box and triangle tests the plain walk's).
    The bound is the culling kernel's (``forest_cost``, from the audit's
    counts and the plain walk's distinct rows); ``bound_unculled_ms`` the
    bound of the kernel without the cull: the rays, the instance table
    (the 48 B of the inverse transform a kernel reads, the root, its word
    and the root's row), the distinct node rows whose boxes were tested
    and the distinct triangle records tested; operations: 22 per box
    tested (the roots' too), 40 per triangle and ``OPS_SCAN`` per ray taken
    to an instance's object space."""
    out = {}
    n_obj = sc.meta["n_objects"]
    for name, anyhit in (("camera", False), ("bounce", False),
                         ("shadow", True)):
        args = measure_forest_walk.forest_args(sc, rays[name])
        plain_args = (*args[:4], sc.meta["obj_roots"], *args[7:])
        stats = {}

        def run(args=args, anyhit=anyhit):
            return _tuple(packet.forest_traverse(*args, anyhit=anyhit))

        def cost(args=args, stats=stats, anyhit=anyhit):
            counts = forest_audit(args, anyhit, run(), stats)
            old = bound(
                ray_bytes(args[9], 1 if anyhit else 21)
                + n_obj * (48 + 8 + NODE2_BYTES)
                + int(stats["node_seen"].sum()) * NODE2_BYTES
                + int(stats["tri_seen"].sum()) * RECORD_BYTES,
                stats["boxes"] * OPS_CHILD + stats["tris"] * OPS_RECORD
                + stats["scans"] * OPS_SCAN)
            return dict(forest_cost(counts, args[9], anyhit, n_obj, stats),
                        bound_unculled_ms=old["bound_ms"], audit=counts)

        out["forest_" + name] = measure(
            "forest_anyhit" if anyhit else "forest_walk", run,
            lambda plain_args=plain_args, anyhit=anyhit, stats=stats: _tuple(
                packet.forest_traverse_reference(*plain_args, anyhit=anyhit,
                                                 stats=stats)),
            equal_all(f"forest {name}"), cost, rays=name, n=N_CHECK,
            instances=n_obj, active=int((args[9] > -BIG).sum()))
    return out


def forest_ptxas():
    """The forest walk's ptxas lines (the shipped kernel's four instances:
    closest hit and occlusion, each with its audit; the kernel before the
    cull, old_forest_kernel of tools/forest_walk_variants.cu) and the
    narrow walk's, which shares walk(): bvh2_walk_kernel still at 56
    registers without a spill.  The forest walk may spill a few bytes at
    its 64 registers: eight blocks an SM that way measured faster than six
    without (tools/measure_forest_walk.py, "blocks6")."""
    ptxas = {
        "forest_walk_kernel": ptxas_of(packet.build_narrow(),
                                       "forest_walk_kernel"),
        "old_forest_kernel": ptxas_of(forest_walk_variants.build(),
                                      "old_forest_kernel"),
        "bvh2_walk_kernel": ptxas_of(packet.build_narrow(),
                                     "bvh2_walk_kernel"),
    }
    phase("forest_walk_ptxas", **ptxas)
    narrow = ptxas["bvh2_walk_kernel"]
    if len(ptxas["forest_walk_kernel"]) != 4 or len(narrow) != 1 \
            or narrow[0]["spill_store_bytes"] != 0 \
            or not any("Used 56 registers" in ln for ln in narrow[0]["lines"]):
        raise AssertionError(f"the forest walk's instances or the narrow "
                             f"walk's line changed: {ptxas}")


def forest_vs_unculled(sc, rays):
    """The culling forest walk against the kernel before the cull
    (old_forest_kernel
    of tools/forest_walk_variants.cu, every instance taken to object
    space) on the 2^18-lane camera, bounce and shadow sets: every output
    equal (``torch.equal``), then each timed in turns."""
    for name, anyhit in measure_forest_walk.SETS.items():
        args = measure_forest_walk.forest_args(sc, rays[name])

        def new(args=args, anyhit=anyhit):
            return packet.forest_traverse(*args, anyhit=anyhit)

        def old(args=args, anyhit=anyhit):
            return forest_walk_variants.run("old", *args, anyhit=anyhit)

        forest_walk_variants.compare(
            f"forest walk against the unculled, {name}", new(), old())
        phase("forest_vs_unculled", rays=name, n=N_CHECK, anyhit=anyhit,
              equal=True, active=int((args[9] > -BIG).sum()),
              **in_turns(new, old))


@contextlib.contextmanager
def unculled_forest_kernel():
    """Traversals of the forest walk through the kernel before the cull
    (``forest_walk_variants.run("old")``) in place of the shipped one;
    the launch counts count them as the shipped kernel's."""
    launch = packet._launch_forest

    def old(args, anyhit, counts=None):
        return forest_walk_variants.run("old", *args, anyhit=anyhit)

    packet._launch_forest = old
    try:
        yield
    finally:
        packet._launch_forest = launch


def forest_frame_bound(sc, cfg):
    """One forest frame whose every forest-walk traversal is followed by
    the audit instance on its arguments (``forest_audit``: equal outputs,
    no violation): each traversal's bound (``forest_cost``; the rays and
    the instance table as its bytes) and their sum, the frame bound."""
    traversals = []
    walk = packet.forest_traverse

    def audited(*args, anyhit=False):
        out = walk(*args, anyhit=anyhit)
        counts = forest_audit(args, anyhit, out)
        traversals.append(dict(
            anyhit=anyhit, lanes=int(args[7].shape[0]),
            **forest_cost(counts, args[9], anyhit, sc.meta["n_objects"]),
            **counts))
        return out

    packet.forest_traverse = audited
    try:
        trt.render(sc, cfg)
    finally:
        packet.forest_traverse = walk
    total = {k: sum(t[k] for t in traversals) for k in (
        "bound_ms", *packet.AUDIT_COUNTERS)}
    phase("forest_frame_bound", traversals=len(traversals),
          frame_bound_ms=total["bound_ms"],
          **{k: v for k, v in total.items() if k != "bound_ms"},
          per_traversal=traversals)
    return total


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def forest_vs_old(sc, rays):
    """The forest walk against the per-instance composition it replaced
    (``tools/measure_forest_walk.py::old_forest``: per instance a cuBLAS
    product, a narrow-walk launch and the merges) on the 2^18-lane camera
    and bounce sets (closest hit) and the shadow set (occlusion): the hits
    apart in at most 0.1% of the rays, ``dst`` within rtol 1e-5 where both
    hit in all but 1% of them (``measure_forest_walk.compare_old``), then
    each timed in turns.
    Returns the records by ray set."""
    out = {}
    for name, anyhit in measure_forest_walk.SETS.items():
        args = measure_forest_walk.forest_args(sc, rays[name])

        def new(args=args, anyhit=anyhit):
            return packet.forest_traverse(*args, anyhit=anyhit)

        def old(rays=rays[name], anyhit=anyhit):
            return measure_forest_walk.old_forest(sc, *rays, anyhit=anyhit)

        rec = {**measure_forest_walk.compare_old(f"forest walk, {name}",
                                                 new(), old(), anyhit),
               **in_turns(new, old)}
        phase("forest_vs_old", rays=name, n=N_CHECK, anyhit=anyhit,
              active=int((args[9] > -BIG).sum()), **rec)
        out[name] = rec
    return out


def forest(dev, main):
    """``sponza_proxy`` compiled as a forest (one BVH per mesh, every
    instance walked in one forest_walk_kernel launch a traversal): 64x36
    (spp 1) on the card against the CPU; the forest walk against its plain
    version on 2^18 rays of the frame's camera, bounce and shadow sets
    with its audit (``forest_checks``, with bounds), against the
    composition it replaced (``forest_vs_old``, in turns) and against the
    kernel before the cull (``forest_vs_unculled``, in turns, with the
    ptxas lines: ``forest_ptxas``) on those sets; then the benchmark
    frame on the round kernels, whose checksum and ray counts must agree
    with the main frame's within 1% (``frame``), equal bit for bit to the
    same frame on the torch round, both timed, with every kernel launch a
    round of both (the profiler's count) and the forest walk's device ms in
    the frame; each traversal one forest-walk launch, no narrow-walk
    launch, each round kernel once a round; the frame on the kernel before
    the cull and on this one in turns (that, this, this, that), each equal
    to the torch round's frame; one frame with the audit after every
    traversal, for the frame bound (``forest_frame_bound``).  Its image's
    mean |diff| from the main frame is printed (the forest's trees have no
    spatial splits, so the frames differ only at exact-t ties).  Returns
    the frame's record and the kernel checks."""
    t0 = time.perf_counter()
    sc = presets.sponza_proxy(SCENE_TRIS).compile(flatten_instances=False)
    compile_s = time.perf_counter() - t0
    cfg = trt.RenderConfig(width=SMALL[0], height=SMALL[1],
                           samples_per_pixel=1, bounce_limit=8)
    t0 = time.perf_counter()
    gpu = trt.render(sc, cfg)
    t1 = time.perf_counter()
    cpu = trt.render(sc.to("cpu"), cfg)
    images_agree("card_vs_cpu_forest", gpu, cpu, spp=1, card_s=t1 - t0,
                 cpu_s=time.perf_counter() - t1)
    rays = check_rays(sc, dev)
    checks = forest_checks(sc, rays)
    forest_vs_old(sc, rays)
    forest_ptxas()
    forest_vs_unculled(sc, rays)
    del rays
    rec = frame(sc, dev, "frame_forest", None, 1, main=main)
    cfg = frame_cfg()
    if not wavefront._fused_round_ok(sc, cfg, cfg.resolved_routing()):
        raise AssertionError("forest: the frame does not take the round "
                             "kernels")
    fused_ok = wavefront._fused_round_ok
    frames, times, launches, kernels, in_frame = {}, {}, {}, {}, {}
    try:
        for key in ("fused", "torch"):
            if key == "torch":
                wavefront._fused_round_ok = lambda *a: False
            trt.render(sc, cfg)  # warm-up
            torch.cuda.synchronize()
            bench.reset_launches()
            t0 = time.perf_counter()
            frames[key] = trt.render(sc, cfg)
            torch.cuda.synchronize()
            times[key] = time.perf_counter() - t0
            launches[key] = bench.all_launches()
            kernels[key], in_frame[key] = frame_launches(
                sc, cfg, ("forest_walk_kernel",))
    finally:
        wavefront._fused_round_ok = fused_ok
    with unculled_forest_kernel():
        trt.render(sc, cfg)  # warm-up
    turns = {"new": [], "unculled": []}
    for which in ("unculled", "new", "new", "unculled"):
        with (unculled_forest_kernel() if which == "unculled"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = trt.render(sc, cfg)
            torch.cuda.synchronize()
            turns[which].append(time.perf_counter() - t0)
        if not torch.equal(img, frames["torch"]):
            raise AssertionError(f"forest: the frame on the {which} forest "
                                 "kernel differs from the torch round's")
    phase("forest_frame_vs_unculled", size=f"{FRAME[0]}x{FRAME[1]}", spp=2,
          bounce=8, frame_s_new=statistics.mean(turns["new"]),
          frame_s_unculled=statistics.mean(turns["unculled"]),
          frame_s_new_runs=turns["new"],
          frame_s_unculled_runs=turns["unculled"],
          speedup=statistics.mean(turns["unculled"])
          / statistics.mean(turns["new"]), equal_to_torch=True)
    bound_total = forest_frame_bound(sc, cfg)
    rounds = once_a_round("forest", launches["fused"], "shade_round",
                          walk="forest_walk")
    walks = {k: rec["launches"][k] for k in ("forest_walk", "forest_anyhit",
                                             "packet_narrow")}
    if any(launches["torch"][k] for k in shade.launches):
        raise AssertionError(f"forest: the torch round launched a round "
                             f"kernel: {launches['torch']}")
    equal = bool(torch.equal(frames["fused"], frames["torch"]))
    diff = (rec.pop("image") - main["image"]).abs()
    phase("forest", size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          compile_s=compile_s, n_objects=sc.meta["n_objects"],
          n_tris=sc.meta["n_tris"], bvh_nodes=int(sc.bvh_packed.shape[0]),
          bvh_max_depth=sc.meta["bvh_max_depth"], frame_s=rec["frame_s"],
          render_s=rec["render_s"], rounds=rounds, **walks,
          frame_s_fused=times["fused"], frame_s_torch=times["torch"],
          speedup=times["torch"] / times["fused"], equal_to_torch=equal,
          launches_fused=launches["fused"], launches_torch=launches["torch"],
          kernels_per_round_fused=kernels["fused"] / rounds,
          kernels_per_round_torch=kernels["torch"] / rounds,
          kernels_fused=kernels["fused"], kernels_torch=kernels["torch"],
          forest_walk_in_frame=in_frame["fused"]["forest_walk_kernel"],
          forest_walk_frame_bound_ms=bound_total["bound_ms"],
          forest_walk_frame_share=bound_total["bound_ms"]
          / in_frame["fused"]["forest_walk_kernel"]["ms"],
          mean_abs_diff_vs_main=float(diff.mean()),
          pixels_within_2e3=float((diff.amax(dim=-1) <= 2e-3).float()
                                  .mean()))
    if walks["packet_narrow"] or walks["forest_walk"] != rounds + 1 \
            or walks["forest_anyhit"] != rounds:
        raise AssertionError(f"forest: not one forest-walk launch a "
                             f"traversal in {rounds} rounds: {walks}")
    if not equal:
        raise AssertionError("forest: the round kernels' frame differs from "
                             "the torch round's")
    return rec, checks


def sharded(sc):
    """An NCCL world of one on the card: ``render_frame_sharded`` on a
    (1, 1) mesh must equal ``render_frame`` of the whole frame bit for
    bit; then the port's ``dryrun_multichip(1)`` (one spawned rank)."""
    import torch.distributed as dist

    from ray_tracer_tpu_torch.parallel import entry, mesh

    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{mesh.free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        m = mesh.make_mesh(n_data=1, n_sample=1)
        init_s = time.perf_counter() - t0
        cfg = frame_cfg()
        sharded_s = []  # the first sets up the NCCL communicators
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = mesh.render_frame_sharded(sc, cfg, m)
            torch.cuda.synchronize()
            sharded_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = trt.render_frame(sc, cfg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        equal = bool(torch.equal(img, want))
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    summary = entry.dryrun_multichip(1, timeout=600)
    dryrun_s = time.perf_counter() - t0
    phase("sharded", size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          backend="nccl", world=1, init_s=init_s,
          frame_s_first=sharded_s[0], frame_s=sharded_s[1],
          render_frame_s=plain_s, equal_to_render_frame=equal,
          dryrun=summary, dryrun_s=dryrun_s)
    if not equal:
        raise AssertionError("sharded: the (1, 1) mesh's frame differs from "
                             "render_frame's")


def build_all() -> None:
    """Every kernel library, one nvcc each, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = list(pool.map(lambda build: build(), LIBRARIES))
    ptxas = {}
    for lib in libs:
        with open(lib[:-3] + ".log") as f:
            ptxas[os.path.basename(lib)] = [
                ln.strip() for ln in f if "registers" in ln]
    phase("build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
          torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())

    build_all()

    t0 = time.perf_counter()
    sc = presets.sponza_proxy(SCENE_TRIS).compile(clusters=True,
                                                  rope_streams=True)
    t1 = time.perf_counter()
    sc16 = presets.sponza_proxy(SCENE_TRIS).compile(merge_wide_leaves=True)
    t2 = time.perf_counter()
    dev = sc.device  # the card: compile() defaults to it
    # the rope streams' share of the compile: the same build once more;
    # and the old streams (BOX and TRI rows of 64 B) for lanewalk_vs_old
    host = [getattr(sc, f).cpu().numpy() for f in (
        "bvh_min", "bvh_max", "bvh_index", "bvh_tri_count", "bvh_hit_link",
        "bvh_miss_link")]
    t3 = time.perf_counter()
    lanewalk.build_rope_streams(*host, sc.tri_packed.shape[0])
    rope_s = time.perf_counter() - t3
    del host
    t3 = time.perf_counter()
    old_rope = rope_walk_variants.old_streams(sc)
    torch.cuda.synchronize()
    old_rope_s = time.perf_counter() - t3
    phase("compile", seconds=t1 - t0, seconds_16=t2 - t1,
          rope_rows=sc.meta["rope_rows"], rope_bytes=nbytes(sc.rope_streams),
          rope_build_s=rope_s, old_rope_rows=old_rope[1],
          old_rope_bytes=nbytes(old_rope[0]), old_rope_build_s=old_rope_s,
          tri_packed_bytes=nbytes(sc.tri_packed),
          B=int(sc.bvh_packed.shape[0]),
          n_tris=sc.meta["n_tris"], W=int(sc.wide_packed.shape[0]),
          L=int(sc.leaf_rows.shape[0]),
          wide_leaf_recs=sc.meta["wide_leaf_recs"],
          n_clusters=sc.meta["n_clusters"], n_supers=sc.meta["n_supers"],
          Wc=int(sc.cwide_packed.shape[0]), clus_mt_bytes=nbytes(sc.clus_mt),
          L16=int(sc16.leaf_rows.shape[0]),
          wide_leaf_recs_16=sc16.meta["wide_leaf_recs"])
    if sc.meta["n_supers"] <= 0 or sc.meta["n_clusters"] <= 0:
        raise AssertionError("no cluster or super tables: the cluster route "
                             "or its box enumeration cannot run")
    if sc16.meta["wide_leaf_recs"] != 16:
        raise AssertionError("the merged scene has no 16-record slots")
    if sc.meta["rope_rows"] <= 0:
        raise AssertionError("no rope streams: the rope walk cannot run")

    # its stack frame is the local stack array; nothing spills (closest
    # and occlusion, one- and two-row slots)
    walks = ptxas_of(bvh8.build(), "group_walk_kernel")
    phase("group_walk_ptxas", kernels=walks)
    if len(walks) != 4 or any(w["spill_store_bytes"] != 0 for w in walks):
        raise AssertionError(f"group_walk_kernel spills: {walks}")

    # the narrow walk: its stack of far children; no spills
    narrow = ptxas_of(packet.build_narrow(), "bvh2_walk_kernel")
    phase("narrow_walk_ptxas", kernels=narrow)
    if len(narrow) != 1 or narrow[0]["spill_store_bytes"] != 0:
        raise AssertionError(f"bvh2_walk_kernel spills: {narrow}")

    # the cluster chunk kernels: no spills
    chunk_kernels = [w for name in ("cluster_pairs_kernel", "box_hits_kernel")
                     for w in ptxas_of(cluster.build(), name)]
    phase("cluster_ptxas", kernels=chunk_kernels)
    if len(chunk_kernels) != 2 or any(w["spill_store_bytes"] != 0
                                      for w in chunk_kernels):
        raise AssertionError(f"a cluster chunk kernel spills: "
                             f"{chunk_kernels}")

    # the DEEP kernel: no spills
    deep = ptxas_of(bvh8.build(), "deep_walk_kernel")
    phase("deep_walk_ptxas", kernels=deep)
    if len(deep) != 4 or any(w["spill_store_bytes"] != 0 for w in deep):
        raise AssertionError(f"deep_walk_kernel spills: {deep}")

    # the cluster enumeration walk (rows staged or in place) and the rope
    # walk (closest and occlusion): no spills
    emit = ptxas_of(bvh8.build(), "emit_walk_kernel")
    phase("emit_walk_ptxas", kernels=emit)
    if len(emit) != 2 or any(w["spill_store_bytes"] != 0 for w in emit):
        raise AssertionError(f"emit_walk_kernel spills: {emit}")
    rope = ptxas_of(lanewalk.build(), "rope_walk_kernel")
    phase("rope_walk_ptxas", kernels=rope)
    if len(rope) != 2 or any(w["spill_store_bytes"] != 0 for w in rope):
        raise AssertionError(f"rope_walk_kernel spills: {rope}")

    # the TOP kernel (closest and occlusion, one- and two-row slots, rows
    # staged or in place): its stack sized for the top level; no spills
    top = ptxas_of(bvh8.build(), "top_walk_kernel")
    phase("top_walk_ptxas", kernels=top)
    if len(top) != 8 or any(w["spill_store_bytes"] != 0 for w in top):
        raise AssertionError(f"top_walk_kernel spills: {top}")

    rays = check_rays(sc, dev)
    top_vs_old(sc, rays, N_CHECK)
    deep_vs_old(sc, rays)
    group_vs_old(sc, rays, N_CHECK)
    packet_vs_old(sc, sc16, rays)
    narrow_vs_old(sc, rays, N_CHECK)
    emit_vs_old(sc, rays, N_CHECK)
    lanewalk_vs_old(sc, old_rope, rays, N_CHECK)
    wide_rays = check_rays(sc, dev, N_WIDE)
    top_vs_old(sc, wide_rays, N_WIDE)
    group_vs_old(sc, wide_rays, N_WIDE)
    narrow_vs_old(sc, wide_rays, N_WIDE)
    emit_vs_old(sc, wide_rays, N_WIDE)
    lanewalk_vs_old(sc, old_rope, wide_rays, N_WIDE)
    del wide_rays, old_rope
    chunks = cluster_chunks(sc, rays)
    cluster_vs_old(chunks)
    checks = {**group_checks(sc, rays), **packet_checks(sc, sc16, rays),
              **cluster_checks(sc, chunks), **narrow_checks(sc, rays),
              **lanewalk_checks(sc, rays), **treelet_checks(sc, rays),
              **round_checks(sc)[0]}
    del sc16, chunks

    sc_cpu = sc.to("cpu")
    card_vs_cpu(sc, sc_cpu, "card_vs_cpu")
    card_vs_cpu(sc, sc_cpu, "card_vs_cpu_cluster", ROUTES["frame_cluster"][0])
    card_vs_cpu(sc, sc_cpu, "card_vs_cpu_packet", ROUTES["frame_packet"][0])
    card_vs_cpu(sc, sc_cpu, "card_vs_cpu_narrow", ROUTES["frame_narrow"][0])
    card_vs_cpu(sc, sc_cpu, "card_vs_cpu_lanewalk",
                ROUTES["frame_lanewalk"][0])
    card_vs_cpu(sc, sc_cpu, "card_vs_cpu_two_phase",
                ROUTES["frame_two_phase"][0])

    frames = {"frame": frame(sc, dev, "frame", None, TIMED_FRAMES)}
    for title, (routing, timed) in ROUTES.items():
        frames[title] = frame(sc, dev, title, routing, timed,
                              main=frames["frame"])
        del frames[title]["image"]
    must = {  # the frame phase that drives each mode, and its modes
        "frame": ("group_traverse", "group_anyhit"),
        "frame_cluster": ("packet8_emit", "cluster_pairs", "packet8_wide",
                          "packet8_anyhit"),
        "frame_cluster_boxes": ("box_hits", "cluster_pairs"),
        "frame_packet": ("packet8_wide", "packet8_anyhit"),
        "frame_narrow": ("packet_narrow",),
        "frame_lanewalk": ("lanewalk_closest", "lanewalk_anyhit"),
        "frame_two_phase": ("packet8_top", "packet8_top_anyhit",
                            "packet8_deep", "packet8_deep_anyhit"),
    }
    for title, modes in must.items():
        got = frames[title]["launches"]
        if min(got[m] for m in modes) <= 0:
            raise AssertionError(f"{title}: a kernel mode never launched: "
                                 f"{got}")
    # the main frame's rounds: each round kernel (the untextured shade
    # kernel) once a round
    once_a_round("frame", frames["frame"]["launches"], "shade_round")

    # the configuration values, bump maps, texture maps and forest scenes
    with tempfile.TemporaryDirectory(prefix="rt_smoke_") as tmp:
        frames["frame_closest_nee"] = config_values(sc, sc_cpu, dev,
                                                    frames["frame"])
        normal_maps(tmp)
        maps_checks, maps_launches = maps_phase(tmp)
    checks.update(maps_checks)
    frames["maps"] = {"launches": maps_launches}
    frames["frame_forest"], forest_kernels = forest(dev, frames["frame"])
    checks.update(forest_kernels)
    if frames["frame_closest_nee"]["launches"]["group_traverse"] <= 0:
        raise AssertionError("frame_closest_nee: the group walk never ran")

    # the modules a user drives besides render: ProgressiveRenderer, the
    # static scan, the debug heatmaps, the CLI and the viewer
    with tempfile.TemporaryDirectory(prefix="rt_smoke_") as tmp:
        progressive(sc, sc_cpu, tmp)
        static_scan(sc, sc_cpu)
        debug_heatmap(sc, sc_cpu)
        del sc_cpu
        cli(tmp)
    bench_phase(frames["frame"])
    viewer_phase()
    # sharded rendering over torch.distributed
    sharded(sc)

    source = {  # mode -> (its check, the frame phase of its launches)
        "group_traverse": ("group_bounce", "frame"),
        "group_anyhit": ("group_shadow", "frame"),
        "packet8_wide": ("packet_bounce", "frame_packet"),
        "packet8_anyhit": ("packet_shadow", "frame_packet"),
        "packet8_emit": ("packet_emit", "frame_cluster"),
        "cluster_pairs": ("cluster_pairs", "frame_cluster"),
        "box_hits": ("box_hits_2", "frame_cluster_boxes"),
        "packet_narrow": ("narrow_bounce", "frame_narrow"),
        "lanewalk_closest": ("lanewalk_bounce", "frame_lanewalk"),
        "lanewalk_anyhit": ("lanewalk_shadow", "frame_lanewalk"),
        "packet8_top": ("top_bounce", "frame_two_phase"),
        "packet8_top_anyhit": ("top_shadow", "frame_two_phase"),
        "packet8_deep": ("deep2_bounce", "frame_two_phase"),
        "packet8_deep_anyhit": ("deep2_shadow", "frame_two_phase"),
        "shade_round": ("shade_round_0", "frame"),
        "shade_round_maps": ("maps_shade_round_maps_0", "maps"),
        "permute_rows": ("permute_rows_0", "frame"),
        "nee_resolve": ("nee_resolve_0", "frame"),
        "forest_walk": ("forest_bounce", "frame_forest"),
        "forest_anyhit": ("forest_shadow", "frame_forest"),
    }
    kernels = []
    for name, (check, title) in source.items():
        c = checks[check]
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name][0],
            kernel=KERNELS[name][1], replaces=KERNELS[name][2],
            launches=frames[title]["launches"][name],
            max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"], library_ms=None,
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
