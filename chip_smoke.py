"""Smoke run of ray_tracer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel library from this checkout (in parallel), prints
the main path's kernel (group_walk_kernel) as ptxas reports it, holds it
against walk_kernel, the design it replaced, and times both in turns on
bounce and shadow rays at 2^18 and 2^22 lanes (the frame's widest round),
prints the cluster route's chunk kernels (cluster_pairs_kernel,
box_hits_kernel) as ptxas reports them and holds each against the design
it replaced (tools/cluster_test_variants.cu) on the route's chunks, timed
in turns, checks each kernel mode against its plain torch version on the
card at the main path's shapes, checks small card renders against the same
renders on the CPU, and renders the benchmark frame (sponza_proxy,
1920x1080, spp 2, bounce limit 8, one whole-frame tile) through each
traversal route of the port: the group kernel (the default), the cluster
route with packet and with box enumeration, the packet walk, the narrow
binary-BVH walk, the rope walk and two-phase treelet traversal.  Every phase prints one line;
any failure raises, so the exit code is non-zero and no result line is
printed.  The line before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.append(os.path.join(REPO, "tools"))

import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch.api import _camera_arrays, scene_camera  # noqa: E402
from ray_tracer_tpu_torch.integrator import wavefront  # noqa: E402
from ray_tracer_tpu_torch.kernels import (  # noqa: E402
    bvh8, cluster, group, lanewalk, packet,
)
from ray_tracer_tpu_torch.ops import (  # noqa: E402
    cluster_trace, intersect, traverse,
)
from ray_tracer_tpu_torch.sampling import bsdf, lights, rng  # noqa: E402
from ray_tracer_tpu_torch.scene import presets  # noqa: E402

import cluster_test_variants  # noqa: E402

BIG = group.BIG
FRAME = (1920, 1080)  # the benchmark frame: spp 2, bounce limit 8
SMALL = (64, 36)  # the card-vs-CPU frame
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
KERNEL_MODULES = (group, packet, cluster, lanewalk)  # the launch counters
# one nvcc build each
LIBRARIES = (bvh8.build, cluster.build, packet.build_narrow, lanewalk.build,
             cluster_test_variants.build)
KERNELS = {  # mode -> (source, the TPU kernel it replaces)
    "group_traverse": ("ray_tracer_tpu_torch/csrc/bvh8_walk.cu",
                       "ray_tracer_tpu/kernels/group.py:89"),
    "group_anyhit": ("ray_tracer_tpu_torch/csrc/bvh8_walk.cu",
                     "ray_tracer_tpu/kernels/group.py:89"),
    "packet8_wide": ("ray_tracer_tpu_torch/csrc/bvh8_walk.cu",
                     "ray_tracer_tpu/kernels/packet.py:301"),
    "packet8_anyhit": ("ray_tracer_tpu_torch/csrc/bvh8_walk.cu",
                       "ray_tracer_tpu/kernels/packet.py:301"),
    "packet8_emit": ("ray_tracer_tpu_torch/csrc/bvh8_walk.cu",
                     "ray_tracer_tpu/kernels/packet.py:301"),
    "cluster_pairs": ("ray_tracer_tpu_torch/csrc/cluster_test.cu",
                      "ray_tracer_tpu/kernels/cluster.py:36"),
    "box_hits": ("ray_tracer_tpu_torch/csrc/cluster_test.cu",
                 "ray_tracer_tpu/kernels/cluster.py:164"),
    "packet_narrow": ("ray_tracer_tpu_torch/csrc/bvh2_walk.cu",
                      "ray_tracer_tpu/kernels/packet.py:53"),
    "lanewalk_closest": ("ray_tracer_tpu_torch/csrc/lanewalk.cu",
                         "ray_tracer_tpu/kernels/lanewalk.py:167"),
    "lanewalk_anyhit": ("ray_tracer_tpu_torch/csrc/lanewalk.cu",
                        "ray_tracer_tpu/kernels/lanewalk.py:167"),
    **{mode: ("ray_tracer_tpu_torch/csrc/bvh8_walk.cu",
              "ray_tracer_tpu/kernels/packet.py:301")
       for mode in ("packet8_top", "packet8_top_anyhit", "packet8_deep",
                    "packet8_deep_anyhit")},
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
# Bytes the function needs per unit: a node's 8 child boxes with codes
# and axis, a record's v0|e1|e2|n|front_only, a triangle's non-zero page
# coefficients (T 4, B 3, U 6, V 6, FO 1), a box's 6 planes, a binary
# node's bvh_packed row, a rope-stream row.
NODE_BYTES = 64 * 4
RECORD_BYTES = 13 * 4
TRI_BYTES = 20 * 4
BOX_BYTES = 6 * 4
NODE2_BYTES = 8 * 4
ROPE_ROW_BYTES = 16 * 4


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


def reset_launches() -> None:
    for m in KERNEL_MODULES:
        m.reset_launches()


def all_launches() -> dict:
    return {k: v for m in KERNEL_MODULES for k, v in m.launches.items()}


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
        sc, wavefront.CameraRays(o, d), hit)[:2]
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


def measure(name, run, plain, compare, cost, **fields):
    """Run a kernel and its plain version on the same inputs, hold them
    together with ``compare`` (raises), time both, and print the check.
    The plain version runs once: its time is that of the call compared."""
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
    )
    ms = cuda_ms(run, 20)
    plain_ms = start.elapsed_time(stop)
    rec = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, **cost(), **fields)
    phase("kernel_vs_plain", kernel=name, exact=True, **rec)
    return rec


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
    emits), the distinct nodes and the real records of the distinct leaf
    slots the rays visited are read once, and every real child box and
    record visited is tested.  ``nodes`` (the TOP walk's tree): the troot
    flags of the visited nodes' interior children are read too;
    ``extra_bytes``: other inputs read once (DEEP entry lists)."""
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


def narrow_checks(sc, rays):
    """The narrow walk (all five outputs) on the bounce set and, clipped at
    the light, on the shadow set, exact against the plain walk.  Bytes:
    the rays, the distinct node rows whose boxes were tested and the
    distinct triangle records tested; operations: 22 per box and 40 per
    triangle tested."""
    out = {}
    root = int(sc.obj_bvh_root[0])
    for name in ("bounce", "shadow"):
        args = (sc.bvh_packed, sc.bvh_axis, sc.tri_packed, *rays[name], root)
        stats = {}

        def cost(args=args, stats=stats):
            return bound(
                ray_bytes(args[5], 17)
                + int(stats["node_seen"].sum()) * NODE2_BYTES
                + int(stats["tri_seen"].sum()) * RECORD_BYTES,
                stats["boxes"] * OPS_CHILD + stats["tris"] * OPS_RECORD)

        out["narrow_" + name] = measure(
            "packet_narrow", lambda: packet.packet_traverse(*args),
            lambda: packet.packet_traverse_reference(*args, stats=stats),
            equal_all(f"narrow {name}"), cost,
            rays=name, n=N_CHECK, active=int((args[5] > -BIG).sum()),
        )
    return out


def lanewalk_checks(sc, rays):
    """The rope walk, closest hit on the bounce set and occlusion on the
    shadow set, exact against the plain walk.  Bytes: the rays and the
    distinct 64 B rows stepped on; operations: 22 per BOX row and 40 per
    TRI row stepped."""
    out = {}
    for name, anyhit in (("bounce", False), ("shadow", True)):
        args = (sc.rope_streams, sc.meta["rope_rows"], *rays[name])
        stats = {}

        def cost(args=args, stats=stats):
            return bound(
                ray_bytes(args[4], 8)
                + int(stats["row_seen"].sum()) * ROPE_ROW_BYTES,
                stats["box"] * OPS_CHILD + stats["tri"] * OPS_RECORD)

        out["lanewalk_" + name] = measure(
            "lanewalk_anyhit" if anyhit else "lanewalk_closest",
            lambda: lanewalk.lanewalk_traverse(*args, anyhit=anyhit),
            lambda: lanewalk.lanewalk_traverse_reference(
                *args, anyhit=anyhit, stats=stats),
            equal_all(f"lanewalk {name}"), cost,
            rays=name, n=N_CHECK, anyhit=anyhit,
            active=int((args[4] > -BIG).sum()),
        )
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


def group_vs_old(sc, rays, n):
    """group_walk_kernel against walk_kernel, the design it replaced (the
    packet walk with one-row slots), on the bounce and shadow sets of
    ``n`` lanes: equal outputs (``torch.equal``), then each timed in turns
    (old, new, new, old; 10 launches each).  The plain walk does not run
    here."""
    recs = sc.meta["wide_leaf_recs"]
    if recs > 8:
        raise AssertionError(f"the group walk reads one-row slots, not {recs}")
    for name, anyhit in (("bounce", False), ("shadow", True)):
        args = (sc.wide_packed, sc.leaf_rows, *rays[name])
        runs = {
            "new": lambda args=args, anyhit=anyhit: group.group_traverse(
                *args, anyhit=anyhit),
            "old": lambda args=args, anyhit=anyhit:
                packet.packet_traverse_wide(*args, recs, anyhit=anyhit),
        }
        for a, b in zip(runs["new"](), runs["old"]()):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} at {n} lanes: the group walk "
                                     "and the packet walk differ")
        times = {"new": [], "old": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(cuda_ms(runs[which], 10))
        rec = dict(new_ms=statistics.mean(times["new"]),
                   old_ms=statistics.mean(times["old"]),
                   new_ms_runs=times["new"], old_ms_runs=times["old"])
        phase("group_vs_old", rays=name, n=n, anyhit=anyhit, equal=True,
              active=int((args[4] > -BIG).sum()),
              speedup=rec["old_ms"] / rec["new_ms"], **rec)


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

    def compare_sets(got, want):
        (slots, ovf), (rslots, rovf) = got, want
        if not torch.equal(ovf, rovf):
            raise AssertionError("emit: overflow flags differ")
        if not torch.equal(slots.sort(dim=1).values,
                           rslots.sort(dim=1).values):
            raise AssertionError("emit: slot sets differ")

    out["packet_emit"] = measure(
        "packet8_emit",
        lambda: packet.packet_traverse_wide(*args, top_k=k,
                                            emit_leaves=True),
        lambda: packet.packet_traverse_wide_reference(
            *args, top_k=k, emit_leaves=True, stats=stats),
        compare_sets,
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
            plain_kw = {k: v for k, v in kw.items() if k != "deep_e"}

            def cost(args=args, kw=kw, stats=stats):
                if "troot" in kw:
                    return walk_cost(stats, args[4], sc.leaf_rows,
                                     emit_k=kw["top_k"], nodes=sc.wide_packed)
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
                slots, ovf = packet.packet_traverse_wide(*args, **kw)[2:]
                phase("two_phase_stats", rays=name, anyhit=anyhit,
                      n_treelets=sc.meta["n_treelets"], top_k=kw["top_k"],
                      mean_entries=float((slots >= 0).sum()) / N_CHECK,
                      overflow_share=float((ovf > 0).float().mean()))
    return out


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
        times = {"new": [], "old": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(cuda_ms(new if which == "new" else old, 10))
        rec = dict(new_ms=statistics.mean(times["new"]),
                   old_ms=statistics.mean(times["old"]),
                   new_ms_runs=times["new"], old_ms_runs=times["old"])
        phase("cluster_vs_old", kernel=name, equal=True,
              chunks=int(ids.numel()), live_chunks=int((ids >= 0).sum()),
              speedup=rec["old_ms"] / rec["new_ms"], **rec)
        out[name] = rec
    return out


def card_vs_cpu(sc, sc_cpu, title, routing=None):
    cfg = trt.RenderConfig(width=SMALL[0], height=SMALL[1],
                           samples_per_pixel=2, bounce_limit=8,
                           routing=routing)
    t0 = time.perf_counter()
    gpu = trt.render(sc, cfg).cpu()
    t1 = time.perf_counter()
    cpu = trt.render(sc_cpu, cfg)
    t2 = time.perf_counter()
    diff = (gpu - cpu).abs()
    within = float((diff.amax(dim=-1) <= 2e-3).float().mean())
    phase(title, size=f"{SMALL[0]}x{SMALL[1]}", spp=2, bounce=8,
          pixels_within_2e3=within, mean_abs_diff=float(diff.mean()),
          max_abs_diff=float(diff.max()), card_s=t1 - t0, cpu_s=t2 - t1)
    if not bool(torch.isfinite(gpu).all()):
        raise AssertionError(f"{title}: card image not finite")
    if within < 0.99 or float(diff.mean()) >= 1e-3:
        raise AssertionError(f"{title}: card and CPU renders disagree")


def frame(sc, dev, title, routing, timed, main=None):
    """The benchmark frame through ``render`` (the launch counts are this
    call's), then ``timed`` frames of bench.py's measure (frame index 1,
    ray counts from the wavefront): their median time, and the checksum
    and ray counts, which must agree with ``main``'s within 1%."""
    cfg = trt.RenderConfig(width=FRAME[0], height=FRAME[1],
                           samples_per_pixel=2, bounce_limit=8,
                           max_rays_per_batch=1 << 21, routing=routing)
    reset_launches()
    img = trt.render(sc, cfg)
    torch.cuda.synchronize()
    launches = all_launches()
    finite = bool(torch.isfinite(img).all())
    if img.shape != (FRAME[1], FRAME[0], 3) or not finite:
        raise AssertionError(f"{title}: bad frame {tuple(img.shape)} "
                             f"finite={finite}")
    cam = _camera_arrays(scene_camera(sc), cfg, dev)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, n_rays = wavefront.trace_wave(sc, *cam, ids, 1, 0, 2, cfg,
                                           with_stats=True)
        checksum = float(acc.sum())
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    rays_sem, rays_traced = (int(x) for x in n_rays.tolist())
    rec = dict(frame_s=dt, frame_s_all=times, rays_sem=rays_sem,
               rays_traced=rays_traced, checksum=checksum,
               launches=launches)
    if main is not None:
        rec["vs_main"] = {
            k: rec[k] / main[k] - 1.0 for k in ("checksum", "rays_sem")}
    phase(title, size=f"{FRAME[0]}x{FRAME[1]}", spp=2, bounce=8,
          mrays_sem=rays_sem / dt / 1e6, mrays_traced=rays_traced / dt / 1e6,
          image_mean=float(img.mean()),
          peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
          finite=finite, **rec)
    if main is not None and max(abs(v) for v in rec["vs_main"].values()) \
            >= 0.01:
        raise AssertionError(f"{title}: checksum or rays_sem off the main "
                             f"frame's by 1% or more: {rec['vs_main']}")
    return rec


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
    # the rope streams' share of the compile: the same build once more
    host = [getattr(sc, f).cpu().numpy() for f in (
        "bvh_min", "bvh_max", "bvh_index", "bvh_tri_count", "bvh_hit_link",
        "bvh_miss_link", "tri_packed")]
    t3 = time.perf_counter()
    lanewalk.build_rope_streams(*host)
    rope_s = time.perf_counter() - t3
    del host
    phase("compile", seconds=t1 - t0, seconds_16=t2 - t1,
          rope_rows=sc.meta["rope_rows"], rope_bytes=nbytes(sc.rope_streams),
          rope_build_s=rope_s, B=int(sc.bvh_packed.shape[0]),
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

    # its stack frame is the local stack array; nothing spills
    walks = ptxas_of(bvh8.build(), "group_walk_kernel")
    phase("group_walk_ptxas", kernels=walks)
    if len(walks) != 2 or any(w["spill_store_bytes"] != 0 for w in walks):
        raise AssertionError(f"group_walk_kernel spills: {walks}")

    # the cluster chunk kernels: no spills
    chunk_kernels = [w for name in ("cluster_pairs_kernel", "box_hits_kernel")
                     for w in ptxas_of(cluster.build(), name)]
    phase("cluster_ptxas", kernels=chunk_kernels)
    if len(chunk_kernels) != 2 or any(w["spill_store_bytes"] != 0
                                      for w in chunk_kernels):
        raise AssertionError(f"a cluster chunk kernel spills: "
                             f"{chunk_kernels}")

    rays = check_rays(sc, dev)
    group_vs_old(sc, rays, N_CHECK)
    group_vs_old(sc, check_rays(sc, dev, N_WIDE), N_WIDE)
    chunks = cluster_chunks(sc, rays)
    cluster_vs_old(chunks)
    checks = {**group_checks(sc, rays), **packet_checks(sc, sc16, rays),
              **cluster_checks(sc, chunks), **narrow_checks(sc, rays),
              **lanewalk_checks(sc, rays), **treelet_checks(sc, rays)}
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
    del sc_cpu

    frames = {"frame": frame(sc, dev, "frame", None, TIMED_FRAMES)}
    for title, (routing, timed) in ROUTES.items():
        frames[title] = frame(sc, dev, title, routing, timed,
                              main=frames["frame"])
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
    }
    kernels = []
    for name, (check, title) in source.items():
        c = checks[check]
        kernels.append(dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1],
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
