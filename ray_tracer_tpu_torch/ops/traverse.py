"""Scene traversal: sphere brute force, then a triangle route.

Port of ``ray_tracer_tpu/ops/traverse.py``'s routes (``traverse`` /
``traverse_anyhit`` with ``raw=True, need_uv=False``).  A forest
(non-flattened) scene takes :func:`_forest` under every ``Routing``, as
the JAX package's does (its packet mode is off there): one forest walk
(``packet.forest_traverse``) visits every instance's tree in turn in
object space.  A flattened scene's route is chosen per call from the
scene and the ``Routing``, in the JAX package's order:

* the rope walk (``kernels/lanewalk.py``) under ``lanewalk="force"``, for
  closest hit and occlusion, on a scene compiled with
  ``rope_streams=True`` (without them it raises);
* the cluster route (``ops/cluster_trace.py``) under ``cluster="on"`` on a
  scene compiled with cluster tables;
* under ``wide=False``, the narrow walk over the binary BVH
  (``packet.packet_traverse``), occlusion as its closest hit clipped at
  ``tmax``;
* under ``wide=True`` (the default), the group kernel
  (``kernels/group.py``): closest hit when ``groups > 0`` and not
  ``two_phase``, occlusion when ``anyhit_group`` too, on scenes with
  one-row (<= 8-record) leaf slots;
* under ``two_phase=True``, on a scene with treelets and a TOP table,
  two-phase treelet traversal (:func:`_two_phase_wide`: the TOP and DEEP
  modes of the packet walk), for closest hit and, ahead of the group
  kernel, occlusion;
* otherwise, still wide, the packet walk (``kernels/packet.py``), which
  also reads the 16-record two-row slots of ``merge_wide_leaves=True``
  scenes.

:func:`traverse_with_stats`, the debug heatmaps' closest hit, counts each
ray's box and triangle tests on a plain torch walk of the binary BVH
(the JAX package's counting gather walk, which is not a Pallas kernel
either).

Triangle hits come back in :func:`prim_space`: padded leaf-slot ids
(``shade_slot`` rows) on the group, two-phase and packet routes, global
triangle ids (``shade_tri`` rows) on the rope-walk, cluster and narrow
routes and on forest scenes.  On a flattened scene barycentrics and
facing are re-derived by the integrator's shade fetch, so the routes
return only ``(dst, prim)``; on a forest scene, whose rows are in object
space, the walk's own ``u``, ``v``, ``front`` and the instance ``obj``
come back in the :class:`Hit`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Routing
from ..kernels import group, lanewalk, packet
from ..kernels.bvh8 import MAX_TREE_DEPTH
from ..scene.types import CompiledScene
from . import cluster_trace, intersect
from .intersect import BIG

KIND_NONE = 0
KIND_SPHERE = 1
KIND_TRI = 2

# Two-phase traversal: the (ray, entry) pairs of a DEEP launch are sorted
# by entry and each entry's run is padded to a multiple of RUN lanes, so a
# packet of PACKET lanes (the JAX package's default packet) holds at most
# DEEP_E = PACKET // RUN distinct entries.
RUN = 128
PACKET = 2048
DEEP_E = PACKET // RUN
_SENT = 2**30  # sort key of a dead pair: after every node id


class Hit(NamedTuple):
    """Closest-hit record (SoA over the ray batch), the JAX package's
    fields.  ``obj``, ``u`` and ``v`` are set for triangle hits on forest
    scenes (and by the counting walk); the flattened scenes' routes leave
    them 0, since the shade rows carry the instance and the shade fetch
    re-derives the barycentrics."""

    dst: torch.Tensor  # (N,) f32, the initial bound when no hit
    kind: torch.Tensor  # (N,) i32: 0 none / 1 sphere / 2 triangle
    prim: torch.Tensor  # (N,) i32: sphere index, or triangle in prim_space
    obj: torch.Tensor  # (N,) i32: the triangle's instance (forest scenes)
    u: torch.Tensor  # (N,) f32 barycentrics (forest scenes)
    v: torch.Tensor
    front: torch.Tensor  # (N,) bool: facing (flattened triangles: 0)

    @property
    def did_hit(self):
        return self.kind != KIND_NONE


def _has_tris(scene: CompiledScene) -> bool:
    """Does the scene hold triangles?  Raises where its tallest tree is
    deeper than the walks' stacks hold."""
    if scene.n_objects == 0 or scene.meta.get("n_tris", 0) == 0:
        return False
    if scene.meta.get("bvh_max_depth", 0) > MAX_TREE_DEPTH:
        raise ValueError(
            f"BVH depth {scene.meta['bvh_max_depth']} exceeds the traversal "
            f"stack's {MAX_TREE_DEPTH}"
        )
    return True


def _flattened(scene: CompiledScene) -> bool:
    return scene.meta.get("flattened", False)


def _lanewalk_on(scene: CompiledScene, routing: Routing) -> bool:
    """Both queries through the rope walk?  ``lanewalk="force"`` asks for
    it on a flattened scene; one compiled without rope streams then
    raises."""
    if routing.lanewalk != "force" or not _flattened(scene):
        return False
    if not scene.meta.get("rope_rows", 0):
        raise ValueError(
            "Routing(lanewalk='force') needs the rope streams: compile the "
            "scene with compile(rope_streams=True)"
        )
    return True


def rope_error_flag(scene: CompiledScene, routing: Routing, device):
    """A cleared error flag for the rope walks of a run of traversals on
    the card (their ``rope_err``), or None where the route is not the rope
    walk or the device is the CPU (whose plain walk raises at once).  The
    caller reads it (``lanewalk.raise_on_flag``) with what it reads from
    the device anyway."""
    if torch.device(device).type != "cuda" or not _lanewalk_on(scene,
                                                                routing):
        return None
    return lanewalk.error_flag(device)


def _cluster_on(scene: CompiledScene, routing: Routing) -> bool:
    return cluster_trace.use_cluster(scene, routing)


def _group_on(scene: CompiledScene, routing: Routing) -> bool:
    """Closest hit through the group kernel?  It reads one-row (<= 8
    record) leaf slots only; the JAX package's TPU placement test has no
    counterpart here."""
    return (
        routing.wide
        and routing.groups > 0
        and not routing.two_phase
        and not _cluster_on(scene, routing)
        and scene.meta.get("wide_leaf_recs", 8) <= 8
    )


def _two_phase_ok(scene: CompiledScene, routing: Routing) -> bool:
    """Two-phase treelet traversal?  ``two_phase``, the wide route, a
    scene with treelets and a TOP table, as in the JAX package; its TPU
    conditions (the node table in VMEM, the SMEM meta mirror within
    600 kB) have no counterpart here.  A scene without treelets, or whose
    top level lies beyond the TOP walk's limits (an empty ``wide_top``),
    takes the packet walk."""
    return (
        routing.two_phase
        and routing.wide
        and scene.meta.get("n_treelets", 0) > 0
        and scene.wide_top.shape[0] > 0
    )


def prim_space(scene: CompiledScene, routing: Routing = None) -> str:
    """Which id space triangle hits come back in: ``'tri'`` (global
    triangle ids, ``scene.shade_tri``) on the rope-walk, cluster and narrow
    routes and on forest scenes, ``'slot'`` (padded leaf-slot ids,
    ``scene.shade_slot``) on the wide ones."""
    rt = routing if routing is not None else Routing.from_env()
    if (not _flattened(scene) or _lanewalk_on(scene, rt)
            or _cluster_on(scene, rt) or not rt.wide):
        return "tri"
    return "slot"


def _deep_round(scene, o, d, pair_entry, pair_ray, valid, tmax_ray,
                anyhit):
    """One DEEP launch over (ray, entry) pairs: ``(dst, prim, live)`` per
    pair, in pair order.

    The pairs are sorted by entry (stable; dead pairs last) and each run of
    one entry is padded to a multiple of RUN lanes, so every RUN-lane block
    of a PACKET-lane packet belongs to one entry and the packet's entry
    list is its blocks' first keys.  Each pair walks its packet's entries
    bounded by its ray's ``tmax_ray``; the padding lanes (``-BIG``)
    return at once (``packet_traverse_wide``).  The runs are found by
    binary search of every possible key (node ids, then the dead key) in
    the sorted keys, which needs no atomics; every size comes from the
    shapes and the scene's treelet count, so no value is read back to the
    host.
    """
    m = pair_entry.shape[0]
    dev = pair_entry.device
    n_keys = scene.wide_packed.shape[0] + 1
    # at most: the treelet roots, the root (overflow lanes) and dead pairs
    max_runs = scene.meta["n_treelets"] + 2
    key = torch.where(valid, pair_entry, _SENT)
    order = torch.argsort(key, stable=True)
    pe = key[order].contiguous()
    keys = torch.arange(n_keys, dtype=pe.dtype, device=dev)
    keys[-1] = _SENT
    first = torch.searchsorted(pe, keys)  # each key's run start
    lens = torch.diff(first, append=first.new_full((1,), m))
    padded = (lens + RUN - 1) // RUN * RUN
    offs = torch.cumsum(padded, 0) - padded
    kid = torch.where(pe >= _SENT, n_keys - 1, pe).long()
    dest = offs[kid] + torch.arange(m, device=dev) - first[kid]
    g2 = -(-(m + max_runs * RUN) // PACKET)
    m2 = g2 * PACKET  # the padded capacity
    pe_p = torch.full((m2,), _SENT, dtype=pe.dtype, device=dev)
    pe_p[dest] = pe
    ray_p = torch.zeros(m2, dtype=torch.int64, device=dev)
    ray_p[dest] = pair_ray[order]
    live_p = torch.zeros(m2, dtype=torch.bool, device=dev)
    live_p[dest] = valid[order]
    entries = pe_p.view(g2, DEEP_E, RUN)[:, :, 0]
    entries = torch.where(entries >= _SENT, -1, entries).to(torch.int32)
    tm_p = torch.where(live_p, tmax_ray[ray_p], -BIG).contiguous()
    dst, prim = packet.packet_traverse_wide(
        scene.wide_packed, scene.leaf_rows, o[ray_p].contiguous(),
        d[ray_p].contiguous(), tm_p, scene.meta.get("wide_leaf_recs", 8),
        anyhit=anyhit, deep_e=DEEP_E, entries=entries.contiguous(),
        packet_size=PACKET)
    at = torch.empty_like(dest)
    at[order] = dest  # each pair's lane
    return dst[at], prim[at], live_p[at]


def _two_phase_wide(scene, o, d, tmax0, rt, anyhit=False):
    """Two-phase treelet traversal (the JAX package's ``_two_phase_wide``):
    ``(dst, prim)`` as the packet walk returns them.

    A TOP walk from the root finds the closest top-level hit and each
    ray's treelet entries (lanes that overflow their ``top_k`` slots get
    the root as their one entry).  DEEP round 1 walks each ray's first
    entry bounded by the TOP best; round 2 its other entries, bounded by
    round 1's best.  Closest hit folds the K+1 results per ray with an
    argmin (phase A wins ties); occlusion ORs them into the ``-BIG``
    marker."""
    n = o.shape[0]
    k = rt.top_k
    dev = o.device
    dst_a, prim_a, slots, ovf = packet.packet_traverse_wide(
        scene.wide_packed, scene.leaf_rows, o, d, tmax0,
        scene.meta.get("wide_leaf_recs", 8), anyhit=anyhit, top_k=k,
        troot=scene.wide_troot, wide_top=scene.wide_top)
    root_only = torch.full((k,), -1, dtype=torch.int32, device=dev)
    root_only[0] = 0
    slots = torch.where((ovf > 0)[:, None], root_only, slots)
    lane_active = tmax0 > -1.0
    rays = torch.arange(n, device=dev)

    # round 1: each ray's first entry (the TOP walk emits near-first)
    v1 = (slots[:, 0] >= 0) & lane_active
    if anyhit:
        v1 = v1 & ~(dst_a < -1.0)
    d1, p1, l1 = _deep_round(scene, o, d, slots[:, 0], rays, v1, dst_a,
                             anyhit)
    if anyhit:
        best1 = torch.where((dst_a < -1.0) | ((d1 < -1.0) & l1), -BIG,
                            tmax0)
    else:
        best1 = torch.where((p1 >= 0) & l1 & (d1 < dst_a), d1, dst_a)

    # round 2: the other entries, bounded by round 1's best
    pair_entry = slots[:, 1:].T.reshape(-1)
    pair_ray = rays.repeat(k - 1)
    valid = (pair_entry >= 0) & lane_active[pair_ray]
    if anyhit:
        valid = valid & ~(best1[pair_ray] < -1.0)
    d2, p2, l2 = _deep_round(scene, o, d, pair_entry, pair_ray, valid,
                             best1, anyhit)
    d2, p2, l2 = (x.view(k - 1, n) for x in (d2, p2, l2))
    if anyhit:
        occ = (best1 < -1.0) | ((d2 < -1.0) & l2).any(dim=0)
        return torch.where(occ, -BIG, dst_a), prim_a

    # fold: phase A, round 1 and round 2, first index on ties
    dst_d = torch.cat([d1[None], d2])
    prim_d = torch.cat([p1[None], p2])
    dst_all = torch.cat([dst_a[None], torch.where(prim_d >= 0, dst_d, BIG)])
    prim_all = torch.cat([prim_a[None], prim_d])
    win = torch.argmin(dst_all, dim=0, keepdim=True)
    return dst_all.gather(0, win)[0], prim_all.gather(0, win)[0]


def _narrow(scene, o, d, tmax0):
    """The narrow walk over the binary BVH: ``(dst, prim)``; its root and
    root word come from the scene's ``meta`` (no read from the device)."""
    dst, prim, _, _, _ = packet.packet_traverse(
        scene.bvh_packed, scene.bvh_axis, scene.tri_packed, o, d, tmax0,
        scene.meta["bvh_root"], scene.meta["bvh_root_word"])
    return dst, prim


def _homogeneous(p, d):
    """Points ``p`` and directions ``d`` (N,3) stacked as (2N,4) rows
    ``p|1`` over ``d|0``, so that one product with an affine matrix
    transforms both (:func:`traverse_with_stats`' forest loop)."""
    n = p.shape[0]
    h = torch.zeros((2 * n, 4), dtype=p.dtype, device=p.device)
    h[:n, :3] = p
    h[:n, 3] = 1.0
    h[n:, :3] = d
    return h


def _forest(scene, origin, direction, tmax0, best=None):
    """The forest walk (the JAX package's per-instance scan, its
    ``traverse.py:603-627``): one ``packet.forest_traverse`` over every
    instance, in order, the rays taken to object space by
    ``obj_inv_transform[k]`` and walked from the instance's root, bounded
    by the best distance so far (``tmax0`` at first, -BIG on an inactive
    lane).  Where a lane improves on ``best`` (the sphere result,
    :func:`_sphere_hits`) it takes the walk's ``dst``, ``prim``, ``u``,
    ``v``, ``front`` and instance ``obj``.  With ``best`` None this is the
    occlusion query: a lane stops at its first instance hit and the result
    is the (N,) mask of lanes hit.  The roots, their words and the
    instances' world boxes are the scene's ``forest_roots`` and
    ``forest_cull``, built once from ``meta``: no value is read back from
    the device."""
    roots, words = scene.forest_roots
    args = (scene.bvh_packed, scene.bvh_axis, scene.tri_packed,
            scene.obj_inv_transform, roots, words, scene.forest_cull,
            origin.contiguous(), direction.contiguous(), tmax0.contiguous())
    if best is None:
        return packet.forest_traverse(*args, anyhit=True)
    t, t_prim, t_obj, t_u, t_v, t_front = packet.forest_traverse(*args)
    dst, kind, prim, obj, u, v, front = best
    tri = t_prim >= 0
    return Hit(
        dst=torch.where(tri, t, dst),
        kind=torch.where(tri, KIND_TRI, kind).to(torch.int32),
        prim=torch.where(tri, t_prim, prim),
        obj=torch.where(tri, t_obj, obj),
        u=torch.where(tri, t_u, u),
        v=torch.where(tri, t_v, v),
        front=torch.where(tri, t_front, front),
    )


def _sphere_dst(scene, origin, direction):
    s_dst, s_front, s_hit = intersect.intersect_spheres(
        origin, direction, scene.sphere_pos, scene.sphere_radius
    )
    return torch.where(s_hit, s_dst, BIG), s_front


def _sphere_hits(scene, origin, direction, active, tmax):
    """The closest sphere hit of each active ray inside ``tmax`` (default
    BIG) as a :class:`Hit`; ``dst`` is the bound where none is hit."""
    n = origin.shape[0]
    dev = origin.device
    dst = torch.full((n,), BIG, device=dev) if tmax is None else tmax
    kind = torch.zeros((n,), dtype=torch.int32, device=dev)
    prim = torch.zeros((n,), dtype=torch.int32, device=dev)
    front = torch.zeros((n,), dtype=torch.bool, device=dev)
    if scene.n_spheres > 0:
        s_dst, s_front = _sphere_dst(scene, origin, direction)
        si = torch.argmin(s_dst, dim=1, keepdim=True)  # first index on ties
        sd = torch.gather(s_dst, 1, si)[:, 0]
        sf = torch.gather(s_front, 1, si)[:, 0]
        better = active & (sd < dst)
        dst = torch.where(better, sd, dst)
        kind = torch.where(better, KIND_SPHERE, kind).to(torch.int32)
        prim = torch.where(better, si[:, 0].to(torch.int32), prim)
        front = torch.where(better, sf, front)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    return Hit(dst, kind, prim, torch.zeros_like(prim), zero, zero.clone(),
               front)


def traverse(
    scene: CompiledScene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    active: torch.Tensor,
    tmax: torch.Tensor = None,
    routing: Routing = None,
    rope_err: torch.Tensor = None,
    raw: bool = True,
) -> Hit:
    """Closest hit for a batch of world-space rays.

    ``active`` masks lanes (inactive lanes report no hit); ``tmax`` is an
    optional per-lane search radius (default BIG).  Triangle ``prim`` is in
    :func:`prim_space` of ``routing`` (default ``Routing.from_env()``); with
    ``raw=False`` it is always a global triangle id (a leaf slot is mapped
    through ``leaf_map``) and ``obj`` its instance, as the JAX package's
    ``raw=False`` returns them.  ``rope_err``: the rope walk's error flag
    (:func:`rope_error_flag`), which the caller reads; without it a
    malformed stream raises here.
    """
    rt = routing if routing is not None else Routing.from_env()
    best = _sphere_hits(scene, origin, direction, active, tmax)
    if not _has_tris(scene):
        return best
    dst, kind, prim, obj, u, v, front = best
    tmax0 = torch.where(active, dst, -BIG).contiguous()
    if not _flattened(scene):
        return _forest(scene, origin, direction, tmax0, best)
    o, d = origin.contiguous(), direction.contiguous()
    if _lanewalk_on(scene, rt):
        t_dst, t_prim = lanewalk.lanewalk_traverse(
            scene.rope_streams, scene.tri_packed, scene.meta["rope_rows"],
            o, d, tmax0, err=rope_err)
    elif _cluster_on(scene, rt):
        t_dst, t_prim = cluster_trace.cluster_traverse(
            scene, o, d, tmax0, rt)
    elif not rt.wide:
        t_dst, t_prim = _narrow(scene, o, d, tmax0)
    elif _group_on(scene, rt):
        t_dst, t_prim = group.group_traverse(
            scene.wide_packed, scene.leaf_rows, o, d, tmax0)
    elif _two_phase_ok(scene, rt):
        t_dst, t_prim = _two_phase_wide(scene, o, d, tmax0, rt)
    else:
        t_dst, t_prim = packet.packet_traverse_wide(
            scene.wide_packed, scene.leaf_rows, o, d, tmax0,
            scene.meta.get("wide_leaf_recs", 8))
    tri_hit = t_prim >= 0
    if not raw:
        if prim_space(scene, rt) == "slot":
            t_prim = torch.where(
                tri_hit, scene.leaf_map[torch.clamp(t_prim, min=0).long()],
                t_prim)
        obj = torch.where(tri_hit,
                          tri_owner(scene, torch.clamp(t_prim, min=0)), obj)
    return Hit(
        dst=torch.where(tri_hit, t_dst, dst),
        kind=torch.where(tri_hit, KIND_TRI, kind).to(torch.int32),
        prim=torch.where(tri_hit, t_prim, prim),
        obj=obj, u=u, v=v,
        front=front & ~tri_hit,
    )


def traverse_anyhit(
    scene: CompiledScene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    active: torch.Tensor,
    tmax: torch.Tensor,
    routing: Routing = None,
    rope_err: torch.Tensor = None,
) -> torch.Tensor:
    """Occlusion query: is there ANY hit strictly inside ``tmax``?

    Returns (N,) bool; inactive lanes report unoccluded.  The narrow route
    has no occlusion walk: its closest hit clipped at ``tmax`` (a closest
    hit inside ``tmax`` exists iff any hit does).  ``rope_err`` as in
    :func:`traverse`.
    """
    rt = routing if routing is not None else Routing.from_env()
    occ = torch.zeros((origin.shape[0],), dtype=torch.bool,
                      device=origin.device)
    if scene.n_spheres > 0:
        s_dst, _ = _sphere_dst(scene, origin, direction)
        occ = occ | (torch.min(s_dst, dim=1).values < tmax)
    if not _has_tris(scene):
        return occ & active
    tmax0 = torch.where(active, tmax, -BIG).contiguous()
    if not _flattened(scene):
        return (occ | _forest(scene, origin, direction, tmax0)) & active
    o, d = origin.contiguous(), direction.contiguous()
    if _lanewalk_on(scene, rt):
        dst, _ = lanewalk.lanewalk_traverse(
            scene.rope_streams, scene.tri_packed, scene.meta["rope_rows"],
            o, d, tmax0, anyhit=True, err=rope_err)
    elif _cluster_on(scene, rt):
        dst, _ = cluster_trace.cluster_traverse(scene, o, d, tmax0, rt,
                                                anyhit=True)
    elif not rt.wide:
        _, prim = _narrow(scene, o, d, tmax0)
        return (occ | (prim >= 0)) & active
    elif _two_phase_ok(scene, rt):
        dst, _ = _two_phase_wide(scene, o, d, tmax0, rt, anyhit=True)
    elif rt.anyhit_group and _group_on(scene, rt):
        dst, _ = group.group_traverse(
            scene.wide_packed, scene.leaf_rows, o, d, tmax0, anyhit=True)
    else:
        dst, _ = packet.packet_traverse_wide(
            scene.wide_packed, scene.leaf_rows, o, d, tmax0,
            scene.meta.get("wide_leaf_recs", 8), anyhit=True)
    return (occ | (dst < -1.0)) & active


_SENTINEL = 2**31 - 1  # the walk's end: no next node


def tri_owner(scene: CompiledScene, tri_id) -> torch.Tensor:
    """The owning instance of global triangles ``tri_id``: the i32 bits of
    ``tri_packed`` column 13."""
    return scene.tri_packed[tri_id.long(), 13].contiguous().view(torch.int32)


def traverse_with_stats(scene: CompiledScene, origin, direction, active,
                        tmax=None):
    """Closest hit plus ``(box_tests, tri_tests)`` per ray, (N,) f32 each.

    The debug heatmaps' traversal (the JAX package's
    ``traverse_with_stats``): spheres merge as in :func:`traverse` but are
    not counted (the reference's sphere loop counts nothing); triangles
    come from :func:`_walk_stats`, a plain torch walk of the binary BVH
    that counts every box and triangle test, on a forest scene once per
    instance in object space (the JAX package's scan).  Triangle ``prim``
    is a global triangle id (``prim_space`` ``'tri'``).
    """
    best = _sphere_hits(scene, origin, direction, active, tmax)
    # the walk updates these in place
    out = Hit(*(x.clone() for x in best))
    box = torch.zeros(origin.shape[:1], dtype=torch.float32,
                      device=origin.device)
    tri = torch.zeros_like(box)
    if not _has_tris(scene):
        return out, (box, tri)
    if _flattened(scene):
        _walk_stats(scene, origin, direction, active, out, box, tri,
                    scene.meta["obj_roots"][0])
        return out, (box, tri)
    n = origin.shape[0]
    h = _homogeneous(origin, direction)
    for k, root in enumerate(scene.meta["obj_roots"]):
        od = h @ scene.obj_inv_transform[k, :3].T
        _walk_stats(scene, od[:n], od[n:], active, out, box, tri, root,
                    obj_id=k)
    return out, (box, tri)


def _walk_stats(scene, o, d, active, out: Hit, box, tri, root: int,
                obj_id: int = None):
    """The stackless octant-threaded walk of one tree of the binary BVH
    (``bvh_packed`` rows, ``links_packed`` hit|miss links per octant) from
    node ``root``, counting per ray one box test per node visited and one
    triangle test per leaf record tested, as the JAX package's ``_walk``
    does.  Updates the closest-hit tensors of ``out`` and the counters in
    place.  A hit's ``obj`` is ``obj_id`` (a forest's instance), or with
    None the triangle's own (``tri_packed`` column 13).

    Each step works on the live lanes only: the walk gathers them into
    dense arrays and compacts those whenever half of them have finished,
    writing the finished lanes' results back; it tests only as many leaf
    records as the fullest leaf entered in that step holds.
    """
    n_nodes = scene.bvh_index.shape[0]
    max_steps = n_nodes + 1  # each node is visited at most once
    max_leaf = scene.meta.get("max_leaf_tris", 2)
    inv_dir = 1.0 / d
    octant = ((inv_dir[:, 0] < 0).to(torch.int64)
              + 2 * (inv_dir[:, 1] < 0).to(torch.int64)
              + 4 * (inv_dir[:, 2] < 0).to(torch.int64))
    lane = torch.nonzero(active).flatten()
    outs = dict(out._asdict(), box=box, tri=tri)
    st = dict(
        lane=lane, node=torch.full_like(lane, root), o=o[lane],
        d=d[lane], inv=inv_dir[lane], base=octant[lane] * n_nodes,
        **{k: x[lane] for k, x in outs.items()},
    )

    def write_back(keep):
        done = ~keep
        at = st["lane"][done]
        for k, out in outs.items():
            out[at] = st[k][done]

    steps = 0
    live = torch.ones_like(lane, dtype=torch.bool)
    while st["lane"].numel() and steps < max_steps:
        ni = torch.where(live, st["node"], 0)
        row = scene.bvh_packed[ni]
        idx = row[:, 6].contiguous().view(torch.int32).long()
        cnt = row[:, 7].contiguous().view(torch.int32).long()
        t_box = intersect.slab_test(st["o"], st["inv"], row[:, 0:3],
                                    row[:, 3:6])
        box_hit = live & (t_box < st["dst"])
        is_leaf = cnt > 0
        st["box"] = st["box"] + live.to(torch.float32)
        leaf_hit = box_hit & is_leaf
        # records to test this step: the most any lane's leaf holds (the
        # rest of the JAX walk's max_leaf_tris tests are masked no-ops)
        n_rec = min(max_leaf, int(torch.where(leaf_hit, cnt, 0).max()))
        for k in range(n_rec):
            valid = leaf_hit & (k < cnt)
            ti = torch.where(valid, idx + k, 0)
            trow = scene.tri_packed[ti]
            t, tu, tv, _, fr, hit = intersect.intersect_tris(
                st["o"], st["d"], trow[:, 0:3], trow[:, 3:6], trow[:, 6:9],
                trow[:, 9:12], trow[:, 12] > 0.5)
            closer = valid & hit & (t < st["dst"])
            owner = (trow[:, 13].contiguous().view(torch.int32)
                     if obj_id is None else obj_id)
            st["tri"] = st["tri"] + valid.to(torch.float32)
            st["dst"] = torch.where(closer, t, st["dst"])
            st["kind"] = torch.where(closer, KIND_TRI, st["kind"]).to(
                torch.int32)
            st["prim"] = torch.where(closer, ti.to(torch.int32), st["prim"])
            st["obj"] = torch.where(closer, owner, st["obj"]).to(torch.int32)
            st["u"] = torch.where(closer, tu, st["u"])
            st["v"] = torch.where(closer, tv, st["v"])
            st["front"] = torch.where(closer, fr, st["front"])
        links = scene.links_packed[st["base"] + ni]
        nxt = torch.where(box_hit & ~is_leaf, links[:, 0], links[:, 1])
        live = live & (nxt != _SENTINEL)
        st["node"] = nxt.long()
        steps += 1
        n_live = int(live.sum())
        if n_live == 0 or steps >= max_steps:
            break
        if 2 * n_live <= live.numel():
            write_back(live)
            st = {k: v[live] for k, v in st.items()}
            live = torch.ones_like(st["lane"], dtype=torch.bool)
    write_back(torch.zeros_like(live))
