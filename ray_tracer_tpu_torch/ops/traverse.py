"""Scene traversal: sphere brute force, then a triangle route.

Port of ``ray_tracer_tpu/ops/traverse.py``'s flattened-scene routes
(``traverse`` / ``traverse_anyhit`` with ``raw=True, need_uv=False``),
chosen per call from the scene and the ``Routing``, in the JAX package's
order:

* the rope walk (``kernels/lanewalk.py``) under ``lanewalk="force"``, for
  closest hit and occlusion, on a scene compiled with
  ``rope_streams=True`` (without them it raises);
* the cluster route (``ops/cluster_trace.py``) under ``cluster="on"`` on a
  scene compiled with cluster tables;
* under ``wide=True`` (the default), the group kernel
  (``kernels/group.py``): closest hit when ``groups > 0``, occlusion when
  ``anyhit_group`` too, on scenes with one-row (<= 8-record) leaf slots;
* otherwise, still wide, the packet walk (``kernels/packet.py``), which
  also reads the 16-record two-row slots of ``merge_wide_leaves=True``
  scenes;
* under ``wide=False``, the narrow walk over the binary BVH
  (``packet.packet_traverse``), occlusion as its closest hit clipped at
  ``tmax``.

Triangle hits come back in :func:`prim_space`: padded leaf-slot ids
(``shade_slot`` rows) on the group and packet routes, global triangle ids
(``shade_tri`` rows) on the rope-walk, cluster and narrow routes.
Barycentrics and facing are re-derived by the integrator's shade fetch, so
the routes return only ``(dst, prim)``.  Forest (non-flattened) mesh
scenes are not ported.
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


class Hit(NamedTuple):
    """Closest-hit record (SoA over the ray batch)."""

    dst: torch.Tensor  # (N,) f32, the initial bound when no hit
    kind: torch.Tensor  # (N,) i32: 0 none / 1 sphere / 2 triangle
    prim: torch.Tensor  # (N,) i32: sphere index, or padded leaf slot
    front: torch.Tensor  # (N,) bool: sphere facing (triangles: re-derived)

    @property
    def did_hit(self):
        return self.kind != KIND_NONE


def _has_tris(scene: CompiledScene) -> bool:
    if scene.n_objects == 0 or scene.meta.get("n_tris", 0) == 0:
        return False
    if not scene.meta.get("flattened", False):
        raise NotImplementedError(
            "forest (non-flattened) scenes are not ported yet "
            "(ROADMAP Queue A item 5)"
        )
    if scene.meta.get("bvh_max_depth", 0) > MAX_TREE_DEPTH:
        raise ValueError(
            f"BVH depth {scene.meta['bvh_max_depth']} exceeds the traversal "
            f"stack's {MAX_TREE_DEPTH}"
        )
    return True


def _lanewalk_on(scene: CompiledScene, routing: Routing) -> bool:
    """Both queries through the rope walk?  ``lanewalk="force"`` asks for
    it; a scene compiled without rope streams then raises."""
    if routing.lanewalk != "force":
        return False
    if not scene.meta.get("rope_rows", 0):
        raise ValueError(
            "Routing(lanewalk='force') needs the rope streams: compile the "
            "scene with compile(rope_streams=True)"
        )
    return True


def _cluster_on(scene: CompiledScene, routing: Routing) -> bool:
    return cluster_trace.use_cluster(scene, routing)


def _group_on(scene: CompiledScene, routing: Routing) -> bool:
    """Closest hit through the group kernel?  It reads one-row (<= 8
    record) leaf slots only; the JAX package's TPU placement test has no
    counterpart here."""
    return (
        routing.wide
        and routing.groups > 0
        and not _cluster_on(scene, routing)
        and scene.meta.get("wide_leaf_recs", 8) <= 8
    )


def prim_space(scene: CompiledScene, routing: Routing = None) -> str:
    """Which id space triangle hits come back in: ``'tri'`` (global
    triangle ids, ``scene.shade_tri``) on the rope-walk, cluster and narrow
    routes, ``'slot'`` (padded leaf-slot ids, ``scene.shade_slot``) on the
    wide ones."""
    rt = routing if routing is not None else Routing()
    if _lanewalk_on(scene, rt) or _cluster_on(scene, rt) or not rt.wide:
        return "tri"
    return "slot"


def _narrow(scene, o, d, tmax0):
    """The narrow walk over the binary BVH: ``(dst, prim)``."""
    dst, prim, _, _, _ = packet.packet_traverse(
        scene.bvh_packed, scene.bvh_axis, scene.tri_packed, o, d, tmax0,
        int(scene.obj_bvh_root[0]))
    return dst, prim


def _sphere_dst(scene, origin, direction):
    s_dst, s_front, s_hit = intersect.intersect_spheres(
        origin, direction, scene.sphere_pos, scene.sphere_radius
    )
    return torch.where(s_hit, s_dst, BIG), s_front


def traverse(
    scene: CompiledScene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    active: torch.Tensor,
    tmax: torch.Tensor = None,
    routing: Routing = None,
) -> Hit:
    """Closest hit for a batch of world-space rays.

    ``active`` masks lanes (inactive lanes report no hit); ``tmax`` is an
    optional per-lane search radius (default BIG).  Triangle ``prim`` is in
    :func:`prim_space` of ``routing`` (default ``Routing()``).
    """
    rt = routing if routing is not None else Routing()
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

    if not _has_tris(scene):
        return Hit(dst, kind, prim, front)

    tmax0 = torch.where(active, dst, -BIG).contiguous()
    o, d = origin.contiguous(), direction.contiguous()
    if _lanewalk_on(scene, rt):
        t_dst, t_prim = lanewalk.lanewalk_traverse(
            scene.rope_streams, scene.meta["rope_rows"], o, d, tmax0)
    elif _cluster_on(scene, rt):
        t_dst, t_prim = cluster_trace.cluster_traverse(
            scene, o, d, tmax0, rt)
    elif not rt.wide:
        t_dst, t_prim = _narrow(scene, o, d, tmax0)
    elif _group_on(scene, rt):
        t_dst, t_prim = group.group_traverse(
            scene.wide_packed, scene.leaf_rows, o, d, tmax0)
    else:
        t_dst, t_prim = packet.packet_traverse_wide(
            scene.wide_packed, scene.leaf_rows, o, d, tmax0,
            scene.meta.get("wide_leaf_recs", 8))
    tri_hit = t_prim >= 0
    return Hit(
        dst=torch.where(tri_hit, t_dst, dst),
        kind=torch.where(tri_hit, KIND_TRI, kind).to(torch.int32),
        prim=torch.where(tri_hit, t_prim, prim),
        front=front & ~tri_hit,
    )


def traverse_anyhit(
    scene: CompiledScene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    active: torch.Tensor,
    tmax: torch.Tensor,
    routing: Routing = None,
) -> torch.Tensor:
    """Occlusion query: is there ANY hit strictly inside ``tmax``?

    Returns (N,) bool; inactive lanes report unoccluded.  The narrow route
    has no occlusion walk: its closest hit clipped at ``tmax`` (a closest
    hit inside ``tmax`` exists iff any hit does).
    """
    rt = routing if routing is not None else Routing()
    occ = torch.zeros((origin.shape[0],), dtype=torch.bool,
                      device=origin.device)
    if scene.n_spheres > 0:
        s_dst, _ = _sphere_dst(scene, origin, direction)
        occ = occ | (torch.min(s_dst, dim=1).values < tmax)
    if not _has_tris(scene):
        return occ & active
    tmax0 = torch.where(active, tmax, -BIG).contiguous()
    o, d = origin.contiguous(), direction.contiguous()
    if _lanewalk_on(scene, rt):
        dst, _ = lanewalk.lanewalk_traverse(
            scene.rope_streams, scene.meta["rope_rows"], o, d, tmax0,
            anyhit=True)
    elif _cluster_on(scene, rt):
        dst, _ = cluster_trace.cluster_traverse(scene, o, d, tmax0, rt,
                                                anyhit=True)
    elif not rt.wide:
        _, prim = _narrow(scene, o, d, tmax0)
        return (occ | (prim >= 0)) & active
    elif rt.anyhit_group and _group_on(scene, rt):
        dst, _ = group.group_traverse(
            scene.wide_packed, scene.leaf_rows, o, d, tmax0, anyhit=True)
    else:
        dst, _ = packet.packet_traverse_wide(
            scene.wide_packed, scene.leaf_rows, o, d, tmax0,
            scene.meta.get("wide_leaf_recs", 8), anyhit=True)
    return (occ | (dst < -1.0)) & active
