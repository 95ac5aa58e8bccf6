"""Packet traversal: the BVH8 walk with its cluster enumeration and its
treelet modes, and the narrow binary-BVH walk.  CUDA kernels and their
plain torch twins.

``packet_traverse_wide`` is the port of ``ray_tracer_tpu/kernels/
packet.py``'s ``_packet8_kernel`` in all its modes: the closest-hit and
occlusion walks over one-row (8-record) or two-row (16-record) leaf
slots, the ``emit_leaves`` enumeration of candidate clusters, and the
TOP (``top_k`` + ``troot``) and DEEP (``deep_e`` + ``entries``) phases
of two-phase treelet traversal.  On CUDA tensors it launches the walk in
``csrc/bvh8_walk.cu`` (built with ``nvcc`` at first use, one library with
``kernels/group.py``): ``group_walk_kernel`` for the closest-hit and
occlusion walks from the root (the main path's kernel, here over one- or
two-row slots), ``deep_walk_kernel`` for the DEEP start,
``emit_walk_kernel`` for the emit mode, ``top_walk_kernel`` for the TOP
start (over the scene's TOP table, ``wide_top``); on CPU tensors it runs
:func:`packet_traverse_wide_reference`.

``packet_traverse`` is the port of ``_packet_kernel``, the narrow route's
closest-hit walk over the binary BVH (``bvh_packed``, ``tri_packed``): on
CUDA tensors ``csrc/bvh2_walk.cu``, on CPU tensors
:func:`packet_traverse_reference`.  The kernel carries each node as a
32-bit word (:func:`narrow_root_word`); the scene's compile stores the
root's word in ``meta``.  Nothing falls back: a CUDA tensor
that a kernel cannot take raises.

Each kernel and its twin walk one ray per thread alike and round alike,
so on the card they agree bit for bit.  Against the TPU kernels, whose
packets walk in lockstep with the packet-majority child order, only the
visit order differs: it can change ``prim`` (never ``dst``) on exact-t
ties, and the ORDER of the emitted slots, never their set or count.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from ..native_build import build_shared, nvcc_path
from .bvh8 import (
    BIG,
    CSRC,
    MAX_TREE_DEPTH,
    NVCC_FLAGS,
    check_start_inputs,
    check_tensors,
    check_top_table,
    check_walk_inputs,
    launch_deep,
    launch_emit,
    launch_group,
    launch_top,
    mt_test,
    walk_reference,
)

# Kernel launches per mode since the last reset (the CPU path never adds).
launches = {"packet8_wide": 0, "packet8_anyhit": 0, "packet8_emit": 0,
            "packet8_top": 0, "packet8_top_anyhit": 0, "packet8_deep": 0,
            "packet8_deep_anyhit": 0, "packet_narrow": 0, "forest_walk": 0,
            "forest_anyhit": 0}

N_STACK = MAX_TREE_DEPTH + 32  # the narrow walk's stack (bvh2_walk.cu)
# The narrow kernel's node word: first << NARROW_TAG_BITS | tag, tag = a
# leaf's triangle count (1..NARROW_INTERIOR - 1) or NARROW_INTERIOR + an
# interior node's split axis (0..2).
NARROW_TAG_BITS = 5
NARROW_INTERIOR = 29
NARROW_MAX_FIRST = 2 ** (32 - NARROW_TAG_BITS) - 1
_NARROW_SRC = os.path.join(CSRC, "bvh2_walk.cu")
_narrow_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _rows(max_recs: int) -> int:
    """Leaf rows per slot: two for 16-record (merged two-row) scenes."""
    if max_recs not in (4, 8, 16):
        raise ValueError(f"max_recs must be 4, 8 or 16, got {max_recs}")
    return 2 if max_recs > 8 else 1


def packet_traverse_wide(nodes, leaf_rows, origin, direction, tmax0,
                         max_recs: int, anyhit: bool = False, top_k: int = 0,
                         emit_leaves: bool = False, troot=None,
                         deep_e: int = 0, entries=None,
                         packet_size: int = 0, wide_top=None):
    """The packet walk of N rays over a BVH8.

    Walk (the default): returns ``(dst, prim)`` — ``dst`` the closest
    accepted t (``tmax0`` on a miss), or under ``anyhit`` ``-BIG`` where a
    hit lies inside ``tmax0``; ``prim`` the padded leaf-slot id
    ``slot * 8 + record`` (map through ``leaf_map``), -1 on a miss and
    under ``anyhit``.  ``max_recs`` is the scene's ``wide_leaf_recs``: 16
    reads two-row slots.

    Emit (``top_k > 0, emit_leaves=True``; ``nodes`` the cluster BVH8,
    ``leaf_rows`` never read): returns ``(slots, ovf)``, (N,top_k) i32
    cluster ids (-1 padded) whose box the ray enters within ``tmax0``, in
    visit order, and (N,) i32 overflow flags (more than ``top_k``).

    TOP (``top_k > 0`` + ``troot`` (W,) i32, the scene's ``wide_troot``):
    the walk from the root that does not descend into treelet roots and
    emits the node ids of those it enters instead -> ``(dst, prim, slots,
    ovf)``: the closest top-level hit, and the entries and overflow flags
    as in the emit mode.  On the card the kernel walks the scene's TOP
    table, ``wide_top`` (T,64) f32 (``compile()`` builds it); a CUDA call
    without it raises.  On the CPU the plain walk takes ``troot`` (a
    ``wide_top`` given is checked all the same).

    DEEP (``deep_e > 0`` + ``entries`` (G,deep_e) i32, -1 padded, with
    N = G * ``packet_size``): each lane of packet g walks the subtrees of
    the entries ``entries[g]`` instead of the tree from the root ->
    ``(dst, prim)``, the closest hit (or occlusion) in their union, the
    subtrees walked one after the other, the last listed first.  Lanes
    with ``tmax0 <= 0`` (the route's padding) return ``tmax0`` and -1.
    """
    check_walk_inputs(nodes, leaf_rows, origin, direction, tmax0)
    rows = _rows(max_recs)
    if emit_leaves:
        if top_k < 1 or anyhit or troot is not None or deep_e:
            raise ValueError("emit_leaves needs top_k >= 1, anyhit=False "
                             "and no treelet inputs")
    elif (top_k > 0) != (troot is not None):
        raise ValueError("the TOP mode needs top_k >= 1 and the treelet-root "
                         "table troot together")
    if (deep_e > 0) != (entries is not None):
        raise ValueError("the DEEP mode needs deep_e and entries together")
    if entries is not None and entries.dim() == 2 \
            and entries.shape[1] != deep_e:
        raise ValueError(f"entries hold {entries.shape[1]} per packet, "
                         f"deep_e is {deep_e}")
    check_start_inputs(nodes, origin, troot, entries, packet_size)
    dev = origin.device
    if wide_top is not None and troot is None:
        raise ValueError("wide_top is the TOP mode's table: it needs troot "
                         "and top_k")
    if troot is not None and (wide_top is not None or dev.type == "cuda"):
        check_top_table(wide_top, nodes, dev)
    kw = dict(anyhit=anyhit, top_k=top_k, emit_leaves=emit_leaves,
              troot=troot, entries=entries, packet_size=packet_size)
    if dev.type == "cpu":
        return packet_traverse_wide_reference(
            nodes, leaf_rows, origin, direction, tmax0, max_recs, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no traversal kernel for device {dev}")
    if entries is not None:
        out = launch_deep(nodes, leaf_rows, entries, origin, direction,
                          tmax0, anyhit, rows, packet_size)
    elif emit_leaves:
        out = launch_emit(nodes, origin, direction, tmax0, top_k)
    elif troot is None:
        out = launch_group(nodes, leaf_rows, origin, direction, tmax0,
                           anyhit, rows)
    else:
        out = launch_top(wide_top, leaf_rows, origin, direction, tmax0,
                         anyhit, rows, top_k)
    if emit_leaves:
        mode = "packet8_emit"
    elif troot is not None or entries is not None:
        mode = ("packet8_top" if troot is not None else "packet8_deep") + (
            "_anyhit" if anyhit else "")
    else:
        mode = "packet8_anyhit" if anyhit else "packet8_wide"
    if origin.shape[0]:
        launches[mode] += 1
    return out


def packet_traverse_wide_reference(nodes, leaf_rows, origin, direction,
                                   tmax0, max_recs: int,
                                   anyhit: bool = False, top_k: int = 0,
                                   emit_leaves: bool = False, troot=None,
                                   entries=None, packet_size: int = 0,
                                   stats: dict = None):
    """The kernel's walk in plain torch (``bvh8.walk_reference``)."""
    mode = "emit" if emit_leaves else ("anyhit" if anyhit else "closest")
    return walk_reference(nodes, leaf_rows, origin, direction, tmax0,
                          mode=mode, rows=_rows(max_recs), top_k=top_k,
                          troot=troot, entries=entries,
                          packet_size=packet_size, stats=stats)


def reconstruct_uvfront(leaf_rows, origin, direction, prim):
    """Barycentrics and facing of each ray's winning record, outside the
    kernel: ``_reconstruct_uvfront`` of the JAX package.  ``prim`` is a
    padded slot id, row ``prim`` of the (L*8,16) record view; the same
    formulas and zero-direction guard as the kernel's test."""
    check_tensors(origin.device, torch.int32, prim=(prim, (origin.shape[0],)))
    rec = leaf_rows.reshape(-1, 16)[prim.clamp(min=0).long()]
    return _uvfront(rec, origin, direction, prim)


def _uvfront(rec, origin, direction, prim):
    d = torch.where(direction == 0.0, 1e-20, direction)
    r = origin - rec[:, 0:3]
    q = torch.linalg.cross(r, d)
    d0 = -(d * rec[:, 9:12]).sum(dim=1)
    dinv = 1.0 / d0
    u = (rec[:, 6:9] * q).sum(dim=1) * dinv
    v = -(rec[:, 3:6] * q).sum(dim=1) * dinv
    miss = prim < 0
    return (torch.where(miss, 0.0, u), torch.where(miss, 0.0, v),
            ~miss & (d0 >= 1e-8))



def build_narrow() -> str:
    """Compile the narrow walk library (once per source hash); its path."""
    return build_shared(_NARROW_SRC, "bvh2_walk", (nvcc_path(), *NVCC_FLAGS))


def _load_narrow() -> ctypes.CDLL:
    global _narrow_lib
    if _narrow_lib is None:
        lib = ctypes.CDLL(build_narrow())
        lib.rt_bvh2_walk.restype = ctypes.c_int
        lib.rt_bvh2_walk.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_uint]
            + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.rt_forest_walk.restype = ctypes.c_int
        lib.rt_forest_walk.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_void_p]
        )
        _narrow_lib = lib
    return _narrow_lib


def narrow_root_words(bvh_packed, bvh_axis, roots) -> list:
    """The narrow kernel's words of nodes ``roots`` of the binary BVH
    (``bvh_packed`` (B,8) f32 min3|max3|first|count, ``bvh_axis`` (B,)
    i32; numpy arrays or CPU tensors): ``first << 5 | tag``, tag the
    leaf's triangle count or ``NARROW_INTERIOR`` + the split axis.  Every
    node's word is built from its table row the same way, so first the
    whole table is checked against the word's limits (first at most
    ``NARROW_MAX_FIRST``, leaf counts below ``NARROW_INTERIOR``, interior
    axes 0..2): every word is -1 where a node lies beyond them, and the
    narrow walk then refuses the scene."""
    ints = np.ascontiguousarray(np.asarray(bvh_packed, np.float32))
    ints = ints.view(np.int32).astype(np.int64)
    first, count = ints[:, 6], ints[:, 7]
    axis = np.asarray(bvh_axis).astype(np.int64)
    leaf = count > 0
    roots = [int(r) for r in roots]
    for root in roots:
        if not 0 <= root < ints.shape[0]:
            raise ValueError(f"root {root} is not a node of the BVH")
    if (first.min() < 0 or first.max() > NARROW_MAX_FIRST
            or count.min() < 0 or count.max() >= NARROW_INTERIOR
            or not np.isin(axis[~leaf], (0, 1, 2)).all()):
        return [-1] * len(roots)
    return [int(first[r] << NARROW_TAG_BITS
                | (count[r] if leaf[r] else NARROW_INTERIOR + axis[r]))
            for r in roots]


def narrow_root_word(bvh_packed, bvh_axis, root: int) -> int:
    """The narrow kernel's word of node ``root``
    (:func:`narrow_root_words`)."""
    return narrow_root_words(bvh_packed, bvh_axis, [root])[0]


def packet_traverse(bvh_packed, bvh_axis, tri_packed, origin, direction,
                    tmax0, root: int, root_word: int):
    """The narrow route's closest-hit walk of N rays over the binary BVH
    -> ``(dst, prim, u, v, front)``, each (N,).

    ``bvh_packed`` (B,8) f32 min3|max3|first|count (int32 bitcasts),
    ``bvh_axis`` (B,) i32 split axes, ``tri_packed`` (T,16) f32
    v0|e1|e2|n|front_only rows, ``root`` the root node and ``root_word``
    its :func:`narrow_root_word` (``CompiledScene.meta["bvh_root"]`` and
    ``["bvh_root_word"]``; -1, a table beyond the word's limits, raises
    ``ValueError``; on CPU tensors the word is checked against the
    tables).  ``dst``: the closest accepted t (``tmax0`` on a miss;
    ``tmax0 = -BIG`` disables a lane); ``prim``: its global triangle id,
    -1 on a miss; ``u``, ``v``: its barycentrics (0 on a miss); ``front``:
    whether it faces the ray.
    """
    n = origin.shape[0]
    dev = origin.device
    check_tensors(
        dev, torch.float32,
        bvh_packed=(bvh_packed, (bvh_packed.shape[0], 8)),
        tri_packed=(tri_packed, (tri_packed.shape[0], 16)),
        origin=(origin, (n, 3)), direction=(direction, (n, 3)),
        tmax0=(tmax0, (n,)),
    )
    check_tensors(dev, torch.int32,
                  bvh_axis=(bvh_axis, (bvh_packed.shape[0],)))
    if not 0 <= root < bvh_packed.shape[0]:
        raise ValueError(f"root {root} is not a node of the BVH")
    if n >= 2**31 or tri_packed.shape[0] >= 2**31 // 16:
        raise ValueError("too many rays or triangles for 32-bit indices")
    if root_word < 0:
        raise ValueError(
            "the BVH lies beyond the narrow walk's node word: leaf counts "
            f"up to {NARROW_INTERIOR - 1}, first indices up to "
            f"{NARROW_MAX_FIRST}, split axes 0..2")
    if dev.type == "cpu":
        want = narrow_root_word(bvh_packed, bvh_axis, root)
        if root_word != want:
            raise ValueError(f"root_word {root_word} is not node {root}'s "
                             f"word {want}")
        return packet_traverse_reference(bvh_packed, bvh_axis, tri_packed,
                                         origin, direction, tmax0, root)
    if dev.type != "cuda":
        raise ValueError(f"no traversal kernel for device {dev}")
    if any(t.data_ptr() % 16 for t in (bvh_packed, tri_packed)):
        raise ValueError("bvh_packed and tri_packed must be 16-byte aligned")
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    front = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        err = _load_narrow().rt_bvh2_walk(
            bvh_packed.data_ptr(), bvh_axis.data_ptr(), tri_packed.data_ptr(),
            origin.data_ptr(), direction.data_ptr(), tmax0.data_ptr(), root,
            root_word, dst.data_ptr(), prim.data_ptr(), u.data_ptr(),
            v.data_ptr(), front.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"narrow walk kernel launch failed: CUDA "
                               f"error {err}")
        launches["packet_narrow"] += 1
    return dst, prim, u, v, front


def object_ray(m, origin, direction):
    """Rays (N,3) taken to object space by the affine (4,4) ``m``, each
    component elementwise in a fixed order: ``((m00*x + m01*y) + m02*z) +
    m03`` for the origin, ``(m00*dx + m01*dy) + m02*dz`` for the
    direction (the JAX package's ``_transform_point`` and
    ``_transform_dir``), as ``forest_walk_kernel`` rounds them."""
    x, y, z = origin.unbind(1)
    dx, dy, dz = direction.unbind(1)
    o = torch.stack([((m[r, 0] * x + m[r, 1] * y) + m[r, 2] * z) + m[r, 3]
                     for r in range(3)], dim=1)
    d = torch.stack([(m[r, 0] * dx + m[r, 1] * dy) + m[r, 2] * dz
                     for r in range(3)], dim=1)
    return o, d


def forest_traverse(bvh_packed, bvh_axis, tri_packed, inv_transform, roots,
                    words, origin, direction, tmax0, anyhit: bool = False):
    """Every instance of a forest in one walk of N rays: ``(dst, prim,
    obj, u, v, front)``, each (N,), or under ``anyhit`` the (N,) bool mask
    of rays that hit an instance within ``tmax0``.

    ``bvh_packed``, ``bvh_axis`` and ``tri_packed`` as for
    :func:`packet_traverse`; ``inv_transform`` (K,4,4) f32, the instances'
    world-to-object transforms; ``roots`` (K,) i32, their roots in
    ``bvh_packed``, and ``words`` (K,) i32, the bits of those roots'
    :func:`narrow_root_words` (``CompiledScene.forest_roots`` builds both
    once from ``meta["obj_roots"]`` and ``["obj_root_words"]``; on CPU
    tensors they are checked against the tables).  The instances are
    walked in order, each ray taken to object space by :func:`object_ray`
    and bounded by its best t so far (``tmax0`` at first; -BIG disables a
    lane): a later instance replaces an earlier one only at a strictly
    smaller t.  ``dst``: the closest accepted t (``tmax0`` on a miss);
    ``prim``: its global triangle id and ``obj`` its instance (-1 on a
    miss); ``u``, ``v``: its barycentrics (0 on a miss); ``front``:
    whether it faces the ray.  Under ``anyhit`` a ray stops at the first
    instance it hits.  On CUDA tensors one launch of
    ``forest_walk_kernel``; on CPU tensors
    :func:`forest_traverse_reference`."""
    n = origin.shape[0]
    k = inv_transform.shape[0]
    dev = origin.device
    check_tensors(
        dev, torch.float32,
        bvh_packed=(bvh_packed, (bvh_packed.shape[0], 8)),
        tri_packed=(tri_packed, (tri_packed.shape[0], 16)),
        inv_transform=(inv_transform, (k, 4, 4)),
        origin=(origin, (n, 3)), direction=(direction, (n, 3)),
        tmax0=(tmax0, (n,)),
    )
    check_tensors(dev, torch.int32,
                  bvh_axis=(bvh_axis, (bvh_packed.shape[0],)),
                  roots=(roots, (k,)), words=(words, (k,)))
    if n >= 2**31 or tri_packed.shape[0] >= 2**31 // 16:
        raise ValueError("too many rays or triangles for 32-bit indices")
    if dev.type == "cpu":
        want = narrow_root_words(bvh_packed, bvh_axis, roots.tolist())
        got = [w & 0xFFFFFFFF for w in words.tolist()]
        if -1 in want or got != want:
            raise ValueError(f"words {got} are not the roots' narrow-walk "
                             f"words {want}")
        return forest_traverse_reference(
            bvh_packed, bvh_axis, tri_packed, inv_transform, roots.tolist(),
            origin, direction, tmax0, anyhit=anyhit)
    if dev.type != "cuda":
        raise ValueError(f"no traversal kernel for device {dev}")
    if any(t.data_ptr() % 16 for t in (bvh_packed, tri_packed,
                                       inv_transform)):
        raise ValueError("bvh_packed, tri_packed and inv_transform must be "
                         "16-byte aligned")
    f32 = lambda: torch.empty(n, dtype=torch.float32, device=dev)
    i32 = lambda: torch.empty(n, dtype=torch.int32, device=dev)
    b8 = lambda: torch.empty(n, dtype=torch.bool, device=dev)
    if anyhit:
        out = (b8(),)
        ptrs = [None] * 6 + [out[0].data_ptr()]
    else:
        out = (f32(), i32(), i32(), f32(), f32(), b8())
        ptrs = [t.data_ptr() for t in out] + [None]
    if n:
        err = _load_narrow().rt_forest_walk(
            bvh_packed.data_ptr(), bvh_axis.data_ptr(), tri_packed.data_ptr(),
            inv_transform.data_ptr(), roots.data_ptr(), words.data_ptr(), k,
            origin.data_ptr(), direction.data_ptr(), tmax0.data_ptr(),
            int(anyhit), *ptrs, n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"forest walk kernel launch failed: CUDA "
                               f"error {err}")
        launches["forest_anyhit" if anyhit else "forest_walk"] += 1
    return out[0] if anyhit else out


def forest_traverse_reference(bvh_packed, bvh_axis, tri_packed,
                              inv_transform, roots, origin, direction, tmax0,
                              anyhit: bool = False, stats: dict = None):
    """The forest walk in plain torch: for each instance k in order, the
    rays taken to object space by :func:`object_ray` of
    ``inv_transform[k]`` and walked from node ``roots[k]`` by
    :func:`packet_traverse_reference`, bounded by the best t so far; where
    a lane hits, it keeps the walk's ``dst``, ``prim``, ``u``, ``v``,
    ``front`` and ``obj = k`` (closest hit), or its bound falls to -BIG,
    so that it enters no later instance (``anyhit``, which returns the
    (N,) mask of lanes hit).  ``roots``: host ints.  ``stats``, if given,
    receives the narrow walk's counts summed over the instances
    (``boxes``, ``tris``; ``node_seen``, ``tri_seen`` or-ed) and
    ``scans``, the (ray, instance) pairs whose ray was taken to object
    space (the lane's bound above 0, as the kernel skips the others)."""
    dev = origin.device
    n = origin.shape[0]
    t = tmax0.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    obj = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    hit_any = torch.zeros(n, dtype=torch.bool, device=dev)
    if stats is not None:
        stats.update(
            boxes=0, tris=0, scans=0,
            node_seen=torch.zeros(bvh_packed.shape[0], dtype=torch.bool,
                                  device=dev),
            tri_seen=torch.zeros(tri_packed.shape[0], dtype=torch.bool,
                                 device=dev))
    for k, root in enumerate(roots):
        one = None if stats is None else {}
        if stats is not None:
            stats["scans"] += int((t > 0).sum())
        o_k, d_k = object_ray(inv_transform[k], origin, direction)
        t_k, p_k, u_k, v_k, f_k = packet_traverse_reference(
            bvh_packed, bvh_axis, tri_packed, o_k, d_k, t, int(root),
            stats=one)
        if stats is not None:
            stats["boxes"] += one["boxes"]
            stats["tris"] += one["tris"]
            stats["node_seen"] |= one["node_seen"]
            stats["tri_seen"] |= one["tri_seen"]
        hit = p_k >= 0
        if anyhit:
            hit_any = hit_any | hit
            t = torch.where(hit, -BIG, t_k)
            continue
        t = t_k
        prim = torch.where(hit, p_k, prim)
        obj = torch.where(hit, k, obj).to(torch.int32)
        u = torch.where(hit, u_k, u)
        v = torch.where(hit, v_k, v)
        front = torch.where(hit, f_k, front)
    if anyhit:
        return hit_any
    return t, prim, obj, u, v, front


def _entry(box, origin, inv):
    """Entry distance of each lane into its (K,6) box, BIG on a miss: the
    TPU kernel's ``slab`` (``packet.py:88-106``)."""
    t1 = (box[:, 0:3] - origin) * inv
    t2 = (box[:, 3:6] - origin) * inv
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tmx = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    hit = (tmx >= tmin) & (tmx > 0)
    return torch.where(hit, tmin.clamp(min=0.0), BIG)


def packet_traverse_reference(bvh_packed, bvh_axis, tri_packed, origin,
                              direction, tmax0, root: int,
                              stats: dict = None):
    """The CUDA narrow walk in plain torch, one pop of every live lane per
    iteration.  Raises if a lane overflows its stack or needs more than
    B + 1 steps (a node is pushed at most once per walk).  ``stats``, if
    given, receives ``boxes`` and ``tris`` (child boxes and triangles
    tested, summed over the rays), ``node_seen`` (B,) bool (the node rows
    any ray read: boxes tested) and ``tri_seen`` (T,) bool (the triangles
    any ray tested)."""
    dev = origin.device
    n = origin.shape[0]
    n_nodes = bvh_packed.shape[0]
    d = torch.where(direction == 0.0, 1e-20, direction)
    inv = 1.0 / d
    dst = tmax0.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    ints = bvh_packed.view(torch.int32)
    first_all, count_all = ints[:, 6].long(), ints[:, 7].long()
    boxes = bvh_packed[:, 0:6]
    axis = bvh_axis.long()
    if stats is not None:
        stats.update(
            boxes=0, tris=0,
            node_seen=torch.zeros(n_nodes, dtype=torch.bool, device=dev),
            tri_seen=torch.zeros(tri_packed.shape[0], dtype=torch.bool,
                                 device=dev),
        )
    if n == 0:
        return dst, prim, u, v, front
    stack = torch.zeros((n, N_STACK), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    e_root = _entry(boxes[root].expand(n, 6), origin, inv)
    lanes = (e_root < dst).nonzero().squeeze(1)
    stack[lanes, 0] = root
    sp[lanes] = 1
    if stats is not None:
        stats["boxes"] += int((tmax0 > -BIG).sum())
        stats["node_seen"][root] = True
    for _ in range(n_nodes + 1):
        if lanes.numel() == 0:
            return dst, prim, u, v, front
        top = sp[lanes] - 1
        node = stack[lanes, top]
        sp[lanes] = top
        first, count = first_all[node], count_all[node]
        leaf = count > 0

        lf = leaf.nonzero().squeeze(1)
        if lf.numel():
            ll, lfirst, lcount = lanes[lf], first[lf], count[lf]
            for k in range(int(lcount.max())):
                live = k < lcount
                ti = torch.where(live, lfirst + k, 0)
                if stats is not None:
                    stats["tris"] += int(live.sum())
                    stats["tri_seen"][ti[live]] = True
                t, tu, tv, tf, ok = mt_test(tri_packed[ti], origin[ll], d[ll])
                closer = live & ok & (t < dst[ll])
                dst[ll] = torch.where(closer, t, dst[ll])
                prim[ll] = torch.where(closer, ti.to(torch.int32), prim[ll])
                u[ll] = torch.where(closer, tu, u[ll])
                v[ll] = torch.where(closer, tv, v[ll])
                front[ll] = torch.where(closer, tf, front[ll])

        it = (~leaf).nonzero().squeeze(1)
        if it.numel():
            il, c0 = lanes[it], first[it]
            if stats is not None:
                stats["boxes"] += 2 * it.numel()
                stats["node_seen"][c0] = True
                stats["node_seen"][c0 + 1] = True
            best = dst[il]
            e0 = _entry(boxes[c0], origin[il], inv[il])
            e1 = _entry(boxes[c0 + 1], origin[il], inv[il])
            neg = d[il].gather(1, axis[node[it]][:, None])[:, 0] < 0
            push_far = torch.where(neg, e0, e1) < best
            push_near = torch.where(neg, e1, e0) < best
            at = sp[il]
            if int(at.max()) + 2 > N_STACK:
                raise RuntimeError("traversal stack overflow")
            for push, child in ((push_far, torch.where(neg, c0, c0 + 1)),
                                (push_near, torch.where(neg, c0 + 1, c0))):
                pl = il[push]
                stack[pl, sp[pl]] = child[push]
                sp[pl] += 1

        lanes = lanes[sp[lanes] > 0]
    if lanes.numel():
        raise RuntimeError(
            f"traversal did not finish within {n_nodes + 1} steps")
    return dst, prim, u, v, front
