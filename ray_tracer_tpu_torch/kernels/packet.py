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
            [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] + [ctypes.c_void_p] * 8
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


# The forest walk's cull: an entry beyond best * CULL_SLACK is culled
# (bvh2_walk.cu's kCullSlack, 1 + 2^-16); a row that never culls.
CULL_SLACK = 1.0000152587890625
CULL_NEVER = (-np.inf, -np.inf, -np.inf, 0.0, np.inf, np.inf, np.inf, np.inf)
# Its chunks (bvh2_walk.cu's kForestChunk, kTreeRows, kTreeLeaf and
# kTreeStack): instances under one tree and one candidate mask, a chunk
# tree's rows, a leaf's word flag, the far children a walk of it keeps.
FOREST_CHUNK = 128
TREE_ROWS = 2 * FOREST_CHUNK - 1
TREE_LEAF = 0x80000000
TREE_STACK = 8
# The audit instance's counters (bvh2_walk.cu's ForestArgs::counts).
AUDIT_COUNTERS = ("scans", "world_pass", "root_pass", "roots", "boxes",
                  "tris", "violations", "tree_tests")


def _f32_out(x, up: bool):
    """float64 values rounded to f32 away from the box: up or down."""
    y = np.asarray(x, np.float64).astype(np.float32)
    off = y.astype(np.float64) < x if up else y.astype(np.float64) > x
    return np.where(off, np.nextafter(y, np.float32(np.inf if up else -np.inf)),
                    y)


def forest_cull_table(inv_transform, bvh_packed, roots) -> np.ndarray:
    """The forest walk's world boxes, from host arrays: (K,8) f32 rows
    ``lo.xyz, eta, hi.xyz, delta``, one per instance (``inv_transform``
    (K,4,4) f32, ``bvh_packed`` (B,8) f32, ``roots`` the K root nodes).

    ``lo..hi`` is the world image of instance k's root box (row
    ``roots[k]``) under the float64 inverse of the f32 ``inv_transform[k]``
    (the matrix the kernel applies; ``obj_transform`` in f32 is not its
    exact inverse), rounded outward to f32 and widened by ``delta`` on
    every side; the kernel grows it by ``eta * max|o|`` more for a ray from
    o (``forest_cull_reference``).  The kernel may skip the instance where
    the world ray misses that box, because then its root test must fail.

    The margin (u = 2^-24, g_n = n u / (1 - n u); A and c the f32 matrix's
    3x3 part and translation, Ai the inverse of A, |.| elementwise, m =
    max|o|, M the root box's largest |coordinate| per axis, W the world
    image's): where the root test passes on a lane whose best t is at most
    BIG, t' = max(tmin, 0) < best lies in each of the three computed slabs,
    so the real point p + t' q of the kernel's object-space ray lies in the
    root's box grown per axis by g3 (|p| + M) (the slab's three roundings)
    and 1e-12 (a zero component's 1e-20 over t' < 1e8).  The kernel's p
    and q miss A o + c and A d by at most g4 (|A| m + |c|) and g3 |A| |d|,
    and t' |d| <= |X| + m for the world point X = o + t' d.  Taken to world
    space through |Ai|, X lies in the image grown by |Ai| times the sum;
    that sum holds X itself through g3 |A| |X|, which is why the bound is
    taken 4/3 times, for g3 times the largest row sum of |Ai| |A| (the
    condition number) at most 1/4.  The world test moves each of its
    planes by at most g4 (|lo| + s + m) + 1e-12 by its own rounding.
    ``delta`` is twice the parts that do not grow with m, ``eta`` twice
    those that do (the factor also covers the roundings of the kernel's
    ``eta * m`` and of the float64 arithmetic here).  A row whose
    transform is singular, not finite or beyond that condition number, or
    whose box is not finite, never culls (``CULL_NEVER``).  The kernel
    reads the rows under :func:`forest_cull_trees`."""
    inv = np.asarray(inv_transform, np.float32).astype(np.float64)
    nodes = np.asarray(bvh_packed, np.float32).astype(np.float64)
    roots = [int(r) for r in roots]
    out = np.tile(np.array(CULL_NEVER, np.float32), (len(roots), 1))
    u = 2.0 ** -24
    g3, g4 = 3 * u / (1 - 3 * u), 4 * u / (1 - 4 * u)
    bits = np.arange(8)
    pick = np.stack([np.where(bits & 1, 3, 0), np.where(bits & 2, 4, 1),
                     np.where(bits & 4, 5, 2)], axis=1)
    with np.errstate(all="ignore"):
        for k, root in enumerate(roots):
            a_mat, c = inv[k, :3, :3], inv[k, :3, 3]
            box = nodes[root, 0:6]
            if not (np.isfinite(inv[k, :3]).all()
                    and np.isfinite(box).all()):
                continue
            try:
                ai = np.linalg.inv(a_mat)
            except np.linalg.LinAlgError:
                continue
            abs_a, abs_ai = np.abs(a_mat), np.abs(ai)
            kappa = float((abs_ai @ abs_a.sum(1)).max())
            if not (np.isfinite(ai).all() and g3 * kappa <= 0.25):
                continue
            world = (box[pick] - c) @ ai.T
            w_lo, w_hi = world.min(0), world.max(0)
            w_max = np.maximum(np.abs(w_lo), np.abs(w_hi))
            big_m = np.maximum(np.abs(box[0:3]), np.abs(box[3:6]))
            fixed = ((g3 * (1 + g4) + g4) * np.abs(c) + g3 * big_m
                     + g3 * (abs_a @ w_max) + 1e-12)
            per_m = (g3 * (1 + g4) + g4 + g3) * abs_a.sum(1)
            slop = 1e-9 * float((abs_ai @ (big_m + np.abs(c))).max())
            delta = (2 * (4 / 3 * float((abs_ai @ fixed).max())
                          + g4 * float(w_max.max()) + 1e-12) + slop)
            eta = 2 * (4 / 3 * float((abs_ai @ per_m).max()) + g4)
            lo = _f32_out(w_lo - delta, up=False)
            hi = _f32_out(w_hi + delta, up=True)
            if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
                continue
            out[k, 0:3], out[k, 4:7] = lo, hi
            out[k, 3] = _f32_out(eta, up=True)
            out[k, 7] = _f32_out(delta, up=True)
    return out


def forest_cull_reference(row, origin, direction, best):
    """Whether the forest walk's cull rules out the box ``row`` ((8,) f32:
    lo.xyz, eta, hi.xyz, ...: a ``forest_cull_table`` row or a chunk
    tree's node; or (R,8) for an (N,R) answer) for the rays (N,3) with best
    t ``best`` (N,): ``bvh2_walk.cu::culled`` and its guard in plain torch,
    f32, in the kernel's order.  The ray misses the box grown by eta *
    max|o| on every side, or enters it beyond best * ``CULL_SLACK``; False
    on a NaN, and wherever best exceeds BIG.  For the tests and the
    audit's plain version; no path runs it."""
    rows = row.reshape(-1, 8)
    d = torch.where(direction == 0.0, 1e-20, direction)
    inv = (1.0 / d)[:, None]
    a = origin.abs()
    m_o = torch.maximum(torch.maximum(a[:, 0], a[:, 1]), a[:, 2])
    s = (rows[None, :, 3] * m_o[:, None])[..., None]
    o = origin[:, None]
    t1 = ((rows[None, :, 0:3] - s) - o) * inv
    t2 = ((rows[None, :, 4:7] + s) - o) * inv
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tmax = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    out = ((tmax < tmin) | (tmax < 0.0)
           | (tmin > best[:, None] * CULL_SLACK)) & (best <= BIG)[:, None]
    return out[:, 0] if row.dim() == 1 else out


def forest_cull_trees(rows) -> np.ndarray:
    """The forest walk's chunk trees, from the (K,8) rows of
    :func:`forest_cull_table` (host array or tensor): per chunk of
    ``FOREST_CHUNK`` instances ``TREE_ROWS`` rows of 8 f32 (lo.xyz, eta,
    hi.xyz, word bits), row 0 the root; (ceil(K / 128) * ``TREE_ROWS``,
    8).  A leaf is an instance's own row with the word ``TREE_LEAF | e``
    (e its index in the chunk); an interior node holds the union of its
    children's boxes and their largest eta, so its test passes wherever a
    leaf's below it would, and its word is its first child's row (the
    second follows; children come after their parent).  Each node splits
    its instances at the median of their boxes' centres along the widest
    spread of those centres, so a tree is balanced: at most 7 levels below
    its root, within the kernel's ``TREE_STACK``."""
    rows = np.asarray(torch.as_tensor(rows).cpu(), np.float32).reshape(-1, 8)
    n_chunks = -(-rows.shape[0] // FOREST_CHUNK)
    out = np.zeros((n_chunks, TREE_ROWS, 8), np.float32)
    word = lambda w: np.array([w], np.uint32).view(np.float32)[0]
    for c in range(n_chunks):
        chunk = rows[c * FOREST_CHUNK:(c + 1) * FOREST_CHUNK]
        with np.errstate(invalid="ignore"):  # a row that never culls
            centre = np.nan_to_num(0.5 * (chunk[:, 0:3] + chunk[:, 4:7]),
                                   posinf=1e30, neginf=-1e30)
        tree, free = out[c], [1]

        def build(at, items, depth):
            if len(items) == 1:
                tree[at] = chunk[items[0]]
                tree[at, 7] = word(TREE_LEAF | int(items[0]))
                return
            if depth >= TREE_STACK:
                raise AssertionError("a chunk tree deeper than the stack")
            first = free[0]
            free[0] += 2
            tree[at, 0:3] = chunk[items, 0:3].min(0)
            tree[at, 3] = chunk[items, 3].max()
            tree[at, 4:7] = chunk[items, 4:7].max(0)
            tree[at, 7] = word(first)
            axis = int(np.ptp(centre[items], axis=0).argmax())
            order = items[np.argsort(centre[items, axis], kind="stable")]
            half = len(items) // 2
            build(first, order[:half], depth + 1)
            build(first + 1, order[half:], depth + 1)

        build(0, np.arange(chunk.shape[0]), 0)
    return out.reshape(-1, 8)


def forest_mask_reference(trees, chunk: int, n_inst: int, origin,
                          direction, best):
    """The candidates of chunk ``chunk`` (``n_inst`` instances) of the
    chunk trees ``trees`` for the rays (N,3) with best t ``best`` (N,):
    ``bvh2_walk.cu::chunk_candidates`` in plain torch -> ``(mask, tests)``,
    ``mask`` (N, n_inst) bool, every instance where best exceeds BIG, and
    ``tests`` (N,) i64, the node boxes a lane's walk of the tree tests
    (none where best exceeds BIG).  Each node's box against every ray
    (:func:`forest_cull_reference`), then a node is reached where its
    parent is reached and its own test passes; a leaf reached is a
    candidate."""
    rows = trees[chunk * TREE_ROWS:chunk * TREE_ROWS + 2 * n_inst - 1]
    keep = ~forest_cull_reference(rows, origin, direction, best)
    words = rows[:, 7].contiguous().view(torch.int32).tolist()
    walked = best <= BIG
    reach = torch.zeros_like(keep)
    reach[:, 0] = keep[:, 0] & walked
    tests = walked.to(torch.int64)
    mask = torch.zeros((origin.shape[0], n_inst), dtype=torch.bool,
                       device=origin.device)
    for r, w in enumerate(words):
        w &= 0xFFFFFFFF
        if w & TREE_LEAF:
            mask[:, w & ~TREE_LEAF] = reach[:, r]
            continue
        reach[:, w] = reach[:, r] & keep[:, w]
        reach[:, w + 1] = reach[:, r] & keep[:, w + 1]
        tests += 2 * reach[:, r]
    return mask | ~walked[:, None], tests


def _check_forest(bvh_packed, bvh_axis, tri_packed, inv_transform, roots,
                  words, cull, origin, direction, tmax0):
    """The forest walk's argument checks; on CPU tensors the roots' words
    and the world boxes against the tables."""
    n = origin.shape[0]
    k = inv_transform.shape[0]
    dev = origin.device
    check_tensors(
        dev, torch.float32,
        bvh_packed=(bvh_packed, (bvh_packed.shape[0], 8)),
        tri_packed=(tri_packed, (tri_packed.shape[0], 16)),
        inv_transform=(inv_transform, (k, 4, 4)),
        cull=(cull, (-(-k // FOREST_CHUNK) * TREE_ROWS, 8)),
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
        trees = torch.from_numpy(forest_cull_trees(forest_cull_table(
            inv_transform, bvh_packed, roots.tolist())))
        if not torch.equal(cull, trees):
            raise ValueError("cull is not forest_cull_trees of the "
                             "instances' transforms and root boxes")
        return
    if dev.type != "cuda":
        raise ValueError(f"no traversal kernel for device {dev}")
    if any(t.data_ptr() % 16 for t in (bvh_packed, tri_packed,
                                       inv_transform, cull)):
        raise ValueError("bvh_packed, tri_packed, inv_transform and cull "
                         "must be 16-byte aligned")


def _launch_forest(args, anyhit: bool, counts=None):
    """One rt_forest_walk launch on checked CUDA arguments; the audit
    instance where ``counts`` (a zeroed (6,) i64 tensor) is given."""
    (bvh_packed, bvh_axis, tri_packed, inv_transform, roots, words, cull,
     origin, direction, tmax0) = args
    n = origin.shape[0]
    dev = origin.device
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
            inv_transform.data_ptr(), roots.data_ptr(), words.data_ptr(),
            cull.data_ptr(), inv_transform.shape[0], origin.data_ptr(),
            direction.data_ptr(), tmax0.data_ptr(), int(anyhit), *ptrs,
            None if counts is None else counts.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"forest walk kernel launch failed: CUDA "
                               f"error {err}")
    return out[0] if anyhit else out


def forest_traverse(bvh_packed, bvh_axis, tri_packed, inv_transform, roots,
                    words, cull, origin, direction, tmax0,
                    anyhit: bool = False):
    """Every instance of a forest in one walk of N rays: ``(dst, prim,
    obj, u, v, front)``, each (N,), or under ``anyhit`` the (N,) bool mask
    of rays that hit an instance within ``tmax0``.

    ``bvh_packed``, ``bvh_axis`` and ``tri_packed`` as for
    :func:`packet_traverse`; ``inv_transform`` (K,4,4) f32, the instances'
    world-to-object transforms; ``roots`` (K,) i32, their roots in
    ``bvh_packed``, ``words`` (K,) i32, the bits of those roots'
    :func:`narrow_root_words`, and ``cull`` (ceil(K/128) * ``TREE_ROWS``,
    8) f32, the chunk trees of their world boxes (:func:`forest_cull_trees`
    of :func:`forest_cull_table`; ``CompiledScene.forest_roots`` and
    ``forest_cull`` build them once from ``meta``; on CPU tensors all
    three are checked against the tables).  The instances are walked in
    order, each ray taken to object space by :func:`object_ray` and
    bounded by its best t so far (``tmax0`` at first; -BIG disables a
    lane): a later instance replaces an earlier one only at a strictly
    smaller t.  ``dst``: the closest accepted t (``tmax0`` on a miss);
    ``prim``: its global triangle id and ``obj`` its instance (-1 on a
    miss); ``u``, ``v``: its barycentrics (0 on a miss); ``front``:
    whether it faces the ray.  Under ``anyhit`` a ray stops at the first
    instance it hits.  On CUDA tensors one launch of
    ``forest_walk_kernel``, which takes to object space only the
    instances whose world box the ray can enter (the outputs are the
    same); on CPU tensors :func:`forest_traverse_reference`."""
    args = (bvh_packed, bvh_axis, tri_packed, inv_transform, roots, words,
            cull, origin, direction, tmax0)
    _check_forest(*args)
    if origin.device.type == "cpu":
        return forest_traverse_reference(
            bvh_packed, bvh_axis, tri_packed, inv_transform, roots.tolist(),
            origin, direction, tmax0, anyhit=anyhit)
    out = _launch_forest(args, anyhit)
    if origin.shape[0]:
        launches["forest_anyhit" if anyhit else "forest_walk"] += 1
    return out


def forest_audit(bvh_packed, bvh_axis, tri_packed, inv_transform, roots,
                 words, cull, origin, direction, tmax0,
                 anyhit: bool = False):
    """:func:`forest_traverse` through the audit instance,
    ``forest_walk_kernel<., true>``, which takes every (ray, instance)
    pair the scan reaches through the root's test, its candidate bit (the
    chunk tree's walk) the cull's verdict, and walks where the root's
    test passes -> ``(out, counts)``: ``out`` what :func:`forest_traverse`
    returns, ``counts`` a dict of ``AUDIT_COUNTERS``: ``scans`` (pairs
    whose lane's bound is above 0), ``world_pass`` and ``root_pass``
    (candidates, pairs whose root's test passes), ``roots`` (root tests:
    every pair whose lane's bound is above -BIG), ``boxes`` and ``tris``
    (box and triangle tests, those roots' included, as
    :func:`forest_traverse_reference`'s ``stats`` count them),
    ``violations`` (pairs culled whose root's test passes: the cull's
    fault) and ``tree_tests`` (the chunk trees' box tests).  Off the
    path: ``chip_smoke.py`` and the GPU tests run it; it adds to no
    launch count.  On CPU tensors
    :func:`forest_audit_reference`."""
    args = (bvh_packed, bvh_axis, tri_packed, inv_transform, roots, words,
            cull, origin, direction, tmax0)
    _check_forest(*args)
    if origin.device.type == "cpu":
        return forest_audit_reference(
            bvh_packed, bvh_axis, tri_packed, inv_transform, roots.tolist(),
            cull, origin, direction, tmax0, anyhit=anyhit)
    counts = torch.zeros(len(AUDIT_COUNTERS), dtype=torch.int64,
                         device=origin.device)
    out = _launch_forest(args, anyhit, counts)
    return out, dict(zip(AUDIT_COUNTERS, counts.tolist()))


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


def forest_audit_reference(bvh_packed, bvh_axis, tri_packed, inv_transform,
                           roots, cull, origin, direction, tmax0,
                           anyhit: bool = False):
    """The audit instance in plain torch -> ``(out, counts)`` as
    :func:`forest_audit` returns them: :func:`forest_traverse_reference`'s
    walk, and on each instance, for the lanes whose bound is above 0, its
    candidate bit (:func:`forest_mask_reference` of the chunk trees
    ``cull``, at the chunk's start) and the root's test (:func:`_entry` of
    the object-space ray, below the bound) counted.  ``roots``: host
    ints."""
    n = origin.shape[0]
    dev = origin.device
    counts = dict.fromkeys(AUDIT_COUNTERS, 0)
    t = tmax0.clone()
    best = dict(prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
                obj=torch.full((n,), -1, dtype=torch.int32, device=dev),
                u=torch.zeros(n, dtype=torch.float32, device=dev),
                v=torch.zeros(n, dtype=torch.float32, device=dev),
                front=torch.zeros(n, dtype=torch.bool, device=dev))
    hit_any = torch.zeros(n, dtype=torch.bool, device=dev)
    boxes = bvh_packed[:, 0:6]
    mask = None
    for k, root in enumerate(roots):
        live = t > 0
        if k % FOREST_CHUNK == 0:
            mask, tests = forest_mask_reference(
                cull, k // FOREST_CHUNK,
                min(FOREST_CHUNK, len(roots) - k), origin, direction, t)
            counts["tree_tests"] += int(tests[live].sum())
        o_k, d_k = object_ray(inv_transform[k], origin, direction)
        inv = 1.0 / torch.where(d_k == 0.0, 1e-20, d_k)
        enter = live & (_entry(boxes[int(root)].expand(n, 6), o_k, inv) < t)
        culled = live & ~mask[:, k % FOREST_CHUNK]
        counts["scans"] += int(live.sum())
        counts["world_pass"] += int((live & ~culled).sum())
        counts["root_pass"] += int(enter.sum())
        counts["violations"] += int((enter & culled).sum())
        counts["roots"] += int((t > -BIG).sum())
        one = {}
        t_k, p_k, u_k, v_k, f_k = packet_traverse_reference(
            bvh_packed, bvh_axis, tri_packed, o_k, d_k, t, int(root),
            stats=one)
        counts["boxes"] += one["boxes"]
        counts["tris"] += one["tris"]
        hit = p_k >= 0
        if anyhit:
            hit_any = hit_any | hit
            t = torch.where(hit, -BIG, t_k)
            continue
        t = t_k
        for name, value in (("prim", p_k), ("u", u_k), ("v", v_k),
                            ("front", f_k)):
            best[name] = torch.where(hit, value, best[name])
        best["obj"] = torch.where(hit, k, best["obj"]).to(torch.int32)
    if anyhit:
        return hit_any, counts
    return (t, best["prim"], best["obj"], best["u"], best["v"],
            best["front"]), counts


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
