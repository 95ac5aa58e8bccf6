"""Rope-walk traversal: the per-octant row streams, the CUDA walk and its
plain torch twin.

Port of ``ray_tracer_tpu/kernels/lanewalk.py``.  The binary tree is
flattened, once per ray direction octant, into a stream of 16-float rows
in that octant's preorder (interior node -> one BOX row; leaf -> a BOX row
and one TRI row per triangle):

* BOX row: 0:3 bmin | 3:6 bmax | 6 hit_row | 7 miss_row | 15 type = 0
* TRI row: 0:3 v0 | 3:6 e1 | 6:9 e2 | 9:12 n | 12 next_row |
  13 front_only | 14 global tri id | 15 type = 1

Row ids are f32 VALUES (exact below 2^24; ``DEAD = 2^24`` ends a walk).  In
the preorder labelling every link moves forward (hit -> row + 1, miss ->
the preorder successor), so a walk steps at most ``n_rows`` times.  The
streams are row-major, (8, R_pad, 16): one row is 64 B, four float4 loads
on the card.  The JAX package's page-major, field-major layout serves the
TPU's lane gathers; ``scene.types.rope_rows_layout`` converts it.

``lanewalk_traverse`` walks every ray through the stream of its own
direction octant: on CUDA tensors in ``csrc/lanewalk.cu`` (built with
``nvcc`` at first use), on CPU tensors in
:func:`lanewalk_traverse_reference`.  The TPU kernel walks each 1024-lane
block in its majority octant; any octant's stream is a complete
traversal, so ``dst`` and the hit set are the same, and ``prim`` can
differ only on exact-t ties (the visit order decides which of two
triangles at one t is kept).  Passing the block-majority octants as
``octant`` reproduces the TPU kernel's ``prim`` too.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from ..native_build import build_shared, nvcc_path
from ..scene.types import ROPE_FIELDS, ROPE_PAGE
from .bvh8 import CSRC, NVCC_FLAGS, check_tensors, mt_test

BIG = 99999999.0
DEAD = 1 << 24  # terminal row id, f32-exact
SENTINEL = 2**31 - 1  # terminal of the octant rope links (accel/bvh.py)
F = ROPE_FIELDS
_SRC = os.path.join(CSRC, "lanewalk.cu")

# Kernel launches per mode since the last reset (the CPU path never adds).
launches = {"lanewalk_closest": 0, "lanewalk_anyhit": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _levels(index, cnt):
    """Node ids by depth below the root (node 0)."""
    levels = [np.zeros(1, np.int64)]
    while True:
        inner = levels[-1][cnt[levels[-1]] == 0]
        if inner.size == 0:
            return levels
        levels.append(np.stack([index[inner], index[inner] + 1], axis=1)
                      .reshape(-1))


def _octant_rows(index, cnt, first_child, levels, subtree_rows):
    """Row of each node's BOX row in the preorder where an interior node's
    first child is its octant hit link (``first_child``): the JAX
    package's ``_octant_preorder`` walk, as level-by-level offsets.  The
    first child's rows follow its parent's BOX row; the second child's
    follow the first child's subtree."""
    row = np.zeros(index.shape[0], np.int64)
    for level in levels:
        inner = level[cnt[level] == 0]
        f = first_child[inner]
        s = np.where(f == index[inner], index[inner] + 1, index[inner])
        row[f] = row[inner] + 1
        row[s] = row[inner] + 1 + subtree_rows[f]
    return row


def build_rope_streams(bvh_min, bvh_max, index, cnt, hit_link, miss_link,
                       tri_packed):
    """The (8, R_pad, 16) f32 per-octant row streams and ``n_rows`` (R, the
    rows of each octant; R_pad rounds it up to a multiple of 128).

    ``hit_link``/``miss_link``: (8, B) octant-threaded rope links with
    SENTINEL terminals (``accel/bvh.py``); ``tri_packed``: (T, 16)
    v0|e1|e2|n|front_only rows.  Equal, after the layout change, to the
    JAX package's ``build_rope_streams`` of the same tree.
    """
    n_nodes = index.shape[0]
    index = np.asarray(index, np.int64)
    cnt = np.asarray(cnt, np.int64)
    leaf = cnt > 0
    levels = _levels(index, cnt)
    if sum(lv.size for lv in levels) != n_nodes:
        raise ValueError("the BVH is not one tree rooted at node 0")
    nper = 1 + np.where(leaf, cnt, 0)  # rows of each node's own
    subtree_rows = nper.copy()
    for level in reversed(levels):
        inner = level[cnt[level] == 0]
        subtree_rows[inner] += (subtree_rows[index[inner]]
                                + subtree_rows[index[inner] + 1])
    n_rows = int(nper.sum())
    r_pad = -(-max(n_rows, 1) // ROPE_PAGE) * ROPE_PAGE
    if r_pad >= DEAD or tri_packed.shape[0] >= DEAD:
        raise ValueError(f"{n_rows} rope rows or {tri_packed.shape[0]} "
                         f"triangles: ids must stay below 2^24")
    streams = np.zeros((8, r_pad, F), np.float32)
    leaves = np.nonzero(leaf)[0]
    for o in range(8):
        hl = np.asarray(hit_link[o], np.int64)
        ml = np.asarray(miss_link[o], np.int64)
        row = _octant_rows(index, cnt, hl, levels, subtree_rows)
        rows = streams[o]
        miss_row = np.where(ml == SENTINEL, DEAD,
                            row[np.clip(ml, 0, n_nodes - 1)])
        hit_row = np.where(
            leaf, row + 1,
            np.where(hl == SENTINEL, DEAD, row[np.clip(hl, 0, n_nodes - 1)]),
        )
        rows[row, 0:3] = bvh_min
        rows[row, 3:6] = bvh_max
        rows[row, 6] = hit_row
        rows[row, 7] = miss_row
        # TRI rows: a leaf's triangles index..index+cnt-1 in order, the
        # last one linking to the leaf's miss row
        for k in range(int(cnt.max(initial=0))):
            lp = leaves[cnt[leaves] > k]
            r = row[lp] + 1 + k
            ti = index[lp] + k
            rows[r, 0:12] = tri_packed[ti, 0:12]
            rows[r, 12] = np.where(cnt[lp] == k + 1, miss_row[lp], r + 1)
            rows[r, 13] = tri_packed[ti, 12]
            rows[r, 14] = ti
            rows[r, 15] = 1.0
    return streams, n_rows


def direction_octant(direction):
    """(N,) i32 octant of each ray: bit a set where direction[a] < 0, from
    the direction as given (no zero guard)."""
    neg = (direction < 0).to(torch.int32)
    return neg[:, 0] + 2 * neg[:, 1] + 4 * neg[:, 2]


def build() -> str:
    """Compile the rope-walk library (once per source hash); its path."""
    return build_shared(_SRC, "lanewalk", (nvcc_path(), *NVCC_FLAGS))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.rt_lanewalk.restype = ctypes.c_int
        lib.rt_lanewalk.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p]
        )
        _lib = lib
    return _lib


def _check(streams, n_rows, origin, direction, tmax0, octant):
    n = origin.shape[0]
    r_pad = streams.shape[1] if streams.dim() == 3 else 0
    if not 0 < n_rows <= r_pad:
        raise ValueError(
            f"no rope streams for {n_rows} rows (compile the scene with "
            "compile(rope_streams=True))"
        )
    check_tensors(
        origin.device, torch.float32,
        streams=(streams, (8, r_pad, F)),
        origin=(origin, (n, 3)), direction=(direction, (n, 3)),
        tmax0=(tmax0, (n,)),
    )
    check_tensors(origin.device, torch.int32, octant=(octant, (n,)))
    if r_pad >= DEAD or n >= 2**31:
        raise ValueError("too many rope rows or rays for 32-bit ids")


def lanewalk_traverse(streams, n_rows: int, origin, direction, tmax0,
                      anyhit: bool = False, octant=None):
    """Rope walk of N rays -> ``(dst, prim)``.

    ``dst``: the closest accepted t (``tmax0`` on a miss), or under
    ``anyhit`` ``-BIG`` where a hit lies inside ``tmax0``; ``prim``: the
    global triangle id of the closest hit, -1 on a miss and under
    ``anyhit``.  Lanes with ``tmax0 <= -BIG/2`` are inactive.
    ``octant`` (N,) i32 picks each ray's stream (default: its own
    direction octant).  Raises if a walk does not end within
    ``n_rows + 2`` steps or leaves its stream (a malformed stream).
    """
    if octant is None:
        octant = direction_octant(direction)
    elif octant.numel() and not 0 <= int(octant.min()) <= int(
            octant.max()) < 8:
        raise ValueError("octant must lie in 0..7")
    _check(streams, n_rows, origin, direction, tmax0, octant)
    dev = origin.device
    if dev.type == "cpu":
        return lanewalk_traverse_reference(streams, n_rows, origin,
                                           direction, tmax0, anyhit, octant)
    if dev.type != "cuda":
        raise ValueError(f"no rope-walk kernel for device {dev}")
    n = origin.shape[0]
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return dst, prim
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    code = _load().rt_lanewalk(
        streams.data_ptr(), streams.shape[1], origin.data_ptr(),
        direction.data_ptr(), tmax0.data_ptr(), octant.data_ptr(),
        dst.data_ptr(), prim.data_ptr(), n, int(anyhit), n_rows + 2,
        err.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"rope-walk kernel launch failed: CUDA error "
                           f"{code}")
    launches["lanewalk_anyhit" if anyhit else "lanewalk_closest"] += 1
    if int(err.item()):
        raise RuntimeError(f"rope walk: a ray did not end within "
                           f"{n_rows + 2} steps or left its stream")
    return dst, prim


def lanewalk_traverse_reference(streams, n_rows: int, origin, direction,
                                tmax0, anyhit: bool = False, octant=None,
                                stats: dict = None):
    """The CUDA walk in plain torch: one rope step of every live lane per
    iteration.  ``stats``, if given, receives ``box`` and ``tri`` (rows
    of each type stepped, summed over the rays) and ``row_seen`` (8*R_pad,)
    bool, the distinct rows any ray read."""
    if octant is None:
        octant = direction_octant(direction)
    dev = origin.device
    n = origin.shape[0]
    r_pad = streams.shape[1]
    flat = streams.reshape(-1, F)
    base = octant.long() * r_pad
    d = torch.where(direction == 0.0, 1e-20, direction)
    inv = 1.0 / d
    best = tmax0.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cur = torch.where(best > -BIG * 0.5, 0, DEAD).long()
    if stats is not None:
        stats.update(box=0, tri=0, row_seen=torch.zeros(
            flat.shape[0], dtype=torch.bool, device=dev))
    lanes = (cur < DEAD).nonzero().squeeze(1)
    for _ in range(n_rows + 2):
        if lanes.numel() == 0:
            return best, prim
        c = cur[lanes]
        if int(c.max()) >= r_pad:
            raise RuntimeError("rope walk: a ray left its stream")
        g = flat[base[lanes] + c]
        o, dd, iv, b = origin[lanes], d[lanes], inv[lanes], best[lanes]
        is_tri = g[:, 15] > 0.5
        if stats is not None:
            stats["tri"] += int(is_tri.sum())
            stats["box"] += int((~is_tri).sum())
            stats["row_seen"][base[lanes] + c] = True
        # BOX interpretation (the slab prune of lanewalk.py:219-237)
        t1 = (g[:, 0:3] - o) * iv
        t2 = (g[:, 3:6] - o) * iv
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t_near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        t_far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        box_hit = ((t_far >= t_near) & (t_far > 0.0)
                   & (t_near.clamp(min=0.0) < b))
        # TRI interpretation
        t, _, _, _, ok = mt_test(g, o, dd, front_only=13)
        imp = is_tri & ok & (t < b)
        nxt = torch.where(is_tri, g[:, 12],
                          torch.where(box_hit, g[:, 6], g[:, 7])).long()
        if anyhit:
            best[lanes] = torch.where(imp, -BIG, b)
            nxt = torch.where(imp, DEAD, nxt)
        else:
            best[lanes] = torch.where(imp, t, b)
            prim[lanes] = torch.where(imp, g[:, 14].to(torch.int32),
                                      prim[lanes])
        cur[lanes] = nxt
        lanes = lanes[nxt < DEAD]
    if lanes.numel():
        raise RuntimeError(f"rope walk: a ray did not end within "
                           f"{n_rows + 2} steps")
    return best, prim
