"""Rope-walk traversal: the per-octant BOX-row streams, the CUDA walk and
its plain torch twin.

Port of ``ray_tracer_tpu/kernels/lanewalk.py``.  The binary tree is
flattened, once per ray direction octant, into a stream of 8-float BOX
rows, one per node, in that octant's preorder (the octant's first child of
an interior node follows it):

* 0:3 bmin | 3:6 bmax | 6 miss row, an f32 VALUE (``DEAD = 2^24`` ends a
  walk) | 7 leaf word, i32 bits: 0 on an interior node, ``count << 24 |
  first`` on a leaf, whose triangles are ``tri_packed`` rows first ..
  first + count - 1 (``scene.types.rope_leaf_words``).

A box the ray enters within its current best leads on to the next row
(interior) or to the leaf's triangles, tested in order, then to its miss
row; a box it misses to its miss row.  Every link moves forward in the
preorder labelling, so a walk steps through at most ``n_rows`` BOX rows.
The streams are (8, R, 8), one 32 B row (two float4 loads) a step on the
card.  The JAX package keeps each leaf's triangles in the stream as TRI
rows after its BOX row, page-major for the TPU's lane gathers;
``scene.types.rope_box_rows`` converts that layout to this one, and the
walk tests the same boxes and triangles in the same order.

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
from ..scene.types import (
    ROPE_BOX_FIELDS,
    ROPE_DEAD,
    ROPE_FIRST_BITS,
    rope_leaf_words,
)
from .bvh8 import CSRC, NVCC_FLAGS, check_tensors, mt_test

BIG = 99999999.0
DEAD = ROPE_DEAD  # terminal row id, f32-exact
SENTINEL = 2**31 - 1  # terminal of the octant rope links (accel/bvh.py)
F = ROPE_BOX_FIELDS
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
                       n_tris: int):
    """The (8, B, 8) f32 per-octant BOX-row streams and ``n_rows`` = B, the
    BOX rows of each octant (one per binary node).

    ``hit_link``/``miss_link``: (8, B) octant-threaded rope links with
    SENTINEL terminals (``accel/bvh.py``); ``n_tris``: the triangles of
    ``tri_packed``, which the leaf words index.  Equal to
    ``scene.types.rope_box_rows`` of the JAX package's
    ``build_rope_streams`` of the same tree.  Raises ``ValueError`` where
    a leaf lies beyond the leaf word's limits.
    """
    n_nodes = index.shape[0]
    index = np.asarray(index, np.int64)
    cnt = np.asarray(cnt, np.int64)
    levels = _levels(index, cnt)
    if sum(lv.size for lv in levels) != n_nodes:
        raise ValueError("the BVH is not one tree rooted at node 0")
    if n_nodes >= DEAD:
        raise ValueError(f"{n_nodes} rope rows: row ids must stay below "
                         f"2^24")
    subtree_rows = np.ones(n_nodes, np.int64)
    for level in reversed(levels):
        inner = level[cnt[level] == 0]
        subtree_rows[inner] += (subtree_rows[index[inner]]
                                + subtree_rows[index[inner] + 1])
    leaf_word = rope_leaf_words(index, cnt, n_tris)
    streams = np.zeros((8, n_nodes, F), np.float32)
    for o in range(8):
        ml = np.asarray(miss_link[o], np.int64)
        row = _octant_rows(index, cnt, np.asarray(hit_link[o], np.int64),
                           levels, subtree_rows)
        rows = streams[o]
        rows[row, 0:3] = bvh_min
        rows[row, 3:6] = bvh_max
        rows[row, 6] = np.where(ml == SENTINEL, DEAD,
                                row[np.clip(ml, 0, n_nodes - 1)])
        rows.view(np.int32)[row, 7] = leaf_word
    return streams, n_nodes


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
        lib.rt_rope_walk.restype = ctypes.c_int
        lib.rt_rope_walk.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        )
        _lib = lib
    return _lib


def _check(streams, tri_packed, n_rows, origin, direction, tmax0, octant):
    n = origin.shape[0]
    r = streams.shape[1] if streams.dim() == 3 else 0
    if not 0 < n_rows == r:
        raise ValueError(
            f"no rope streams for {n_rows} rows (compile the scene with "
            "compile(rope_streams=True))"
        )
    check_tensors(
        origin.device, torch.float32,
        streams=(streams, (8, r, F)),
        tri_packed=(tri_packed, (tri_packed.shape[0], 16)),
        origin=(origin, (n, 3)), direction=(direction, (n, 3)),
        tmax0=(tmax0, (n,)),
    )
    check_tensors(origin.device, torch.int32, octant=(octant, (n,)))
    if r >= DEAD or n >= 2**31 or tri_packed.shape[0] >= 2**31:
        raise ValueError("too many rope rows, triangles or rays for 32-bit "
                         "ids")


def error_flag(device) -> torch.Tensor:
    """A cleared (1,) i32 flag for :func:`lanewalk_traverse`'s ``err``."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def raise_on_flag(flag: int, n_rows: int) -> None:
    """Raise if a rope walk set the error flag (its value, read on the
    host)."""
    if flag:
        raise RuntimeError(f"rope walk: a ray did not end within "
                           f"{n_rows + 2} steps or left its stream")


def lanewalk_traverse(streams, tri_packed, n_rows: int, origin, direction,
                      tmax0, anyhit: bool = False, octant=None, err=None):
    """Rope walk of N rays -> ``(dst, prim)``.

    ``dst``: the closest accepted t (``tmax0`` on a miss), or under
    ``anyhit`` ``-BIG`` where a hit lies inside ``tmax0``; ``prim``: the
    global triangle id of the closest hit, -1 on a miss and under
    ``anyhit``.  Lanes with ``tmax0 <= -BIG/2`` are inactive.
    ``octant`` (N,) i32 picks each ray's stream (default: its own
    direction octant).  A malformed stream (a walk that does not end
    within ``n_rows + 2`` steps, or leaves its stream or the triangles)
    raises: at once, or, on the card with ``err`` (a flag from
    :func:`error_flag`), later, where the caller reads ``err`` (the kernel
    ORs 1 into it; :func:`raise_on_flag`): the call then waits for no
    device result.
    """
    if octant is None:
        octant = direction_octant(direction)
    elif octant.numel() and not 0 <= int(octant.min()) <= int(
            octant.max()) < 8:
        raise ValueError("octant must lie in 0..7")
    _check(streams, tri_packed, n_rows, origin, direction, tmax0, octant)
    dev = origin.device
    if dev.type == "cpu":
        return lanewalk_traverse_reference(streams, tri_packed, n_rows,
                                           origin, direction, tmax0, anyhit,
                                           octant)
    if dev.type != "cuda":
        raise ValueError(f"no rope-walk kernel for device {dev}")
    n = origin.shape[0]
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return dst, prim
    flag = error_flag(dev) if err is None else err
    check_tensors(dev, torch.int32, err=(flag, (1,)))
    code = _load().rt_rope_walk(
        int(anyhit), streams.data_ptr(), n_rows, tri_packed.data_ptr(),
        tri_packed.shape[0], origin.data_ptr(), direction.data_ptr(),
        tmax0.data_ptr(), octant.data_ptr(), dst.data_ptr(),
        prim.data_ptr(), n, n_rows + 2, flag.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"rope-walk kernel launch failed: CUDA error "
                           f"{code}")
    launches["lanewalk_anyhit" if anyhit else "lanewalk_closest"] += 1
    if err is None:
        raise_on_flag(int(flag.item()), n_rows)
    return dst, prim


def _leaf_fields(words):
    """(first, count) of leaf words (int64; count 0 on interior rows)."""
    w = words.long()
    return w & ((1 << ROPE_FIRST_BITS) - 1), w >> ROPE_FIRST_BITS


def lanewalk_traverse_reference(streams, tri_packed, n_rows: int, origin,
                                direction, tmax0, anyhit: bool = False,
                                octant=None, stats: dict = None):
    """The CUDA walk in plain torch: one BOX step of every live lane per
    iteration and, on the lanes that enter a leaf, that leaf's triangles
    in order (masked up to the largest count among them).  ``stats``, if
    given, receives ``box`` (BOX steps) and ``tri`` (triangle tests),
    summed over the rays, ``row_seen`` (8*R,) bool, the distinct BOX rows
    any ray stepped on, and ``tri_seen`` (T,) bool, the distinct
    triangles any ray tested."""
    if octant is None:
        octant = direction_octant(direction)
    dev = origin.device
    n = origin.shape[0]
    n_tris = tri_packed.shape[0]
    flat = streams.reshape(-1, F)
    words = flat.view(torch.int32)[:, 7]
    base = octant.long() * n_rows
    d = torch.where(direction == 0.0, 1e-20, direction)
    inv = 1.0 / d
    best = tmax0.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cur = torch.where(best > -BIG * 0.5, 0, DEAD).long()
    if stats is not None:
        stats.update(
            box=0, tri=0,
            row_seen=torch.zeros(flat.shape[0], dtype=torch.bool,
                                 device=dev),
            tri_seen=torch.zeros(n_tris, dtype=torch.bool, device=dev))
    lanes = (cur < DEAD).nonzero().squeeze(1)
    for _ in range(n_rows + 2):
        if lanes.numel() == 0:
            return best, prim
        c = cur[lanes]
        if int(c.min()) < 0 or int(c.max()) >= n_rows:
            raise RuntimeError("rope walk: a ray left its stream")
        at = base[lanes] + c
        g = flat[at]
        o, dd, iv, b = origin[lanes], d[lanes], inv[lanes], best[lanes]
        if stats is not None:
            stats["box"] += lanes.numel()
            stats["row_seen"][at] = True
        # the slab test of lanewalk.py:219-237
        t1 = (g[:, 0:3] - o) * iv
        t2 = (g[:, 3:6] - o) * iv
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t_near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        t_far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        enter = ((t_far >= t_near) & (t_far > 0.0)
                 & (t_near.clamp(min=0.0) < b))
        first, count = _leaf_fields(words[at])
        is_leaf = count > 0
        nxt = torch.where(enter & ~is_leaf, c + 1, g[:, 6].long())
        # the entered leaves' triangles, in order, against the current best
        lf = (enter & is_leaf).nonzero().squeeze(1)
        if lf.numel():
            f, k_n = first[lf], count[lf]
            if int((f + k_n).max()) > n_tris:
                raise RuntimeError("rope walk: a leaf left the triangles")
            bl, pl = b[lf], prim[lanes[lf]]
            done = torch.zeros(lf.numel(), dtype=torch.bool, device=dev)
            for k in range(int(k_n.max())):
                m = (k < k_n) & ~done
                ti = torch.where(m, f + k, 0)
                if stats is not None:
                    stats["tri"] += int(m.sum())
                    stats["tri_seen"][ti[m]] = True
                t, _, _, _, ok = mt_test(tri_packed[ti], o[lf], dd[lf],
                                         front_only=12)
                imp = m & ok & (t < bl)
                if anyhit:
                    bl = torch.where(imp, -BIG, bl)
                    done = done | imp
                else:
                    bl = torch.where(imp, t, bl)
                    pl = torch.where(imp, ti.to(torch.int32), pl)
            b[lf] = bl
            best[lanes] = b
            prim[lanes[lf]] = pl
            if anyhit:
                nxt[lf] = torch.where(done, DEAD, nxt[lf])
        cur[lanes] = nxt
        lanes = lanes[nxt < DEAD]
    if lanes.numel():
        raise RuntimeError(f"rope walk: a ray did not end within "
                           f"{n_rows + 2} steps")
    return best, prim
