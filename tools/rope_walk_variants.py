"""Build and launch tools/rope_walk_variants.cu: the rope walk before its
redesign ("old", on the old streams of 64 B BOX and TRI rows) and
rope_walk_kernel, which replaced it, with each design element switched.
Holds a copy of the old streams' builder (:func:`build_old_streams`, the
package's build before the BOX-row layout) for the comparison in turns.
chip_smoke.py, tools/measure_rope_walk.py and the GPU tests import it;
the package does not.

Every variant takes the arguments of ``kernels/lanewalk.py::
lanewalk_traverse`` (streams, tri_packed, n_rows, origin, direction, tmax0,
anyhit, octant) and returns ``(dst, prim)``; the variants of
:data:`OLD_LAYOUT` walk the old streams (:func:`old_streams`) instead of
the scene's.  Launching needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from ray_tracer_tpu_torch.kernels import bvh8, lanewalk
from ray_tracer_tpu_torch.kernels.lanewalk import (
    DEAD,
    SENTINEL,
    _levels,
    _octant_rows,
)
from ray_tracer_tpu_torch.native_build import build_shared, nvcc_path

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "rope_walk_variants.cu")
# rt_rope_variant's variant ids, in order: old, the design replaced;
# shipped_copy, rope_walk_kernel's walk; baseline, the variants' template
# at the shipped settings; then one element switched each, against the
# baseline or against one_row (tools/rope_walk_variants.cu says which;
# rows64: the old 64 B rows with the new loop; none: every loop element
# off, on the new layout: a leaf in one step, compare-select, while-while,
# each branch loading its own rows, one row a step, registers free)
VARIANTS = ("old", "shipped_copy", "baseline", "one_row", "rows64",
            "leaf_in_one_step", "fminf_select_minmax", "while_while",
            "prefetch_next", "branch_first", "regs_free", "regs64", "regs48",
            "regs40", "none", "branch_pair")
OLD_LAYOUT = ("old", "rows64")
ROWS = 128  # the old streams' rows are padded to a multiple of this

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per hash of their source and of the
    shipped source they include); return the path."""
    return build_shared(SRC, "rope_walk_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = ctypes.CDLL(build())
        out.rt_rope_variant.restype = ctypes.c_int
        out.rt_rope_variant.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        _lib = out
    return _lib


def build_old_streams(bvh_min, bvh_max, index, cnt, hit_link, miss_link,
                      tri_packed):
    """The old (8, R_pad, 16) f32 streams and their rows R: per octant a
    BOX row per node (0:3 bmin | 3:6 bmax | 6 hit row | 7 miss row | 15
    type 0), a leaf's TRI rows after it (0:12 v0|e1|e2|n | 12 next row |
    13 front_only | 14 triangle id | 15 type 1), padded to a multiple of
    128 rows; and, for the ``rows64`` variant, the leaf's triangle count in
    float 8 of its BOX row (0 on interior rows; the old kernel reads no
    float 8 of a BOX row)."""
    n_nodes = index.shape[0]
    index = np.asarray(index, np.int64)
    cnt = np.asarray(cnt, np.int64)
    leaf = cnt > 0
    levels = _levels(index, cnt)
    nper = 1 + np.where(leaf, cnt, 0)
    subtree_rows = nper.copy()
    for level in reversed(levels):
        inner = level[cnt[level] == 0]
        subtree_rows[inner] += (subtree_rows[index[inner]]
                                + subtree_rows[index[inner] + 1])
    n_rows = int(nper.sum())
    r_pad = -(-max(n_rows, 1) // ROWS) * ROWS
    streams = np.zeros((8, r_pad, 16), np.float32)
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
        rows[row, 8] = cnt
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


def old_streams(scene):
    """The old streams of a compiled scene, on its device: ``(streams,
    n_rows)``."""
    host = [getattr(scene, f).cpu().numpy() for f in (
        "bvh_min", "bvh_max", "bvh_index", "bvh_tri_count", "bvh_hit_link",
        "bvh_miss_link", "tri_packed")]
    streams, n_rows = build_old_streams(*host)
    return torch.from_numpy(streams).to(scene.device), n_rows


def run(variant: str, streams, tri_packed, n_rows: int, origin, direction,
        tmax0, anyhit: bool = False, octant=None):
    """One launch of ``variant`` (the old streams for :data:`OLD_LAYOUT`,
    with their padded row count as ``streams.shape[1]``): ``(dst, prim)``.
    Raises if the walk sets its error flag."""
    n = origin.shape[0]
    dev = origin.device
    if octant is None:
        octant = lanewalk.direction_octant(direction)
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = streams.shape[1] if variant in OLD_LAYOUT else n_rows
    if n:
        code = lib().rt_rope_variant(
            VARIANTS.index(variant), int(anyhit), streams.data_ptr(), rows,
            tri_packed.data_ptr(), tri_packed.shape[0], origin.data_ptr(),
            direction.data_ptr(), tmax0.data_ptr(), octant.data_ptr(),
            dst.data_ptr(), prim.data_ptr(), n, n_rows + 2, err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"rope walk variant {variant}: CUDA error "
                               f"{code}")
    return dst, prim, err


def compare(name, got, want):
    """Raise unless ``got`` = (dst, prim[, err]) equals ``want`` bit for
    bit and no error flag is set."""
    for what, a, b in zip(("dst", "prim"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
    for x in (got, want):
        if len(x) > 2 and int(x[2].item()):
            raise AssertionError(f"{name}: a walk set its error flag")
