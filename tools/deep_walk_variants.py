"""Build and launch tools/deep_walk_variants.cu: the DEEP walk of two-phase
treelet traversal before its redesign ("old"), and deep_walk_kernel with
each design element switched, or with the entries culled by their own box
or visited nearest first (which read the :func:`entry_boxes` table).
chip_smoke.py, tools/measure_deep_walk.py and the tests import it; the
package does not.

Every variant takes the shipped DEEP launch's arguments
(``kernels/packet.py::packet_traverse_wide``) and returns ``(dst, prim)``.
Launching needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Optional

import numpy as np
import torch

from ray_tracer_tpu_torch import Routing
from ray_tracer_tpu_torch.kernels import bvh8, packet
from ray_tracer_tpu_torch.native_build import build_shared, nvcc_path
from ray_tracer_tpu_torch.ops import traverse

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "deep_walk_variants.cu")
# rt_deep_variant's variant ids, in order; shipped_copy is deep_walk_kernel
# as it ships, old the design it replaced (also at two-row slots)
VARIANTS = ("shipped_copy", "loop_per_entry", "top_word_in_register",
            "cull_at_turn", "cull_up_front", "near_order",
            "fminf_select_minmax", "all_records", "no_early_exit", "regs_free",
            "regs56", "regs72", "old")
# the variants that read the entry-box table
BOXED = ("cull_at_turn", "cull_up_front", "near_order")
# the variants that visit the entries in another order than the list's,
# last first (compare_near)
NEAR_ORDER = ("near_order",)

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per hash of their source and of the
    shipped source they include); return the path."""
    return build_shared(SRC, "deep_walk_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = ctypes.CDLL(build())
        out.rt_deep_variant.restype = ctypes.c_int
        out.rt_deep_variant.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        _lib = out
    return _lib


def entry_boxes(wide_packed: np.ndarray) -> np.ndarray:
    """The (W,8) f32 entry-box table of a BVH8: row w holds wide node w's
    own box, the child box of w in its parent's row (min3|max3), then 1.0,
    then 0.0.  A node without a parent (the root) has a NaN box and 0.0 in
    column 6: the variants walk it untested."""
    w = wide_packed.shape[0]
    boxes = wide_packed[:, :64].reshape(w, 8, 8)
    codes = boxes[:, :, 6]
    par, slot = np.nonzero(np.isfinite(boxes[:, :, 0]) & (codes > 0))
    child = codes[par, slot].astype(np.int64)
    out = np.full((w, 8), np.nan, np.float32)
    out[:, 6:] = 0.0
    out[child, :6] = boxes[par, slot, :6]
    out[child, 6] = 1.0
    return out


def run(variant: str, nodes, leaf_rows, origin, direction, tmax0, max_recs,
        anyhit=False, deep_e=0, entries=None, packet_size=0,
        entry_box=None):
    """One launch of ``variant`` with ``packet_traverse_wide``'s DEEP
    arguments (as ``_deep_round`` passes them) and, for the variants of
    :data:`BOXED`, the table of :func:`entry_boxes` on the card:
    ``(dst, prim)``."""
    if variant in BOXED and entry_box is None:
        raise ValueError(f"{variant} reads the entry-box table")
    n = origin.shape[0]
    dst = torch.empty(n, dtype=torch.float32, device=origin.device)
    prim = torch.empty(n, dtype=torch.int32, device=origin.device)
    if n:
        err = lib().rt_deep_variant(
            VARIANTS.index(variant), int(anyhit), 2 if max_recs > 8 else 1,
            nodes.data_ptr(), leaf_rows.data_ptr(),
            None if entry_box is None else entry_box.data_ptr(),
            entries.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            tmax0.data_ptr(), dst.data_ptr(), prim.data_ptr(), n,
            entries.shape[1], packet_size,
            torch.cuda.current_stream(origin.device).cuda_stream)
        if err:
            raise RuntimeError(f"DEEP variant {variant}: CUDA error {err}")
    return dst, prim


@contextlib.contextmanager
def _recorded():
    calls = []
    fn = packet.packet_traverse_wide

    def record(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    packet.packet_traverse_wide = record
    try:
        yield calls
    finally:
        packet.packet_traverse_wide = fn


def route_deep_calls(sc, o, d, tmax, anyhit=False):
    """The two DEEP launches (rounds 1 and 2) that the two-phase route makes
    for one ray set, as [(args, kw)] of ``packet_traverse_wide``."""
    with _recorded() as calls:
        traverse._two_phase_wide(sc, o, d, tmax, Routing(two_phase=True),
                                 anyhit=anyhit)
    torch.cuda.synchronize()
    deep = [c for c in calls if c[1].get("entries") is not None]
    if len(deep) != 2:
        raise AssertionError(f"the two-phase route made {len(deep)} DEEP "
                             "launches, not 2")
    return deep


def compare(name, got, want):
    """Raise unless ``got`` = (dst, prim) equals ``want`` bit for bit."""
    for what, a, b in zip(("dst", "prim"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs")


def compare_near(name, got, want, leaf_map):
    """Raise unless ``got`` = (dst, prim) of a walk in another entry order
    holds ``want``'s: hit masks equal, and dst and the hit triangle equal
    on all but fewer than 1e-3 of the lanes.  On an SBVH scene the walks
    may differ there beyond rounding: a leaf holds triangles clipped to its
    box, and a ray can meet one of them outside that box, so a walk finds
    that hit through this leaf only while its best lies beyond the box,
    which depends on the order.  Returns the share of lanes whose dst
    differs and of those whose dst is equal but triangle not (a tie)."""
    (dst, prim), (wdst, wprim) = got, want
    if not torch.equal(prim >= 0, wprim >= 0):
        raise AssertionError(f"{name}: hit masks differ")
    off = dst != wdst
    tri = leaf_map[prim.clamp(min=0).long()]
    wtri = leaf_map[wprim.clamp(min=0).long()]
    shares = dict(dst=float(off.float().mean()),
                  ties=float(((prim >= 0) & ~off & (tri != wtri))
                             .float().mean()))
    if max(shares.values()) >= 1e-3:
        raise AssertionError(f"{name}: differs on too many lanes {shares}")
    return shares
