"""Build and launch tools/top_walk_variants.cu: the TOP walk of two-phase
treelet traversal before its redesign ("old": walk_kernel's TOP mode over
the (W,128) rows and the troot flags), and top_walk_kernel, which replaced
it, with each design element switched.  chip_smoke.py,
tools/measure_top_walk.py and the GPU tests import it; the package does
not.

Every variant takes the arguments of the shipped TOP launch
(``kernels/packet.py::packet_traverse_wide`` with ``top_k``: the scene's
``wide_packed``, ``wide_troot`` and ``wide_top``, leaf_rows, origin,
direction, tmax0, max_recs, top_k, anyhit) and returns ``(dst, prim,
slots, ovf)``.  Only "old" takes two-row slots.  Launching needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ray_tracer_tpu_torch.kernels import bvh8
from ray_tracer_tpu_torch.native_build import build_shared, nvcc_path

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "top_walk_variants.cu")
# rt_top_variant's variant ids, in order: old, the design replaced;
# shipped_copy, top_walk_kernel as it ships; then one element switched
# each (troot_gathers: the (W,128) rows and a troot flag load per interior
# child, no TOP table; stack96: kStack words; rows_in_place: no staging;
# regs*: other register pins; smem_table: the TOP table read from shared
# memory; none: all off)
VARIANTS = ("old", "shipped_copy", "troot_gathers", "fminf_select_minmax",
            "every_record", "stack_local", "stack96", "rows_in_place",
            "regs_free", "regs72", "regs56", "regs48", "smem_table", "none")

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per hash of their source and of the
    headers and shipped source they include); return the path."""
    return build_shared(SRC, "top_walk_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = ctypes.CDLL(build())
        out.rt_top_variant.restype = ctypes.c_int
        out.rt_top_variant.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
            + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        _lib = out
    return _lib


def run(variant: str, nodes, troot, top, leaf_rows, origin, direction,
        tmax0, max_recs: int, top_k: int, anyhit: bool = False):
    """One launch of ``variant`` over ``max_recs``-record leaf slots (16:
    two rows, "old" only): ``(dst, prim, slots, ovf)``."""
    n = origin.shape[0]
    dev = origin.device
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    slots = torch.empty((n, top_k), dtype=torch.int32, device=dev)
    ovf = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        err = lib().rt_top_variant(
            VARIANTS.index(variant), int(anyhit), 2 if max_recs > 8 else 1,
            nodes.data_ptr(), troot.data_ptr(), top.data_ptr(),
            top.shape[0], leaf_rows.data_ptr(), origin.data_ptr(),
            direction.data_ptr(), tmax0.data_ptr(), dst.data_ptr(),
            prim.data_ptr(), slots.data_ptr(), ovf.data_ptr(), n, top_k,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"TOP walk variant {variant}: CUDA error "
                               f"{err}")
    return dst, prim, slots, ovf


def scene_args(sc):
    """The tables a variant reads, from a compiled scene: ``(nodes, troot,
    top, leaf_rows)``."""
    return sc.wide_packed, sc.wide_troot, sc.wide_top, sc.leaf_rows


def compare(name, got, want):
    """Raise unless ``got`` = (dst, prim, slots, ovf) equals ``want`` bit
    for bit."""
    for what, a, b in zip(("dst", "prim", "slots", "ovf"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
