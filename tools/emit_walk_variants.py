"""Build and launch tools/emit_walk_variants.cu: the cluster enumeration
walk before its redesign ("old": walk_kernel's emit mode), and
emit_walk_kernel, which replaced it, with each design element switched.
chip_smoke.py, tools/measure_emit_walk.py and the GPU tests import it; the
package does not.

Every variant takes the arguments of the shipped emit launch
(``kernels/bvh8.py::launch_emit``: nodes, origin, direction, tmax0,
top_k) and returns ``(slots, ovf)``.  Launching needs a CUDA device;
imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ray_tracer_tpu_torch.kernels import bvh8
from ray_tracer_tpu_torch.native_build import build_shared, nvcc_path

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "emit_walk_variants.cu")
# rt_emit_variant's variant ids, in order: old, the design replaced;
# shipped_copy, emit_walk_kernel as it ships; then one element switched
# off each (rows_in_place: no shared-memory staging; none: all off)
VARIANTS = ("old", "shipped_copy", "fminf_select_minmax", "stack_local",
            "push_ids", "rows_in_place", "regs_free", "regs64", "regs48",
            "regs40", "none")

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per hash of their source and of the
    shipped source they include); return the path."""
    return build_shared(SRC, "emit_walk_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = ctypes.CDLL(build())
        out.rt_emit_variant.restype = ctypes.c_int
        out.rt_emit_variant.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        _lib = out
    return _lib


def run(variant: str, nodes, origin, direction, tmax0, top_k: int):
    """One launch of ``variant``: ``(slots, ovf)``, (N, top_k) and (N,)
    i32."""
    n = origin.shape[0]
    dev = origin.device
    slots = torch.empty((n, top_k), dtype=torch.int32, device=dev)
    ovf = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        err = lib().rt_emit_variant(
            VARIANTS.index(variant), nodes.data_ptr(), origin.data_ptr(),
            direction.data_ptr(), tmax0.data_ptr(), slots.data_ptr(),
            ovf.data_ptr(), n, top_k,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"emit walk variant {variant}: CUDA error "
                               f"{err}")
    return slots, ovf


def compare(name, got, want):
    """Raise unless ``got`` = (slots, ovf) equals ``want`` bit for bit."""
    for what, a, b in zip(("slots", "ovf"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
