"""Build and launch tools/narrow_walk_variants.cu: the narrow walk before
its redesign ("old") and bvh2_walk_kernel with each design element
switched.  chip_smoke.py, tools/measure_narrow_walk.py and the GPU tests
import it; the package does not.

Every variant takes ``kernels/packet.py::packet_traverse``'s arguments
(bvh_packed, bvh_axis, tri_packed, origin, direction, tmax0, root,
root_word) and returns its five outputs ``(dst, prim, u, v, front)``.
Launching needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ray_tracer_tpu_torch.kernels import bvh8
from ray_tracer_tpu_torch.native_build import build_shared, nvcc_path

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "narrow_walk_variants.cu")
# rt_narrow_variant's variant ids, in order: shipped_copy is
# bvh2_walk_kernel as it ships; "none" switches off the while-while order,
# the node word, the near child in a register and PTX min/max together;
# old is the design it replaced
VARIANTS = ("shipped_copy", "single_loop", "reload_on_pop", "two_words",
            "push_both", "fminf_select_minmax", "none", "regs_free",
            "regs80", "regs64", "regs56", "regs48", "regs40", "old")

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per source hash, the included kernel's
    text with it); return the path."""
    return build_shared(SRC, "narrow_walk_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = ctypes.CDLL(build())
        out.rt_narrow_variant.restype = ctypes.c_int
        out.rt_narrow_variant.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_uint] + [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_void_p])
        _lib = out
    return _lib


def run(variant: str, bvh_packed, bvh_axis, tri_packed, origin, direction,
        tmax0, root: int, root_word: int):
    """One launch of ``variant``: ``(dst, prim, u, v, front)``."""
    n = origin.shape[0]
    dev = origin.device
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    front = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        err = lib().rt_narrow_variant(
            VARIANTS.index(variant), bvh_packed.data_ptr(),
            bvh_axis.data_ptr(), tri_packed.data_ptr(), origin.data_ptr(),
            direction.data_ptr(), tmax0.data_ptr(), root, root_word,
            dst.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            front.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"narrow walk variant {variant}: CUDA error "
                               f"{err}")
    return dst, prim, u, v, front


def compare(name, got, want):
    """Raise unless the five outputs ``got`` equal ``want`` bit for bit."""
    for what, a, b in zip(("dst", "prim", "u", "v", "front"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
