"""Build and launch tools/packet_walk_variants.cu: the packet walk from the
root before its redesign ("old": walk_kernel's loop) and group_walk_kernel,
which replaced it, at other register pins and in the while-while order.
chip_smoke.py, tools/measure_packet_walk.py, tools/measure_group_walk.py
and the GPU tests import it; the package does not.

Every variant takes the arguments of ``kernels/packet.py::
packet_traverse_wide``'s walk from the root (nodes, leaf_rows, origin,
direction, tmax0, max_recs, anyhit) and returns ``(dst, prim)``.
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
                   "packet_walk_variants.cu")
# rt_packet_variant's variant ids, in order
VARIANTS = ("old", "regs_free", "regs72", "regs64", "regs56", "regs48",
            "while_while")

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per source hash, the included library's
    text with it); return the path."""
    return build_shared(SRC, "packet_walk_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = ctypes.CDLL(build())
        out.rt_packet_variant.restype = ctypes.c_int
        out.rt_packet_variant.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + [ctypes.c_int]
            + [ctypes.c_void_p])
        _lib = out
    return _lib


def run(variant: str, nodes, leaf_rows, origin, direction, tmax0,
        max_recs: int, anyhit: bool = False):
    """One launch of ``variant`` over ``max_recs``-record leaf slots (16:
    two rows): ``(dst, prim)``."""
    n = origin.shape[0]
    dst = torch.empty(n, dtype=torch.float32, device=origin.device)
    prim = torch.empty(n, dtype=torch.int32, device=origin.device)
    if n:
        err = lib().rt_packet_variant(
            VARIANTS.index(variant), int(anyhit), 2 if max_recs > 8 else 1,
            nodes.data_ptr(), leaf_rows.data_ptr(), origin.data_ptr(),
            direction.data_ptr(), tmax0.data_ptr(), dst.data_ptr(),
            prim.data_ptr(), n,
            torch.cuda.current_stream(origin.device).cuda_stream)
        if err:
            raise RuntimeError(f"packet walk variant {variant}: CUDA error "
                               f"{err}")
    return dst, prim


def compare(name, got, want):
    """Raise unless ``got`` = (dst, prim) equals ``want`` bit for bit."""
    for what, a, b in zip(("dst", "prim"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
