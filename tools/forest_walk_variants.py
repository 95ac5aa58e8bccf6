"""Build and launch tools/forest_walk_variants.cu: the forest walk before
the cull ("old") and forest_walk_kernel's design variants (the .cu's
header says what each is and what it measured).  chip_smoke.py,
tools/measure_forest_walk.py and the GPU tests import it; the package does
not.

Every variant takes ``kernels/packet.py::forest_traverse``'s arguments
(bvh_packed, bvh_axis, tri_packed, inv_transform, roots, words, cull,
origin, direction, tmax0; ``cull`` the scene's chunk trees) and returns
what it returns; the flat variants also take the per-instance world boxes
(``rows``: ``meta["forest_cull"]`` as a tensor on the card).  Launching
needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ray_tracer_tpu_torch.kernels import bvh8
from ray_tracer_tpu_torch.native_build import build_shared, nvcc_path

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "forest_walk_variants.cu")
# rt_forest_variant's variant ids, in order; the flat ones read the
# per-instance rows
VARIANTS = ("old", "flat_best", "flat", "blocks6_flat", "flat_mask",
            "tree_shared", "shipped_copy", "blocks6")
FLAT = ("flat_best", "flat", "blocks6_flat", "flat_mask")

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per source hash, the included kernel's
    text with it); return the path."""
    return build_shared(SRC, "forest_walk_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = ctypes.CDLL(build())
        out.rt_forest_variant.restype = ctypes.c_int
        out.rt_forest_variant.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int]
            + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
        _lib = out
    return _lib


def run(variant: str, bvh_packed, bvh_axis, tri_packed, inv_transform,
        roots, words, cull, origin, direction, tmax0, anyhit: bool = False,
        rows=None):
    """One launch of ``variant``: what ``packet.forest_traverse`` returns.
    ``rows``: the (K,8) world boxes on the card (the flat variants')."""
    if variant in FLAT:
        if rows is None:
            raise ValueError(f"the {variant} variant needs the rows")
        cull = rows
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
        err = lib().rt_forest_variant(
            VARIANTS.index(variant), bvh_packed.data_ptr(),
            bvh_axis.data_ptr(), tri_packed.data_ptr(),
            inv_transform.data_ptr(), roots.data_ptr(), words.data_ptr(),
            cull.data_ptr(), inv_transform.shape[0], origin.data_ptr(),
            direction.data_ptr(), tmax0.data_ptr(), int(anyhit), *ptrs, n,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"forest walk variant {variant}: CUDA error "
                               f"{err}")
    return out[0] if anyhit else out


def scene_rows(sc):
    """The scene's per-instance world boxes (``meta["forest_cull"]``) as a
    (K,8) f32 tensor on its device, the flat variants' ``rows``."""
    return torch.tensor(sc.meta["forest_cull"], dtype=torch.float32).reshape(
        -1, 8).to(sc.device)


def compare(name, got, want):
    """Raise unless the outputs ``got`` equal ``want`` bit for bit."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for k, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: output {k} differs")
