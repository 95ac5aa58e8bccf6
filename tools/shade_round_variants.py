"""Build and launch tools/shade_round_variants.cu: the wavefront round's
shade kernel before its redesign ("old") and shade_kernel with each
design element switched.  chip_smoke.py, tools/measure_shade_round.py and
the GPU tests import it; the package does not.

Every variant takes ``kernels/shade.py::shade_round``'s arguments (the
round's context and wave) and returns its four outputs ``(packed,
packed_i, key, tally)``.  Launching needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ray_tracer_tpu_torch.kernels import bvh8, shade
from ray_tracer_tpu_torch.native_build import build_shared, nvcc_path

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "shade_round_variants.cu")
# rt_shade_variant's variant ids, in order: old, the design replaced;
# shipped_copy, shade_kernel as it ships; then one element switched each
# (vector: the tiles copied out by the block's threads, not by TMA;
# in_place: rows written in place, not staged; eager: every lane computes
# the sky, the lobes and the camera ray; persistent: a grid that fits the
# card at once, each block looping over tiles; blocksN / regs_free:
# __launch_bounds__(256, N) / (256, 1); in_place_blocks3: both the first
# form's stores and its register cap)
VARIANTS = ("old", "shipped_copy", "vector", "in_place", "eager",
            "persistent", "blocks3", "blocks5", "regs_free",
            "in_place_blocks3")

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per hash of their source and of the
    shipped source they include); return the path."""
    return build_shared(SRC, "shade_round_variants",
                        (nvcc_path(), *bvh8.NVCC_FLAGS))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = ctypes.CDLL(build())
        out.rt_shade_variant.restype = ctypes.c_int
        out.rt_shade_variant.argtypes = [
            ctypes.c_int, ctypes.POINTER(shade._ShadeArgs), ctypes.c_void_p]
        out.rt_shade_variant_info.restype = ctypes.c_int
        out.rt_shade_variant_info.argtypes = (
            [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4)
        _lib = out
    return _lib


def launcher(variant: str, c, w):
    """``(launch, outputs)``: ``launch()`` runs ``variant`` (a name of
    VARIANTS, or "shipped": shade_kernel through the package's own
    library) once on the wave ``w``, its arguments checked and packed
    once, so a launch costs no wrapper time; the launches add into one
    ``tally``.  ``outputs``: ``(packed, packed_i, key, tally)``."""
    args, out = shade.shade_args(c, w)
    stream = torch.cuda.current_stream(w.origin.device).cuda_stream
    ref = ctypes.byref(args)
    if variant == "shipped":
        call = lambda: shade._load().rt_shade_round(ref, stream)
    else:
        index = VARIANTS.index(variant)
        call = lambda: lib().rt_shade_variant(index, ref, stream)

    def launch():
        err = call()
        if err:
            raise RuntimeError(f"shade variant {variant}: CUDA error {err}")

    launch.keep = (c, w, args, out)  # what the addresses point into
    return launch, out


def run(variant: str, c, w):
    """One launch of ``variant``: ``(packed, packed_i, key, tally)``."""
    launch, out = launcher(variant, c, w)
    launch()
    return out


def info(variant: str) -> dict:
    """The variant's (or "shipped": shade_kernel's) blocks per SM,
    registers a thread, local and static shared memory bytes, as the CUDA
    runtime reports them."""
    vals = [ctypes.c_int() for _ in range(4)]
    index = -1 if variant == "shipped" else VARIANTS.index(variant)
    err = lib().rt_shade_variant_info(index, *map(ctypes.byref, vals))
    if err:
        raise RuntimeError(f"shade variant {variant}: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "shared_bytes"), (v.value for v in vals)))


def compare(name, got, want):
    """Raise unless the four outputs ``got`` equal ``want`` bit for bit."""
    for what, a, b in zip(("packed", "packed_i", "key", "tally"), got, want):
        if a.is_floating_point():
            a, b = (x.contiguous().view(torch.int32) for x in (a, b))
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {what} differs")
