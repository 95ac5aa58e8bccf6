"""Build and launch tools/shade_round_variants.cu: the wavefront round's
kernels before their redesigns ("old") and the shipped kernels with each
design element switched.  chip_smoke.py, tools/measure_shade_round.py,
tools/measure_permute.py and the GPU tests import it; the package does
not.

Every shade variant takes ``kernels/shade.py::shade_round``'s arguments
(the round's context and wave) and returns its three outputs ``(packed,
key, tally)``, the split layout's rows (``old``, ``split``) converted to
the 40-word rows.  Every permute variant takes ``permute_rows``'s
arguments and returns its ``Lanes`` (FLOORS: the gathered rows).  The
old NEE kernel takes ``nee_resolve``'s.  Launching needs a CUDA device;
imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ray_tracer_tpu_torch.integrator import shading
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
# form's stores and its register cap; split: the split layout, 34 f32 and
# 6 i32 words a lane in two tiles, the kernel before the 40-word row)
VARIANTS = ("old", "shipped_copy", "vector", "in_place", "eager",
            "persistent", "blocks3", "blocks5", "regs_free",
            "in_place_blocks3", "split")
SPLIT = ("old", "split")  # the shade variants that write the split layout
# rt_permute_variant's ids, in order: old, the first form (split layout);
# floor_tma: the rows gathered into a contiguous copy by the TMA engine,
# in and out, nothing unpacked (the yardstick of a gather of these bytes)
PERMUTES = ("old", "floor_tma")
FLOORS = ("floor_tma",)  # the variants that only gather the rows

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
        out.rt_permute_variant.restype = ctypes.c_int
        out.rt_permute_variant.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8
            + [ctypes.c_int, ctypes.c_void_p])
        out.rt_permute_variant_info.restype = ctypes.c_int
        out.rt_permute_variant_info.argtypes = (
            [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4)
        out.rt_old_nee.restype = ctypes.c_int
        out.rt_old_nee.argtypes = [ctypes.POINTER(shade._NeeArgs),
                                   ctypes.c_void_p]
        _lib = out
    return _lib


def split_offset(n: int) -> int:
    """The first word of the split layout's i32 rows in its buffer
    (``split_offset`` of the source)."""
    return (shading.PACKED_F * n + 3) & ~3


def split_rows(n: int, buf) -> torch.Tensor:
    """The (N,40) rows of a split-layout buffer: its f32 rows, then its
    i32 rows' bits."""
    f = buf[:shading.PACKED_F * n].view(n, shading.PACKED_F)
    i = buf[split_offset(n):split_offset(n) + shading.PACKED_I * n]
    return torch.cat([f, i.view(n, shading.PACKED_I)], 1)


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launcher(variant: str, c, w):
    """``(launch, outputs)``: ``launch()`` runs ``variant`` (a name of
    VARIANTS, or "shipped": shade_kernel through the package's own
    library) once on the wave ``w``, its arguments checked and packed
    once, so a launch costs no wrapper time; the launches add into one
    ``tally``.  ``outputs``: ``(packed, key, tally)``, ``packed`` the
    split layout's flat buffer for the variants of SPLIT (see
    :func:`rows`)."""
    args, out = shade.shade_args(c, w)
    stream = torch.cuda.current_stream(w.origin.device).cuda_stream
    if variant in SPLIT:
        n = w.origin.shape[0]
        buf = torch.empty(split_offset(n) + shading.PACKED_I * n,
                          dtype=torch.float32, device=w.origin.device)
        args.packed = buf.data_ptr()
        out = (buf, *out[1:])
    ref = ctypes.byref(args)
    if variant == "shipped":
        call = lambda: shade._load().rt_shade_round(ref, stream)
    else:
        index = VARIANTS.index(variant)
        call = lambda: lib().rt_shade_variant(index, ref, stream)

    def launch():
        _check(call(), f"shade variant {variant}")

    launch.keep = (c, w, args, out)  # what the addresses point into
    return launch, out


def rows(variant: str, out):
    """``launcher``'s outputs as ``(packed, key, tally)`` with (N,40)
    rows."""
    if variant not in SPLIT:
        return out
    return (split_rows(out[1].shape[0], out[0]), *out[1:])


def run(variant: str, c, w):
    """One launch of ``variant``: ``(packed, key, tally)``."""
    launch, out = launcher(variant, c, w)
    launch()
    return rows(variant, out)


def _info(fn, index: int, what: str) -> dict:
    vals = [ctypes.c_int() for _ in range(4)]
    _check(fn(index, *map(ctypes.byref, vals)), what)
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "shared_bytes"), (v.value for v in vals)))


def info(variant: str) -> dict:
    """The variant's (or "shipped": shade_kernel's) blocks per SM,
    registers a thread, local and static shared memory bytes, as the CUDA
    runtime reports them."""
    index = -1 if variant == "shipped" else VARIANTS.index(variant)
    return _info(lib().rt_shade_variant_info, index,
                 f"shade variant {variant}")


def permute_info(variant: str) -> dict:
    """``info`` of a permute variant (or "shipped": permute_kernel)."""
    index = -1 if variant == "shipped" else PERMUTES.index(variant)
    return _info(lib().rt_permute_variant_info, index,
                 f"permute variant {variant}")


def compare(name, got, want):
    """Raise unless the outputs ``got`` equal ``want`` bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} outputs, not {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        if a.is_floating_point():
            a, b = (x.contiguous().view(torch.int32) for x in (a, b))
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{name}: output {k} differs")


def permute_launcher(variant: str, packed, order, skey):
    """``(launch, result)`` of permute variant ``variant`` (a name of
    PERMUTES, or "shipped": permute_kernel through the package's library)
    on the (N,40) rows ``packed``, ``order`` and the sorted keys ``skey``,
    its outputs allocated once ("old" reads the rows split into their two
    arrays first; "shipped" counts the keys' runs into a scratch word, as
    the round does into its tally; the others do not read the keys):
    ``result()`` is the ``Lanes`` of the outputs (FLOORS: the gathered
    rows)."""
    n, dev = packed.shape[0], packed.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = shade.permute_outputs(n, dev)
    runs = torch.zeros(1, dtype=torch.int64, device=dev)
    rows_out = torch.empty((n, shading.ROW), dtype=torch.float32,
                           device=dev) if variant in FLOORS else None
    src = (packed, None)
    if variant == "old":
        src = (packed[:, :shading.PACKED_F].contiguous(),
               packed[:, shading.PACKED_F:].contiguous())
    ptrs = [None if t is None else t.data_ptr()
            for t in (*src, order, *outs, rows_out)]
    if variant == "shipped":
        call = lambda: shade._load().rt_permute_rows(
            ptrs[0], *ptrs[2:7], skey.data_ptr(), runs.data_ptr(), n,
            stream)
    else:
        index = PERMUTES.index(variant)
        call = lambda: lib().rt_permute_variant(index, *ptrs, n, stream)

    def launch():
        _check(call(), f"permute variant {variant}")

    launch.keep = (packed, order, skey, runs, src, outs, rows_out)
    if variant in FLOORS:
        return launch, lambda: rows_out
    return launch, lambda: shade.permute_lanes(*outs)


def permute_run(variant: str, packed, order, skey):
    """One launch of permute variant ``variant``: its ``Lanes`` (FLOORS:
    the gathered rows)."""
    launch, result = permute_launcher(variant, packed, order, skey)
    launch()
    return result()


def nee_launcher(variant: str, scene, lanes, occluded):
    """``(launch, direct)`` of the NEE kernel ``variant`` ("shipped":
    nee_resolve_kernel through the package's library; "old": the first
    form) on ``nee_resolve``'s arguments, packed once."""
    args, direct = shade.nee_args(scene, lanes, occluded)
    stream = torch.cuda.current_stream(direct.device).cuda_stream
    ref = ctypes.byref(args)
    fn = {"shipped": lambda: shade._load().rt_nee_resolve,
          "old": lambda: lib().rt_old_nee}[variant]

    def launch():
        if args.n:
            _check(fn()(ref, stream), f"NEE kernel {variant}")

    launch.keep = (scene, lanes, occluded, args, direct)
    return launch, direct


def nee_run(variant: str, scene, lanes, occluded):
    """One launch of the NEE kernel ``variant``: the next ``direct``."""
    launch, direct = nee_launcher(variant, scene, lanes, occluded)
    launch()
    return direct
