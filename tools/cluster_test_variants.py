"""Build and launch tools/cluster_test_variants.cu: the cluster route's
chunk kernels before their redesign, and the shipped kernels' walk at other
settings.  chip_smoke.py, tools/measure_cluster_test.py and
tests/test_torch_gpu.py import it; the package does not.

Every variant takes the shipped entry points' arguments
(``kernels/cluster.py``), counts included, and returns what the shipped
wrapper returns.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
from typing import Optional

import torch

from ray_tracer_tpu_torch import Routing
from ray_tracer_tpu_torch.kernels import cluster
from ray_tracer_tpu_torch.kernels.bvh8 import NVCC_FLAGS
from ray_tracer_tpu_torch.native_build import build_shared, nvcc_path
from ray_tracer_tpu_torch.ops import cluster_trace

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "cluster_test_variants.cu")
# variant ids of rt_*_variant, in order: the old kernels, then the walk
# at (chunks per tile, most blocks per SM); tile1 is the shipped walk
VARIANTS = ("old", "tile1", "tile2", "tile4", "tile8", "tile16", "blocks4",
            "blocks6")
# "shipped" launches this library's copy of the shipped entry points
# (rt_cluster_pairs, rt_box_hits) the same way, for timing in turns

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the variants (once per source hash); return the path."""
    # the variants include the shipped source: its text keys the build too
    with open(cluster._SRC, "rb") as f:
        shipped = hashlib.sha256(f.read()).hexdigest()[:16]
    return build_shared(SRC, "cluster_test_variants",
                        (nvcc_path(), *NVCC_FLAGS,
                         f"-DSHIPPED_SOURCE_{shipped}"))


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        out = cluster.bind(build())
        for name in ("cluster_pairs", "box_hits"):
            fn = getattr(out, f"rt_{name}_variant")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] + getattr(out, f"rt_{name}").argtypes
        _lib = out
    return _lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _entry(name: str, variant: str):
    if variant == "shipped":
        return getattr(lib(), f"rt_{name}")
    fn = getattr(lib(), f"rt_{name}_variant")
    return lambda *args: fn(VARIANTS.index(variant), *args)


def cluster_pairs(variant: str, pages, feats, cid, count, t_c):
    g = feats.shape[0]
    t = torch.empty((g, 128), dtype=torch.float32, device=feats.device)
    p = torch.empty((g, 128), dtype=torch.int32, device=feats.device)
    if g:
        err = _entry("cluster_pairs", variant)(
            pages.data_ptr(), feats.data_ptr(), cid.data_ptr(),
            count.data_ptr(), t.data_ptr(), p.data_ptr(), g, t_c,
            _stream(feats))
        if err:
            raise RuntimeError(f"cluster pairs {variant}: CUDA error {err}")
    return t, p


def box_hits(variant: str, pages, feats, pid, count):
    g = feats.shape[0]
    words = torch.empty((g, 4, 128), dtype=torch.int32, device=feats.device)
    if g:
        err = _entry("box_hits", variant)(
            pages.data_ptr(), feats.data_ptr(), pid.data_ptr(),
            count.data_ptr(), words.data_ptr(), g, _stream(feats))
        if err:
            raise RuntimeError(f"box hits {variant}: CUDA error {err}")
    return words


@contextlib.contextmanager
def _recorded(name):
    calls = []
    fn = getattr(cluster, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(cluster, name, record)
    try:
        yield calls
    finally:
        setattr(cluster, name, fn)


def route_chunks(sc, o, d, tmax, anyhit=False):
    """Every chunk-kernel call of both cluster routes on one ray set, as
    [(kernel, slice, args)]: ``cluster_pairs`` with (pages, feats, cid,
    count, t_c), ``box_hits_1`` and ``box_hits_2`` with (pages, feats,
    pid, count)."""
    out = []
    for routing, name in ((Routing(cluster="on"), "cluster_pairs_test"),
                          (Routing(cluster="on", cluster_enum="boxes"),
                           "box_hits")):
        with _recorded(name) as calls:
            cluster_trace.cluster_traverse(sc, o, d, tmax, routing,
                                           anyhit=anyhit)
        for k, (args, kw) in enumerate(calls):
            if name == "cluster_pairs_test":
                out.append(("cluster_pairs", k, (*args, kw["t_c"])))
            else:  # level 1 and level 2 alternate, slice by slice
                out.append((f"box_hits_{k % 2 + 1}", k // 2, args))
    torch.cuda.synchronize()
    return out
