"""Cluster-route chunk kernels: ray x triangle-cluster and ray x box-page.

``cluster_pairs_test`` and ``box_hits`` are the ports of
``ray_tracer_tpu/kernels/cluster.py``'s ``_cluster_kernel`` and
``_box_kernel``.  On CUDA tensors they launch ``csrc/cluster_test.cu``
(built with ``nvcc`` at first use); on CPU tensors they run their plain
torch versions.  Nothing falls back: a CUDA tensor that a kernel cannot
take raises.

Both take 128-lane chunks: ``feats`` (G,16,128) holds each chunk's ray
features (:func:`ray_features` rows, transposed), and each chunk names
one page (-1: a dead chunk, which reports no hit).  The JAX kernels
contract the page against the chunk in one ``Precision.HIGHEST`` matrix
product; here both versions write that contraction out as sums in a
fixed row order (never ``torch.matmul``, whose order is not the kernel's
and which TF32 may touch), so on the card they agree bit for bit.

``extract_slots`` and ``ray_features`` are plain torch, as in the JAX
package, where they run outside any kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..native_build import build_shared, nvcc_path
from .bvh8 import CSRC, NVCC_FLAGS, check_tensors

BIG = 99999999.0
N_BLOCKS = 5  # T | B | U | V | FO blocks per page (accel/cluster.py)
BOX_COLS = 6 * 128  # t1x|t2x|t1y|t2y|t1z|t2z blocks of 128 boxes
# Chunks per step of the plain versions: bounds their (chunks, columns,
# 128) intermediates.
PLAIN_BATCH = 64

_SRC = f"{CSRC}/cluster_test.cu"

# Kernel launches per kernel since the last reset (the CPU path never adds).
launches = {"cluster_pairs": 0, "box_hits": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build() -> str:
    """Compile the kernel library (once per source hash); return its path."""
    return build_shared(_SRC, "cluster_test", (nvcc_path(), *NVCC_FLAGS))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.rt_cluster_pairs.restype = ctypes.c_int
        lib.rt_cluster_pairs.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rt_box_hits.restype = ctypes.c_int
        lib.rt_box_hits.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def _check_chunks(pages, cols, feats, chunk_page) -> None:
    g = feats.shape[0]
    dev = feats.device
    check_tensors(dev, torch.float32,
                  pages=(pages, (pages.shape[0], 16, cols)),
                  feats=(feats, (g, 16, 128)))
    check_tensors(dev, torch.int32, chunk_page=(chunk_page, (g,)))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no cluster kernel for device {dev}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def cluster_pairs_test(clus_mt, feats, chunk_cid, t_c: int = 128):
    """Test every chunk's 128 ray-feature lanes against its cluster.

    Returns ``(t, prim_local)`` of shape (G,128): the closest accepted hit
    distance (BIG if none) and the winning triangle's index *within the
    cluster*, the lowest on an exact tie (-1 if none).
    """
    if t_c < 1 or t_c > 512:
        raise ValueError(f"t_c must be in 1..512, got {t_c}")
    _check_chunks(clus_mt, N_BLOCKS * t_c, feats, chunk_cid)
    if feats.device.type == "cpu":
        return cluster_pairs_test_reference(clus_mt, feats, chunk_cid, t_c)
    g = feats.shape[0]
    t = torch.empty((g, 128), dtype=torch.float32, device=feats.device)
    p = torch.empty((g, 128), dtype=torch.int32, device=feats.device)
    if g == 0:
        return t, p
    err = _load().rt_cluster_pairs(
        clus_mt.data_ptr(), feats.data_ptr(), chunk_cid.data_ptr(),
        t.data_ptr(), p.data_ptr(), g, t_c,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    _raise_on(err, "cluster pairs")
    launches["cluster_pairs"] += 1
    return t, p


def cluster_pairs_test_reference(clus_mt, feats, chunk_cid, t_c: int = 128):
    """The kernel's arithmetic in plain torch, PLAIN_BATCH chunks a step."""
    g = feats.shape[0]
    dev = feats.device
    t_out = torch.full((g, 128), BIG, dtype=torch.float32, device=dev)
    p_out = torch.full((g, 128), -1, dtype=torch.int32, device=dev)
    live = (chunk_cid >= 0).nonzero().squeeze(1)
    ids = torch.arange(t_c, device=dev)[:, None]
    for s in range(0, live.numel(), PLAIN_BATCH):
        gi = live[s : s + PLAIN_BATCH]
        page = clus_mt[chunk_cid[gi].long()]  # (b,16,5*t_c)
        fr = feats[gi]  # (b,16,128)
        o = fr[:, 0:3] - page[:, 10:13, 0:1]  # cluster-local origin
        d = fr[:, 3:6]
        c = torch.stack([
            o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
            o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
            o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0],
        ], dim=1)
        f = torch.cat([o, d, c, fr[:, 9:16]], dim=1)  # (b,16,128)
        acc = torch.zeros((gi.numel(), N_BLOCKS * t_c, 128),
                          dtype=torch.float32, device=dev)
        for r in range(16):  # the kernel's row order
            acc = acc + page[:, r, :, None] * f[:, r, None, :]
        T, B, U, V, FO = acc.split(t_c, dim=1)
        rb = 1.0 / B
        t = T * rb
        u = U * rb
        v = V * rb
        w = 1.0 - u - v
        front = B >= 1e-8
        ok = (t >= 0) & (u >= 0) & (v >= 0) & (w >= 0)
        ok = ok & ~((~front) & (FO > 0.5))
        tt = torch.where(ok, t, BIG)
        tmin = tt.amin(dim=1)
        first = torch.where(tt == tmin[:, None], ids, t_c).amin(dim=1)
        t_out[gi] = tmin
        p_out[gi] = torch.where(tmin < BIG, first, -1).to(torch.int32)
    return t_out, p_out


def box_hits(pages, feats, chunk_pid):
    """Slab test of each chunk's 128 rays against its page's <= 128 boxes:
    (G,4,128) i32 words, bit b of word w set iff the ray enters box 32w+b
    within its tmax (feature row 13)."""
    _check_chunks(pages, BOX_COLS, feats, chunk_pid)
    if feats.device.type == "cpu":
        return box_hits_reference(pages, feats, chunk_pid)
    g = feats.shape[0]
    words = torch.empty((g, 4, 128), dtype=torch.int32, device=feats.device)
    if g == 0:
        return words
    err = _load().rt_box_hits(
        pages.data_ptr(), feats.data_ptr(), chunk_pid.data_ptr(),
        words.data_ptr(), g,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    _raise_on(err, "box hits")
    launches["box_hits"] += 1
    return words


def box_hits_reference(pages, feats, chunk_pid):
    """The kernel's arithmetic in plain torch, PLAIN_BATCH chunks a step."""
    g = feats.shape[0]
    dev = feats.device
    out = torch.zeros((g, 4, 128), dtype=torch.int32, device=dev)
    live = (chunk_pid >= 0).nonzero().squeeze(1)
    weights = (1 << torch.arange(32, device=dev, dtype=torch.int64))
    for s in range(0, live.numel(), PLAIN_BATCH):
        gi = live[s : s + PLAIN_BATCH]
        page = pages[chunk_pid[gi].long()]  # (b,16,768)
        fr = feats[gi]
        iv = 1.0 / fr[:, 3:6]  # (b,3,128)
        oiv = fr[:, 0:3] * iv
        raw = (page[:, 0, :, None] * iv[:, 0, None, :]
               + page[:, 1, :, None] * iv[:, 1, None, :]
               + page[:, 2, :, None] * iv[:, 2, None, :])  # (b,768,128)
        t1x, t2x, t1y, t2y, t1z, t2z = (
            raw[:, k * 128 : (k + 1) * 128] - oiv[:, k // 2, None, :]
            for k in range(6)
        )
        tmin = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.minimum(t1z, t2z))
        tmx = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.maximum(t1z, t2z))
        hit = (tmx >= tmin) & (tmx > 0) & (tmin < fr[:, 13, None, :])
        bits = hit.reshape(-1, 4, 32, 128).long() * weights[:, None]
        words = bits.sum(dim=2)  # (b,4,128) in [0, 2^32)
        out[gi] = (words - (words >= 2**31).long() * 2**32).to(torch.int32)
    return out


def extract_slots(words, k: int):
    """(m,W) i32 bit words -> (slots (m,k) i32 bit indices 32*w + b in
    ascending order, -1 padded; ovf (m,) bool: more than k bits set).
    Bit 31 of a word is the int32 sign bit."""
    W = words.shape[1]
    w = words.long() & 0xFFFFFFFF  # unsigned, exact for bit 31
    cols = torch.arange(W, device=words.device)[None, :]
    slots = []
    for _ in range(k):
        has = w != 0
        first = has.int().argmax(dim=1)  # first word with a set bit
        cur = w.gather(1, first[:, None])[:, 0]
        low = cur & (-cur)
        bit = torch.log2(low.clamp(min=1).double()).round().long()
        slots.append(torch.where(has.any(dim=1), first * 32 + bit, -1))
        w = w & ~torch.where(cols == first[:, None], low[:, None], 0)
    return torch.stack(slots, dim=1).to(torch.int32), (w != 0).any(dim=1)


def ray_features(origin, direction, tmax=None):
    """(N,3),(N,3)[,(N,)] -> (N,16) f32 rows [o | d | 0 | 1 | 0 | tmax@13].

    The o x d rows are computed in the cluster kernel from the
    cluster-local origin; row 13 carries the clip distance for the box
    kernel (zero page rows keep it inert in the cluster test).  The
    zero-direction guard is the traversal kernels'.
    """
    d = torch.where(direction == 0.0, 1e-20, direction)
    n = origin.shape[0]
    z = lambda k: torch.zeros((n, k), dtype=torch.float32,
                              device=origin.device)
    tm = z(1) if tmax is None else tmax.reshape(n, 1)
    return torch.cat([origin, d, z(3), torch.ones_like(tm), z(3), tm, z(2)],
                     dim=1)
