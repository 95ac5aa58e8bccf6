"""Cluster-route chunk kernels: ray x triangle-cluster and ray x box-page.

``cluster_pairs_test`` and ``box_hits`` are the ports of
``ray_tracer_tpu/kernels/cluster.py``'s ``_cluster_kernel`` and
``_box_kernel``.  On CUDA tensors they launch ``csrc/cluster_test.cu``
(built with ``nvcc`` at first use); on CPU tensors they run their plain
torch versions.  Nothing falls back: a CUDA tensor that a kernel cannot
take raises.

Both take 128-lane chunks: ``feats`` (G,16,128) holds each chunk's ray
features (:func:`ray_features` rows, transposed), and each chunk names
one page (-1: a dead chunk, which reports no hit), whose real triangles
or boxes a count tensor gives.  The JAX kernels contract the whole page
against the chunk in one ``Precision.HIGHEST`` matrix product.  Here both
versions compute only the terms whose page entry the builder writes
(``accel/cluster.py``), for the real triangles or boxes, as sums in the
contraction's row order (never ``torch.matmul``, whose order is not the
kernel's and which TF32 may touch): every term left out is an exact zero
times a finite feature, and on the card the two agree bit for bit.

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
# The page entries _mt_pages writes, (row, block) per triangle, in the
# kernel's staging order: T rows 0-2 and 9, B rows 3-5, U and V rows 3-8,
# FO row 9.  Each block's terms sum in row order.
PAIR_ROWS = (0, 1, 2, 9, 3, 4, 5, 3, 4, 5, 6, 7, 8, 3, 4, 5, 6, 7, 8, 9)
PAIR_BLOCKS = (0,) * 4 + (1,) * 3 + (2,) * 6 + (3,) * 6 + (4,)
# _box_page's entries: block k (t1x|t2x|t1y|t2y|t1z|t2z) on axis row k // 2
BOX_ROWS = (0, 0, 1, 1, 2, 2)
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


def bind(path: str) -> ctypes.CDLL:
    """Load a library that exports ``rt_cluster_pairs`` and
    ``rt_box_hits`` and declare their arguments."""
    lib = ctypes.CDLL(path)
    lib.rt_cluster_pairs.restype = ctypes.c_int
    lib.rt_cluster_pairs.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.rt_box_hits.restype = ctypes.c_int
    lib.rt_box_hits.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def _check_chunks(pages, cols, feats, chunk_page, counts) -> None:
    g = feats.shape[0]
    dev = feats.device
    check_tensors(dev, torch.float32,
                  pages=(pages, (pages.shape[0], 16, cols)),
                  feats=(feats, (g, 16, 128)))
    check_tensors(dev, torch.int32, chunk_page=(chunk_page, (g,)),
                  counts=(counts, (pages.shape[0],)))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no cluster kernel for device {dev}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def cluster_pairs_test(clus_mt, feats, chunk_cid, clus_count, t_c: int = 128):
    """Test every chunk's 128 ray-feature lanes against its cluster's
    ``clus_count`` (C,) i32 real triangles.

    Returns ``(t, prim_local)`` of shape (G,128): the closest accepted hit
    distance (BIG if none) and the winning triangle's index *within the
    cluster*, the lowest on an exact tie (-1 if none).
    """
    if t_c < 1 or t_c > 512:
        raise ValueError(f"t_c must be in 1..512, got {t_c}")
    _check_chunks(clus_mt, N_BLOCKS * t_c, feats, chunk_cid, clus_count)
    if feats.device.type == "cpu":
        return cluster_pairs_test_reference(clus_mt, feats, chunk_cid,
                                            clus_count, t_c)
    g = feats.shape[0]
    t = torch.empty((g, 128), dtype=torch.float32, device=feats.device)
    p = torch.empty((g, 128), dtype=torch.int32, device=feats.device)
    if g == 0:
        return t, p
    err = _load().rt_cluster_pairs(
        clus_mt.data_ptr(), feats.data_ptr(), chunk_cid.data_ptr(),
        clus_count.data_ptr(), t.data_ptr(), p.data_ptr(), g, t_c,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    _raise_on(err, "cluster pairs")
    launches["cluster_pairs"] += 1
    return t, p


def cluster_pairs_test_reference(clus_mt, feats, chunk_cid, clus_count,
                                 t_c: int = 128):
    """The kernel's arithmetic in plain torch, PLAIN_BATCH chunks a step:
    the written page entries of the real triangles, each block's terms
    summed in row order."""
    g = feats.shape[0]
    dev = feats.device
    t_out = torch.full((g, 128), BIG, dtype=torch.float32, device=dev)
    p_out = torch.full((g, 128), -1, dtype=torch.int32, device=dev)
    live = (chunk_cid >= 0).nonzero().squeeze(1)
    ids = torch.arange(t_c, device=dev)[:, None]
    rows = torch.tensor(PAIR_ROWS, device=dev)
    blocks = torch.tensor(PAIR_BLOCKS, device=dev)
    paged = clus_mt.reshape(-1, 16, N_BLOCKS, t_c)
    for s in range(0, live.numel(), PLAIN_BATCH):
        gi = live[s : s + PLAIN_BATCH]
        cid = chunk_cid[gi].long()
        coef = paged[cid[:, None], rows, blocks]  # (b,20,t_c)
        real = ids[None] < clus_count[cid][:, None, None]  # (b,t_c,1)
        fr = feats[gi]  # (b,16,128)
        o = fr[:, 0:3] - clus_mt[cid, 10:13, 0:1]  # cluster-local origin
        d = fr[:, 3:6]
        c = torch.stack([
            o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
            o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
            o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0],
        ], dim=1)
        f9 = fr[:, 9]
        f = [o[:, 0], o[:, 1], o[:, 2], f9, *d.unbind(1), *d.unbind(1),
             *c.unbind(1), *d.unbind(1), *c.unbind(1), f9]

        def block(lo, hi):  # sum of terms lo..hi-1 in order: (b,t_c,128)
            acc = coef[:, lo, :, None] * f[lo][:, None, :]
            for k in range(lo + 1, hi):
                acc = acc + coef[:, k, :, None] * f[k][:, None, :]
            return acc

        T, B, U, V, FO = (block(0, 4), block(4, 7), block(7, 13),
                          block(13, 19), block(19, 20))
        rb = 1.0 / B
        t = T * rb
        u = U * rb
        v = V * rb
        w = 1.0 - u - v
        front = B >= 1e-8
        ok = (t >= 0) & (u >= 0) & (v >= 0) & (w >= 0)
        ok = ok & ~((~front) & (FO > 0.5)) & real
        tt = torch.where(ok, t, BIG)
        tmin = tt.amin(dim=1)
        first = torch.where(tt == tmin[:, None], ids, t_c).amin(dim=1)
        t_out[gi] = tmin
        p_out[gi] = torch.where(tmin < BIG, first, -1).to(torch.int32)
    return t_out, p_out


def box_hits(pages, feats, chunk_pid, page_count):
    """Slab test of each chunk's 128 rays against the ``page_count`` (P,)
    i32 real boxes of its page: (G,4,128) i32 words, bit b of word w set
    iff the ray enters box 32w+b within its tmax (feature row 13)."""
    _check_chunks(pages, BOX_COLS, feats, chunk_pid, page_count)
    if feats.device.type == "cpu":
        return box_hits_reference(pages, feats, chunk_pid, page_count)
    g = feats.shape[0]
    words = torch.empty((g, 4, 128), dtype=torch.int32, device=feats.device)
    if g == 0:
        return words
    err = _load().rt_box_hits(
        pages.data_ptr(), feats.data_ptr(), chunk_pid.data_ptr(),
        page_count.data_ptr(), words.data_ptr(), g,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    _raise_on(err, "box hits")
    launches["box_hits"] += 1
    return words


def box_hits_reference(pages, feats, chunk_pid, page_count):
    """The kernel's arithmetic in plain torch, PLAIN_BATCH chunks a step:
    each plane from its block's own axis row, bound * iv - o * iv, for the
    real boxes (a lane whose 1/d has an infinite component sets no bit, as
    in the old form: ``csrc/cluster_test.cu`` says why)."""
    g = feats.shape[0]
    dev = feats.device
    out = torch.zeros((g, 4, 128), dtype=torch.int32, device=dev)
    live = (chunk_pid >= 0).nonzero().squeeze(1)
    weights = (1 << torch.arange(32, device=dev, dtype=torch.int64))
    rows = torch.tensor(BOX_ROWS, device=dev)
    blocks = torch.arange(6, device=dev)
    boxes = torch.arange(128, device=dev)[:, None]
    paged = pages.reshape(-1, 16, 6, 128)
    for s in range(0, live.numel(), PLAIN_BATCH):
        gi = live[s : s + PLAIN_BATCH]
        pid = chunk_pid[gi].long()
        bound = paged[pid[:, None], rows, blocks]  # (b,6,128 boxes)
        fr = feats[gi]
        iv = 1.0 / fr[:, 3:6]  # (b,3,128)
        oiv = fr[:, 0:3] * iv
        t1x, t2x, t1y, t2y, t1z, t2z = (
            bound[:, k, :, None] * iv[:, k // 2, None, :]
            - oiv[:, k // 2, None, :]
            for k in range(6)
        )  # (b,128 boxes,128 lanes)
        tmin = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.minimum(t1z, t2z))
        tmx = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.maximum(t1z, t2z))
        hit = (tmx >= tmin) & (tmx > 0) & (tmin < fr[:, 13, None, :])
        hit = hit & (boxes < page_count[pid][:, None, None])
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
