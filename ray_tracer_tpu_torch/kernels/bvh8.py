"""The BVH8 walk behind the group and packet traversal wrappers.

``csrc/bvh8_walk.cu`` is the one-thread-per-ray walk on the card, one
library for both wrappers, with four kernels: ``group_walk_kernel``
(:func:`launch_group`, the closest-hit and occlusion walk from the root
over one- or two-row leaf slots), which ``kernels/group.py`` and
``kernels/packet.py`` launch; ``deep_walk_kernel`` (:func:`launch_deep`),
which ``kernels/packet.py`` launches for the DEEP start;
``emit_walk_kernel`` (:func:`launch_emit`), which it launches for the emit
mode; and ``top_walk_kernel`` (:func:`launch_top`), which it launches for
the TOP start, over the scene's TOP table (``wide_top``,
``scene/builder.py::top_table``).  ``walk_reference`` is the plain torch
version of all four; :func:`top_walk_reference` is the TOP kernel's own
twin, the same walk over the TOP table.

Tables (``CompiledScene.wide_packed`` / ``leaf_rows``):

* ``nodes`` (W,128) f32: per child c, floats 8c..8c+5 = min3|max3, float
  8c+6 = traversal code as an f32 VALUE (>= 0: wide node id; < 0: leaf
  with payload -(slot*16 + cnt) - 1, slot = -code-1 >> 4), float 7 = the
  child-sort axis.  Empty child slots hold NaN boxes and code 0.
* ``leaf_rows`` (L,128) f32: 8 records v0|e1|e2|n|front_only|pad per row;
  a slot spans ``rows`` consecutive rows, so record k of slot s is record
  s*8 + k of the (L*8,16) view: its padded id.  NaN records never hit.

Each ray keeps a stack of ``node << 9 | reversed << 8 | remaining-mask``
words.  A step pops the next child of the top word (the lowest set bit;
bits are stored near-first: reversed when the ray points down the node's
sort axis) and either slab-tests a wide node's 8 children against the
current best and pushes the hit set, or tests a leaf slot's records.
Mask 0 is the root entry (visit the word's node itself).  Modes:

* ``closest``: the closest accepted record; records fold with strict
  ``<``, so the earliest record wins a tie;
* ``anyhit``: ``dst = -BIG`` at the first record inside ``tmax0``;
* ``emit``: leaf children are never entered; each leaf child whose box the
  ray enters within ``tmax0`` appends its slot field (a cluster id on the
  cluster enumeration tree) to the lane's next free slot of ``top_k``,
  and sets ``ovf`` past them.  ``tmax0`` never shrinks.

and where the walk starts (the two phases of treelet traversal):

* from the root (word 0), the default;
* TOP (``troot`` (W,) i32 given, with ``top_k``): the closest-hit or
  occlusion walk from the root, except that an interior child flagged in
  ``troot`` (a treelet root) is never pushed: when the ray enters its box
  within the current best, its node id goes to the lane's next free slot
  (child-slot order), past ``top_k`` of them ``ovf`` is set.  Over the
  TOP table (``top_t`` = T, its rows, given instead of ``troot``) the
  same walk: a code of T or more is a treelet root, emitted as code - T;
* DEEP (``entries`` (G,E) i32, -1 padded, and ``packet_size`` P with
  N = G*P): lane i starts with one mask-0 word per entry of row i // P,
  pushed untested in list order, and walks on as the closest-hit or
  occlusion walk does, treelet roots included.  Its result is the closest
  hit in the union of its packet's entry subtrees, walked one after the
  other, the last listed first (the CUDA kernel reads each entry when
  the walk of the one before ends, which visits the same nodes in the
  same order).  Lanes with ``tmax0 <= 0`` start with no word: no record
  with t >= 0 lies below their bound.

The arithmetic is ``ray_tracer_tpu``'s kernels', op for op; built with
``--fmad=false`` the CUDA walk rounds like this one, so on the card the
two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..native_build import build_shared, nvcc_path

BIG = 99999999.0
# One stack word per tree level: the builder caps the binary tree at depth
# 64 and a wide node sits at least one binary level below its parent, so a
# walk never holds more than 65 words (checked against the scene's depth in
# ops/traverse.py), plus, in the plain DEEP walk, one word per entry.
G_STACK = 96
MAX_TREE_DEPTH = 64
MAX_DEEP_E = G_STACK - MAX_TREE_DEPTH - 1
# The TOP walk's stack (top_walk_kernel's kTopStack): one word per level of
# the top level, which scene/builder.py::top_table checks at compile.
TOP_STACK = 32
# Codes of the TOP table reach T + W: below 2^24 every one is exact in f32.
TOP_CODE_LIMIT = 2**24

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # exact agreement with the torch twins: no contracted FMAs, IEEE
    # division, NaN-aware comparisons (no --use_fast_math)
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_SRC = os.path.join(CSRC, "bvh8_walk.cu")

MODES = ("closest", "anyhit", "emit")

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the walk library (once per source hash); return its path."""
    return build_shared(_SRC, "bvh8_walk", (nvcc_path(), *NVCC_FLAGS))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.rt_bvh8_top.restype = ctypes.c_int
        lib.rt_bvh8_top.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.rt_bvh8_deep.restype = ctypes.c_int
        lib.rt_bvh8_deep.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
            + [ctypes.c_void_p]
        )
        lib.rt_bvh8_emit.restype = ctypes.c_int
        lib.rt_bvh8_emit.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.rt_bvh8_group.restype = ctypes.c_int
        lib.rt_bvh8_group.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int]
            + [ctypes.c_void_p]
        )
        _lib = lib
    return _lib


def launch_group(nodes, leaf_rows, origin, direction, tmax0, anyhit: bool,
                 rows: int = 1):
    """One launch of ``group_walk_kernel`` on the card: ``(dst, prim)`` as
    :func:`walk_reference` with ``rows``-row slots (1 or 2) returns them.
    Inputs as checked by :func:`check_walk_inputs`, on a CUDA device."""
    dev = origin.device
    n = origin.shape[0]
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        err = _load().rt_bvh8_group(
            int(anyhit), rows, nodes.data_ptr(), leaf_rows.data_ptr(),
            origin.data_ptr(), direction.data_ptr(), tmax0.data_ptr(),
            dst.data_ptr(), prim.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"BVH8 group walk kernel launch failed: CUDA error {err}")
    return dst, prim


def launch_deep(nodes, leaf_rows, entries, origin, direction, tmax0,
                anyhit: bool, rows: int, packet_size: int):
    """One launch of ``deep_walk_kernel`` on the card: ``(dst, prim)`` as
    :func:`walk_reference` returns them with ``entries``.  Inputs as
    checked by :func:`check_walk_inputs` and :func:`check_start_inputs`,
    on a CUDA device."""
    dev = origin.device
    n = origin.shape[0]
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        err = _load().rt_bvh8_deep(
            int(anyhit), rows, nodes.data_ptr(), leaf_rows.data_ptr(),
            entries.data_ptr(), origin.data_ptr(),
            direction.data_ptr(), tmax0.data_ptr(), dst.data_ptr(),
            prim.data_ptr(), n, entries.shape[1], packet_size,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"BVH8 DEEP walk kernel launch failed: CUDA error {err}")
    return dst, prim


def launch_emit(nodes, origin, direction, tmax0, top_k: int):
    """One launch of ``emit_walk_kernel`` on the card: ``(slots, ovf)`` as
    :func:`walk_reference` returns them in the ``emit`` mode, for any
    ``top_k >= 1``.  Inputs as checked by :func:`check_walk_inputs`, on a
    CUDA device."""
    dev = origin.device
    n = origin.shape[0]
    slots = torch.empty((n, top_k), dtype=torch.int32, device=dev)
    ovf = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        err = _load().rt_bvh8_emit(
            nodes.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            tmax0.data_ptr(), slots.data_ptr(), ovf.data_ptr(), n, top_k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"BVH8 emit walk kernel launch failed: CUDA error {err}")
    return slots, ovf


def launch_top(top, leaf_rows, origin, direction, tmax0, anyhit: bool,
               rows: int, top_k: int):
    """One launch of ``top_walk_kernel`` on the card: the TOP walk over the
    TOP table ``top`` (T,64), ``(dst, prim, slots, ovf)`` as
    :func:`walk_reference` returns them with ``troot`` and as
    :func:`top_walk_reference` with ``top``, for any ``top_k >= 1``.
    Inputs as checked by :func:`check_walk_inputs` and
    :func:`check_top_table`, on a CUDA device."""
    dev = origin.device
    n = origin.shape[0]
    dst = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    slots = torch.empty((n, top_k), dtype=torch.int32, device=dev)
    ovf = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        err = _load().rt_bvh8_top(
            int(anyhit), rows, top.data_ptr(), top.shape[0],
            leaf_rows.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            tmax0.data_ptr(), dst.data_ptr(), prim.data_ptr(),
            slots.data_ptr(), ovf.data_ptr(), n, top_k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"BVH8 TOP walk kernel launch failed: CUDA error {err}")
    return dst, prim, slots, ovf


def check_top_table(top, nodes, device) -> None:
    """Raise unless ``top`` is a TOP table the kernel on ``device`` can
    walk: (T,64) f32, contiguous, on ``device``, 1 <= T and T + W below
    :data:`TOP_CODE_LIMIT` (W: the rows of ``nodes``).  An empty table is
    the mark of a scene whose top level lies beyond the TOP walk's limits
    (``scene/builder.py::top_table_or_empty``)."""
    if top is None:
        raise ValueError(
            "the TOP walk on the card needs the scene's TOP table "
            "(wide_top=scene.wide_top, built by compile())")
    if top.dim() != 2 or top.shape[1] != 64:
        raise ValueError(f"the TOP table must have shape (T, 64), got "
                         f"{tuple(top.shape)}")
    if top.shape[0] == 0:
        raise ValueError(
            "the scene's TOP table is empty: its top level lies beyond the "
            f"TOP walk's limits ({TOP_STACK} levels; codes below 2^24), as "
            "compile() found")
    check_tensors(device, torch.float32, wide_top=(top, tuple(top.shape)))
    if top.shape[0] + nodes.shape[0] >= TOP_CODE_LIMIT:
        raise ValueError("the TOP table's codes reach 2^24: not exact in f32")


def check_tensors(device, dtype, **named) -> None:
    """Raise unless every ``name=(tensor, shape)`` lies on ``device`` with
    ``dtype``, the given shape and contiguous memory."""
    for name, (t, shape) in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_walk_inputs(nodes, leaf_rows, origin, direction, tmax0) -> None:
    n = origin.shape[0]
    check_tensors(
        origin.device, torch.float32,
        nodes=(nodes, (nodes.shape[0], 128)),
        leaf_rows=(leaf_rows, (leaf_rows.shape[0], 128)),
        origin=(origin, (n, 3)), direction=(direction, (n, 3)),
        tmax0=(tmax0, (n,)),
    )
    if n >= 2**31 or nodes.shape[0] >= 2**23:
        raise ValueError("too many rays or wide nodes for 32-bit indices")


def check_start_inputs(nodes, origin, troot=None, entries=None,
                       packet_size: int = 0) -> None:
    """Raise unless the TOP table (``troot`` (W,) i32) or the DEEP entry
    lists (``entries`` (G,E) i32 with N = G * ``packet_size`` and E at
    most :data:`MAX_DEEP_E`) fit the walk's inputs."""
    if troot is not None and entries is not None:
        raise ValueError("a walk starts from the root (TOP) or from entry "
                         "lists (DEEP), not both")
    if troot is not None:
        check_tensors(origin.device, torch.int32,
                      troot=(troot, (nodes.shape[0],)))
    if entries is not None:
        n = origin.shape[0]
        if entries.dim() != 2 or packet_size < 1:
            raise ValueError("DEEP mode needs (G,E) entries and a packet "
                             "size >= 1")
        g, e = entries.shape
        if g * packet_size != n:
            raise ValueError(f"DEEP mode: {n} rays are not {g} packets of "
                             f"{packet_size}")
        if not 1 <= e <= MAX_DEEP_E:
            raise ValueError(f"DEEP mode: {e} entries per packet, the stack "
                             f"holds 1..{MAX_DEEP_E} beside the tree depth")
        check_tensors(origin.device, torch.int32, entries=(entries, (g, e)))


def _mt_t(rows, origin, d):
    """Moller-Trumbore accept distance per (lane, record), BIG on a miss:
    the JAX kernels' ``_tri_t`` arithmetic.  rows (K,R,16); origin/d
    (K,3)."""
    t, _, _, _, ok = mt_test(rows, origin[:, None, :], d[:, None, :])
    return torch.where(ok, t, BIG)


def mt_test(rec, origin, d, front_only: int = 12):
    """Moller-Trumbore of v0|e1|e2|n records ``rec`` (...,16), with the
    front-only flag in column ``front_only``, against rays ``origin``/``d``
    (...,3, broadcast against rec's leading dimensions; ``d``
    zero-guarded): ``(t, u, v, front, ok)``, the JAX kernels' arithmetic op
    for op (``packet.py:117-132``)."""
    c = lambda j: rec[..., j]
    ox, oy, oz = (origin[..., j] for j in range(3))
    dx, dy, dz = (d[..., j] for j in range(3))
    rx = ox - c(0)
    ry = oy - c(1)
    rz = oz - c(2)
    qx = ry * dz - rz * dy
    qy = rz * dx - rx * dz
    qz = rx * dy - ry * dx
    d0 = -(dx * c(9) + dy * c(10) + dz * c(11))
    dinv = 1.0 / d0
    t = (rx * c(9) + ry * c(10) + rz * c(11)) * dinv
    u = (c(6) * qx + c(7) * qy + c(8) * qz) * dinv
    v = -(c(3) * qx + c(4) * qy + c(5) * qz) * dinv
    w = 1.0 - u - v
    front = d0 >= 1e-8
    ok = (t >= 0) & (u >= 0) & (v >= 0) & (w >= 0)
    ok = ok & ~((~front) & (c(front_only) > 0.5))
    return t, u, v, front, ok


def _slab_mask(boxes, inv, oi, best):
    """8-child slab test -> (K,) hit-bit masks.  boxes (K,8,8)."""
    bx = lambda j: boxes[:, :, j]
    t1 = [bx(a) * inv[:, a : a + 1] - oi[:, a : a + 1] for a in range(3)]
    t2 = [bx(3 + a) * inv[:, a : a + 1] - oi[:, a : a + 1] for a in range(3)]
    lo = [torch.minimum(p, q) for p, q in zip(t1, t2)]
    hi = [torch.maximum(p, q) for p, q in zip(t1, t2)]
    tmin = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tmx = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    hv = (tmx >= tmin) & (tmx > 0) & (tmin < best[:, None])
    bits = torch.tensor([1 << c for c in range(8)], device=boxes.device)
    return (hv.long() * bits).sum(dim=1)


def walk_reference(nodes, leaf_rows, origin, direction, tmax0,
                   mode: str = "closest", rows: int = 1, top_k: int = 0,
                   troot=None, entries=None, packet_size: int = 0,
                   stats: dict = None, top_t: int = 0):
    """The CUDA walk in plain torch, vectorized over the live lanes.

    Returns ``(dst, prim)`` for ``closest``/``anyhit`` (from the root, or
    DEEP from ``entries``), ``(dst, prim, slots, ovf)`` in TOP mode
    (``troot``, or ``top_t`` > 0 with ``nodes`` the TOP table of ``top_t``
    rows) and ``(slots, ovf)`` ((N,top_k) i32 with -1 padding, (N,) i32)
    for ``emit``.  Raises if a lane needs more than E*(W+L+1) steps
    (each node and leaf slot is visited at most once per entry; E = 1
    from the root) or overflows its stack.  ``stats``, if given, receives
    the walk's visit counts summed over the rays: ``interior`` (8-child
    slab tests) and ``leaf`` (leaf-slot tests), ``children`` and
    ``records`` (the non-empty child boxes and non-NaN records among
    them), ``node_seen`` (W,) / ``slot_seen`` (L,) bool, the distinct
    nodes and leaf slots (by first row) any ray visited, and ``max_sp``,
    the most stack words any ray held.
    """
    if mode not in MODES:
        raise ValueError(f"unknown walk mode {mode!r}")
    dev = origin.device
    n = origin.shape[0]
    n_nodes, n_leaf = nodes.shape[0], leaf_rows.shape[0]
    d = torch.where(direction == 0.0, 1e-20, direction)
    inv = 1.0 / d
    oi = origin * inv
    dst = tmax0.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    top = troot is not None or top_t > 0
    slots = torch.full((n, max(top_k, 1)), -1, dtype=torch.int32,
                       device=dev)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev)

    def result():
        ovf = (cnt > top_k).to(torch.int32)
        if mode == "emit":
            return slots[:, :top_k], ovf
        return (dst, prim, slots[:, :top_k], ovf) if top else (dst, prim)

    boxes = nodes[:, :64].reshape(n_nodes, 8, 8)
    codes = boxes[:, :, 6]
    axis = nodes[:, 7].long()
    records = leaf_rows.reshape(n_leaf * 8, 16)
    rec_ids = torch.arange(8 * rows, device=dev)
    bits = torch.arange(8, device=dev)
    ctz = torch.tensor(
        [(m & -m).bit_length() - 1 if m else 0 for m in range(256)],
        device=dev,
    )
    rev8 = torch.tensor(
        [int(f"{m:08b}"[::-1], 2) for m in range(256)], device=dev
    )
    stack = torch.zeros((n, G_STACK), dtype=torch.int64, device=dev)
    n_starts = 1
    if entries is not None:
        # DEEP: the packet's entries as mask-0 words, in list order; none
        # on lanes with tmax0 <= 0, where no record can lie below tmax0
        ent = entries.long()[torch.arange(n, device=dev) // packet_size]
        valid = (ent >= 0) & (tmax0 > 0)[:, None]
        lane, col = valid.nonzero(as_tuple=True)
        stack[lane, valid.cumsum(dim=1)[lane, col] - 1] = ent[lane, col] << 9
        sp = valid.sum(dim=1)
        n_starts = entries.shape[1]
    else:  # word 0 = visit the root itself
        sp = torch.ones(n, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)[sp > 0]
    if stats is not None:
        stats.update(
            interior=0, leaf=0, children=0, records=0,
            max_sp=int(sp.max()) if n else 0,
            node_seen=torch.zeros(n_nodes, dtype=torch.bool, device=dev),
            slot_seen=torch.zeros(n_leaf, dtype=torch.bool, device=dev),
        )
    max_steps = n_starts * (n_nodes + n_leaf + 1)
    for _ in range(max_steps):
        if lanes.numel() == 0:
            return result()
        sp_top = sp[lanes] - 1
        word = stack[lanes, sp_top]
        mask = word & 0xFF
        node = word >> 9
        direct = mask == 0
        c = ctz[mask]
        slot = torch.where((word & 0x100) != 0, 7 - c, c)
        rem = mask & (mask - 1)
        stack[lanes, sp_top] = word - mask + rem
        sp[lanes] = sp_top + (~(direct | (rem == 0))).long()
        code = codes[node, slot]
        is_leaf = ~direct & (code < 0)
        target = torch.where(direct, node, code.long())

        lf = is_leaf.nonzero().squeeze(1)
        if stats is not None:
            stats["leaf"] += lf.numel()
            stats["interior"] += lanes.numel() - lf.numel()
        if lf.numel():  # never in emit mode: leaf children are not pushed
            ll = lanes[lf]
            first = ((-code[lf]).long() - 1) // 16 * 8
            recs = records[first[:, None] + rec_ids]
            if stats is not None:
                stats["records"] += int((~recs[:, :, 0].isnan()).sum())
                stats["slot_seen"][first // 8] = True
            t = _mt_t(recs, origin[ll], d[ll])
            if mode == "anyhit":
                occ = ll[(t < dst[ll][:, None]).any(dim=1)]
                dst[occ] = -BIG
                sp[occ] = 0
            else:
                tmin = t.amin(dim=1)
                # the earliest record of the minimum (torch.min's index on
                # ties is not specified)
                kmin = torch.where(t == tmin[:, None], rec_ids, 8 * rows)
                kmin = kmin.amin(dim=1)
                closer = tmin < dst[ll]
                dst[ll] = torch.where(closer, tmin, dst[ll])
                prim[ll] = torch.where(
                    closer, (first + kmin).to(torch.int32), prim[ll]
                )

        it = (~is_leaf).nonzero().squeeze(1)
        if it.numel():
            il = lanes[it]
            tg = target[it]
            if stats is not None:
                stats["children"] += int((~boxes[tg, :, 0].isnan()).sum())
                stats["node_seen"][tg] = True
            m8 = _slab_mask(boxes[tg], inv[il], oi[il], dst[il])
            if mode == "emit" or top:
                ccodes = codes[tg]  # (K,8)
                if troot is not None:  # children flagged as treelet roots
                    child = torch.where(ccodes > 0, ccodes, 0).long()
                    is_em = (ccodes > 0) & (troot.long()[child] == 1)
                    val = child
                elif top:  # TOP table: codes of T or more, T + node id
                    is_em = ccodes >= top_t
                    val = ccodes.long() - top_t
                else:  # leaf children: their slot fields
                    is_em = ccodes < 0
                    val = ((-ccodes).long() - 1) // 16
                for ch in range(8):  # in slot order
                    em = ((m8 >> ch) & 1).bool() & is_em[:, ch]
                    el = il[em]
                    if el.numel():
                        k = cnt[el]
                        keep = k < top_k
                        slots[el[keep], k[keep]] = (
                            val[em, ch][keep].to(torch.int32))
                        cnt[el] = k + 1
                m8 = m8 & ~(is_em.long() << bits).sum(dim=1)
            if mode != "anyhit":
                ax = axis[tg]
                neg = d[il].gather(1, ax[:, None])[:, 0] < 0
                m8 = torch.where(neg, rev8[m8] | 0x100, m8)
            push = (m8 & 0xFF) != 0
            pl = il[push]
            if pl.numel():
                at = sp[pl]
                if int(at.max()) >= G_STACK:
                    raise RuntimeError("traversal stack overflow")
                stack[pl, at] = (tg[push] << 9) | m8[push]
                sp[pl] = at + 1
                if stats is not None:
                    stats["max_sp"] = max(stats["max_sp"], int(at.max()) + 1)

        lanes = lanes[sp[lanes] > 0]
    if lanes.numel() == 0:
        return result()
    raise RuntimeError(f"traversal did not finish within {max_steps} steps")


def top_walk_reference(top, leaf_rows, origin, direction, tmax0,
                       anyhit: bool, rows: int, top_k: int,
                       stats: dict = None):
    """``top_walk_kernel``'s twin: the TOP walk over the TOP table ``top``
    (T,64) in plain torch, ``(dst, prim, slots, ovf)``.  It visits and
    emits what :func:`walk_reference` does over the scene's ``nodes`` and
    ``troot``, in the same order, so the two agree bit for bit; ``stats``
    counts the table's rows.  Used by the tests and ``chip_smoke.py``; the
    wrapper's CPU path runs :func:`walk_reference` over ``troot``."""
    if top.shape[0] < 1:
        raise ValueError("an empty TOP table has no root to walk from")
    return walk_reference(top, leaf_rows, origin, direction, tmax0,
                          mode="anyhit" if anyhit else "closest", rows=rows,
                          top_k=top_k, stats=stats, top_t=top.shape[0])
