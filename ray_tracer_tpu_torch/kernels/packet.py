"""BVH8 single-phase walk and cluster enumeration: the CUDA kernel and its
twin.

``packet_traverse_wide`` is the port of ``ray_tracer_tpu/kernels/
packet.py``'s ``_packet8_kernel`` in the modes this package routes through
it: the closest-hit and occlusion walks over one-row (8-record) or two-row
(16-record) leaf slots, and the ``emit_leaves`` enumeration of candidate
clusters.  On CUDA tensors it launches the walk in ``csrc/bvh8_walk.cu``
(built with ``nvcc`` at first use, one library with ``kernels/group.py``);
on CPU tensors it runs
:func:`packet_traverse_wide_reference`.  Nothing falls back: a CUDA tensor
that the kernel cannot take raises.  The treelet TOP/DEEP modes of the TPU
kernel (``top_k`` without ``emit_leaves``, ``deep_e``) are not ported.

Both versions run ``bvh8.walk_reference``'s walk (one thread per ray on
the card) and round alike, so on the card they
agree bit for bit.  Against the TPU kernel, whose packet walks in lockstep
with the packet-majority child order, only the visit order differs: it can
change ``prim`` (never ``dst``) on exact-t ties, and the ORDER of the
emitted slots, never their set or count.
"""

from __future__ import annotations

import torch

from .bvh8 import (
    check_tensors,
    check_walk_inputs,
    launch_emit,
    launch_walk,
    walk_reference,
)

# Kernel launches per mode since the last reset (the CPU path never adds).
launches = {"packet8_wide": 0, "packet8_anyhit": 0, "packet8_emit": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _rows(max_recs: int) -> int:
    """Leaf rows per slot: two for 16-record (merged two-row) scenes."""
    if max_recs not in (4, 8, 16):
        raise ValueError(f"max_recs must be 4, 8 or 16, got {max_recs}")
    return 2 if max_recs > 8 else 1


def packet_traverse_wide(nodes, leaf_rows, origin, direction, tmax0,
                         max_recs: int, anyhit: bool = False, top_k: int = 0,
                         emit_leaves: bool = False):
    """The packet walk of N rays over a BVH8.

    Walk (``top_k == 0``): returns ``(dst, prim)`` — ``dst`` the closest
    accepted t (``tmax0`` on a miss), or under ``anyhit`` ``-BIG`` where a
    hit lies inside ``tmax0``; ``prim`` the padded leaf-slot id
    ``slot * 8 + record`` (map through ``leaf_map``), -1 on a miss and
    under ``anyhit``.  ``max_recs`` is the scene's ``wide_leaf_recs``: 16
    reads two-row slots.

    Emit (``top_k > 0, emit_leaves=True``; ``nodes`` the cluster BVH8,
    ``leaf_rows`` never read): returns ``(slots, ovf)``, (N,top_k) i32
    cluster ids (-1 padded) whose box the ray enters within ``tmax0``, in
    visit order, and (N,) i32 overflow flags (more than ``top_k``).
    """
    check_walk_inputs(nodes, leaf_rows, origin, direction, tmax0)
    rows = _rows(max_recs)
    if top_k and not emit_leaves:
        raise NotImplementedError(
            "the treelet TOP mode (top_k without emit_leaves) is not ported "
            "(ROADMAP Queue A item 8, with two-phase traversal)"
        )
    if emit_leaves and (top_k < 1 or anyhit):
        raise ValueError("emit_leaves needs top_k >= 1 and anyhit=False")
    dev = origin.device
    if dev.type == "cpu":
        return packet_traverse_wide_reference(
            nodes, leaf_rows, origin, direction, tmax0, max_recs,
            anyhit=anyhit, top_k=top_k, emit_leaves=emit_leaves,
        )
    if dev.type != "cuda":
        raise ValueError(f"no traversal kernel for device {dev}")
    if emit_leaves:
        out = launch_emit(nodes, origin, direction, tmax0, top_k)
        mode = "packet8_emit"
    else:
        out = launch_walk(nodes, leaf_rows, origin, direction, tmax0, anyhit,
                          rows)
        mode = "packet8_anyhit" if anyhit else "packet8_wide"
    if origin.shape[0]:
        launches[mode] += 1
    return out


def packet_traverse_wide_reference(nodes, leaf_rows, origin, direction,
                                   tmax0, max_recs: int,
                                   anyhit: bool = False, top_k: int = 0,
                                   emit_leaves: bool = False,
                                   stats: dict = None):
    """The kernel's walk in plain torch (``bvh8.walk_reference``)."""
    mode = "emit" if emit_leaves else ("anyhit" if anyhit else "closest")
    return walk_reference(nodes, leaf_rows, origin, direction, tmax0,
                          mode=mode, rows=_rows(max_recs), top_k=top_k,
                          stats=stats)


def reconstruct_uvfront(leaf_rows, origin, direction, prim):
    """Barycentrics and facing of each ray's winning record, outside the
    kernel: ``_reconstruct_uvfront`` of the JAX package.  ``prim`` is a
    padded slot id, row ``prim`` of the (L*8,16) record view; the same
    formulas and zero-direction guard as the kernel's test."""
    check_tensors(origin.device, torch.int32, prim=(prim, (origin.shape[0],)))
    rec = leaf_rows.reshape(-1, 16)[prim.clamp(min=0).long()]
    return _uvfront(rec, origin, direction, prim)


def _uvfront(rec, origin, direction, prim):
    d = torch.where(direction == 0.0, 1e-20, direction)
    r = origin - rec[:, 0:3]
    q = torch.linalg.cross(r, d)
    d0 = -(d * rec[:, 9:12]).sum(dim=1)
    dinv = 1.0 / d0
    u = (rec[:, 6:9] * q).sum(dim=1) * dinv
    v = -(rec[:, 3:6] * q).sum(dim=1) * dinv
    miss = prim < 0
    return (torch.where(miss, 0.0, u), torch.where(miss, 0.0, v),
            ~miss & (d0 >= 1e-8))

