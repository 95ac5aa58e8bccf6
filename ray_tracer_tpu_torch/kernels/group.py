"""BVH8 closest-hit and occlusion traversal: the CUDA kernel and its twin.

``group_traverse`` is the port of ``ray_tracer_tpu/kernels/group.py``'s
``_group_kernel`` (closest-hit, and order-free occlusion with
``anyhit=True``).  On CUDA tensors it launches ``group_walk_kernel``, the
hand-written walk in ``csrc/bvh8_walk.cu`` designed for Hopper (built with
``nvcc`` at first use, one library with ``kernels/packet.py``); on CPU
tensors it runs :func:`group_traverse_reference`, the plain torch version
of the same walk.  Nothing falls back: a CUDA tensor that the kernel
cannot take raises.  The stack holds ``bvh8.G_STACK`` words, one per wide
level; ``ops/traverse.py`` caps a compiled scene's depth well below that.
On a hand-built tree deeper than the stack the plain walk raises and the
kernel stops with a device trap.

Contract (shared by both):

* ``nodes`` (W,128) f32 wide-node rows and ``leaf_rows`` (L,128) f32 leaf
  rows, as ``CompiledScene.wide_packed`` / ``leaf_rows``;
* ``origin``/``direction`` (N,3) f32, ``tmax0`` (N,) f32, ``-BIG`` on
  inactive lanes;
* returns ``dst`` (N,) f32 — the closest accepted distance (``tmax0`` on a
  miss), or under ``anyhit`` ``-BIG`` where any hit lies inside ``tmax0`` —
  and ``prim`` (N,) i32, the padded leaf-slot id ``row * 8 + record`` of
  the closest hit, -1 on a miss (always -1 under ``anyhit``).

The walk is ``csrc/bvh8_walk.cu`` (plain twin: ``bvh8.walk_reference``):
each ray keeps a stack of ``(node, remaining-child-mask)`` words, bits
stored near-first for closest-hit, plain for occlusion; the kernel keeps
the top word in a register.  The arithmetic is ``_group_kernel``'s, op for
op; the two versions here round identically,
so on the card they agree bit for bit (the kernel is built with
``--fmad=false``).  Across implementations only the child order differs,
which can change ``prim`` (never ``dst``) on exact-t ties between
duplicated geometry.
"""

from __future__ import annotations

from .bvh8 import (  # noqa: F401  (BIG: re-exported)
    BIG,
    check_walk_inputs,
    launch_group,
    walk_reference,
)

# Kernel launches per mode since the last reset (the CPU path never adds).
launches = {"group_traverse": 0, "group_anyhit": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def group_traverse(nodes, leaf_rows, origin, direction, tmax0,
                   anyhit: bool = False):
    """Closest hit (or occlusion) of N rays; see the module docstring."""
    check_walk_inputs(nodes, leaf_rows, origin, direction, tmax0)
    if origin.device.type == "cpu":
        return group_traverse_reference(
            nodes, leaf_rows, origin, direction, tmax0, anyhit=anyhit
        )
    if origin.device.type != "cuda":
        raise ValueError(f"no traversal kernel for device {origin.device}")
    dst, prim = launch_group(nodes, leaf_rows, origin, direction, tmax0,
                             anyhit)
    if origin.shape[0]:
        launches["group_anyhit" if anyhit else "group_traverse"] += 1
    return dst, prim


def group_traverse_reference(nodes, leaf_rows, origin, direction, tmax0,
                             anyhit: bool = False, stats: dict = None):
    """The kernel's walk in plain torch (``bvh8.walk_reference``, one-row
    leaf slots)."""
    return walk_reference(nodes, leaf_rows, origin, direction, tmax0,
                          mode="anyhit" if anyhit else "closest",
                          stats=stats)
