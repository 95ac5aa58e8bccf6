"""What the group walk kernel relies on, checked here on the CPU.

On the card ``group_traverse`` launches ``group_walk_kernel``, which
tests a one-row leaf slot's records only up to the count in the slot's
code, and holds one stack word per level of the BVH8 in a stack of
``bvh8.G_STACK`` words.  Here: every compiled leaf code counts its slot's
records (NaN padding past them), the plain walk never holds more words
than the tree has levels, a tree as deep as the stack fits it and a deeper
one overflows it, and the wrapper's CPU path is the plain walk.
"""

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch import CompiledScene
from ray_tracer_tpu_torch.kernels import bvh8, group

from torch_parity import (
    deep_chain,
    room_scene,
    route_rays,
    route_tmax,
    scene_arrays,
    soup_scene,
)

SCENES = ["room", "soup4", "soup8", "soup_big"]


def _builder(pkg, name, tmp):
    if name == "room":
        return room_scene(pkg, tmp), {}
    if name == "soup_big":
        return soup_scene(pkg, tmp, seed=99, n_tris=3000), {}
    return soup_scene(pkg, tmp), {"max_leaf_tris": int(name[-1])}


def _port_scene(name, tmp):
    b, kw = _builder(trt, name, tmp)
    return b.compile(device="cpu", **kw)


def brute_depth(nodes) -> int:
    """Depth of the wide tree by recursion from the root: 1 + the deepest
    interior child's depth."""
    nodes = np.asarray(nodes)

    def depth(w):
        codes = nodes[w, 6:64:8]
        boxes = nodes[w, 0:64:8]
        kids = [int(c) for c, b in zip(codes, boxes)
                if c > 0 and not np.isnan(b)]
        return 1 + max((depth(k) for k in kids), default=0)

    return depth(0)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("compiler", ["port", "jax"])
def test_leaf_codes_count_their_records(name, compiler, tmp_path):
    """Both ways into a CompiledScene (the port's compile, and from_numpy
    of the JAX compiler's arrays): in every leaf code of ``wide_packed``
    the payload's count is the number of records of its slot's row, and
    the records past it are NaN padding, which never hits."""
    if compiler == "port":
        sc = _port_scene(name, str(tmp_path))
    else:
        b, kw = _builder(jrt, name, str(tmp_path))
        sc = CompiledScene.from_numpy(*scene_arrays(b.compile(**kw)),
                                      device="cpu")
    assert sc.meta["wide_leaf_recs"] <= 8  # one-row slots
    nodes = sc.wide_packed.numpy()
    records = sc.leaf_rows.numpy().reshape(-1, 8, 16)
    codes = nodes[:, 6:64:8][~np.isnan(nodes[:, 0:64:8])]
    payload = (-codes[codes < 0]).astype(np.int64) - 1
    assert payload.size and (payload >> 4).max() < records.shape[0]
    if name == "soup8":  # sibling leaves packed into shared rows
        assert sc.meta["wide_leaf_recs"] == 8
    for slot, cnt in zip(payload >> 4, payload & 15):
        assert 1 <= cnt <= 8
        assert np.isfinite(records[slot, :cnt, :12]).all()
        assert np.isnan(records[slot, cnt:, :12]).all()


@pytest.mark.parametrize("name", ["room", "soup8", "soup_big", "chain"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_plain_walk_stack_fits_the_kernel_stack(name, anyhit, tmp_path):
    """``stats["max_sp"]`` of the plain walk on random rays never exceeds
    the tree's wide depth, which a compiled scene keeps within its binary
    depth + 1: far inside the kernel's stack, as ``ops/traverse.py`` caps
    the binary depth at ``MAX_TREE_DEPTH``."""
    rand = np.random.default_rng(11)
    if name == "chain":
        nodes, rows = (torch.from_numpy(x) for x in deep_chain(40))
        depth = brute_depth(nodes)
        assert depth == 40
        o, d = route_rays(rand, "soup", 600)
        o *= 0.2  # near the middle, inside most cubes
    else:
        sc = _port_scene(name, str(tmp_path))
        nodes, rows = sc.wide_packed, sc.leaf_rows
        depth = brute_depth(nodes)
        assert depth <= sc.meta["bvh_max_depth"] + 1
        o, d = route_rays(rand, "room" if name == "room" else "soup", 600)
    assert bvh8.MAX_TREE_DEPTH + 1 <= bvh8.G_STACK
    tmax = route_tmax(rand, "clipped" if anyhit else "closest", 600)
    stats = {}
    group.group_traverse_reference(
        nodes, rows, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tmax), anyhit=anyhit, stats=stats)
    assert 2 <= stats["max_sp"] <= depth
    if name == "chain" and not anyhit:  # the walk goes down the chain
        assert stats["max_sp"] >= depth // 2


def _up_x_rays(n, seed):
    """Rays from inside the innermost cube of a 97-level chain, pointing
    up x: the closest-hit walk visits the interior child first."""
    rand = np.random.default_rng(seed)
    o = rand.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] = np.abs(d[:, 0]) + 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("anyhit", [False, True])
def test_a_tree_as_deep_as_the_stack_fills_it(anyhit):
    """On a loose chain of G_STACK levels every ray holds one word per
    level: exactly the kernel's stack, which the GPU tests drive."""
    nodes, rows = (torch.from_numpy(x)
                   for x in deep_chain(bvh8.G_STACK, loose=True))
    o, d = _up_x_rays(16, seed=3)
    stats = {}
    dst, prim = group.group_traverse_reference(
        nodes, rows, o, d, torch.full((16,), 99999999.0), anyhit=anyhit,
        stats=stats)
    assert stats["max_sp"] == bvh8.G_STACK
    assert (dst < -1.0).all() if anyhit else (prim >= 0).all()


@pytest.mark.parametrize("anyhit", [False, True])
def test_plain_walk_raises_past_the_stack(anyhit):
    """One level more and the plain walk raises (the kernel, which the host
    keeps from such trees, would trap)."""
    nodes, rows = (torch.from_numpy(x)
                   for x in deep_chain(bvh8.G_STACK + 1, loose=True))
    o, d = _up_x_rays(16, seed=4)
    group.reset_launches()
    with pytest.raises(RuntimeError, match="stack overflow"):
        group.group_traverse(nodes, rows, o, d,
                             torch.full((16,), 99999999.0), anyhit=anyhit)
    assert group.launches == {"group_traverse": 0, "group_anyhit": 0}


def test_wrapper_equals_plain_walk_on_the_deep_chain():
    """The wrapper's CPU path is the plain walk; on the deep chain both
    queries find hits."""
    rand = np.random.default_rng(4)
    nodes, rows = (torch.from_numpy(x) for x in deep_chain(60))
    o, d = route_rays(rand, "soup", 500)
    o = torch.from_numpy(o * 0.5)
    d = torch.from_numpy(d)
    tmax = torch.from_numpy(route_tmax(rand, "clipped", 500))
    for anyhit in (False, True):
        got = group.group_traverse(nodes, rows, o, d, tmax, anyhit=anyhit)
        want = bvh8.walk_reference(nodes, rows, o, d, tmax,
                                   mode="anyhit" if anyhit else "closest")
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert ((got[1] >= 0).any() if not anyhit
                else (got[0] < -1.0).any())
