"""The port's narrow route against the JAX narrow packet kernel.

On CPU ``packet_traverse`` runs its plain torch version (the CUDA kernel's
twin); the JAX side runs ``_packet_kernel`` through Pallas' interpreter.
Hit masks equal; ``dst`` within the cross-implementation tolerance of
tests/test_torch_group.py (XLA contracts multiply-adds into FMAs, the port
does not); wherever ``prim`` agrees, ``u`` and ``v`` within that tolerance
and ``front`` equal.  ``prim`` may differ only on ties (the port walks each
ray in its own near-first order, the TPU kernel its packet's): where it
does, both triangles accept the ray at the same t up to that tolerance
(an exact tie, or two triangles meeting on an edge whose t the two
implementations round one ulp apart: there the slab test's rounding can
prune the leaf of the one an ulp nearer).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.kernels import packet as j_packet
from ray_tracer_tpu.ops import traverse as j_traverse
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch import CompiledScene, Routing
from ray_tracer_tpu_torch.kernels import packet as t_packet
from ray_tracer_tpu_torch.ops import traverse as t_traverse

from torch_parity import (
    assert_tri_ties,
    binary_chain,
    room_scene,
    route_rays,
    route_tmax,
    scene_arrays,
    soup_scene,
)

BIG = 99999999.0
SCENES = {
    "soup_leaf4": (soup_scene, dict(max_leaf_tris=4)),
    "soup_leaf8": (soup_scene, dict(max_leaf_tris=8)),
    "room": (room_scene, {}),
}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=list(SCENES))
def scenes(request, tmp_path_factory):
    """(JAX scene, the port's scene of the same arrays, its name)."""
    make, kw = SCENES[request.param]
    jsc = make(jrt, str(tmp_path_factory.mktemp("narrow"))).compile(**kw)
    sc = CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")
    return jsc.device_put(), sc, request.param


def _both(sc, o, d, tmax):
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
    root = sc.meta["bvh_root"]
    t_packet.reset_launches()
    got = t_packet.packet_traverse(sc.bvh_packed, sc.bvh_axis, sc.tri_packed,
                                   *args, root, sc.meta["bvh_root_word"])
    assert t_packet.launches["packet_narrow"] == 0  # CPU: the plain version
    meta = torch.stack([sc.bvh_index, sc.bvh_tri_count, sc.bvh_axis,
                        torch.zeros_like(sc.bvh_index)], dim=1)
    want = j_packet.packet_traverse(
        *(jnp.asarray(x.numpy()) for x in (sc.bvh_packed, meta,
                                           sc.tri_packed, *args)),
        root, max_leaf=sc.meta["max_leaf_tris"], interpret=True,
        packet_size=1024,
    )
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive", "zero"])
def test_narrow_walk_matches_jax(scenes, rand, case):
    _, sc, name = scenes
    n = 900  # not a multiple of the packet size
    o, d = route_rays(rand, name, n)
    if case == "zero":  # whole axes of zero direction components
        d[::4, 0] = 0.0
        d[1::4, 1] = 0.0
        d[2::8, :2] = 0.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = route_tmax(rand, case, n)
    (dst, prim, u, v, front), (jdst, jprim, ju, jv, jfront) = _both(
        sc, o, d, tmax)
    hit = jprim >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    assert hit.sum() > 50
    np.testing.assert_allclose(dst, jdst, **TOL)
    np.testing.assert_array_equal(dst[~hit], tmax[~hit])
    if case == "inactive":
        assert not hit[::3].any()
    differ = assert_tri_ties(sc, o, d, prim, jprim, hit)
    same = ~differ
    np.testing.assert_allclose(u[same], ju[same], **TOL)
    np.testing.assert_allclose(v[same], jv[same], **TOL)
    np.testing.assert_array_equal(front[same], jfront[same])
    np.testing.assert_array_equal(u[~hit], 0.0)


def test_narrow_walk_rejects_bad_inputs(scenes):
    _, sc, _ = scenes
    n = 8
    args = [sc.bvh_packed, sc.bvh_axis, sc.tri_packed, torch.zeros(n, 3),
            torch.ones(n, 3), torch.full((n,), BIG)]
    root, word = sc.meta["bvh_root"], sc.meta["bvh_root_word"]
    with pytest.raises(ValueError, match="root"):
        t_packet.packet_traverse(*args, sc.bvh_packed.shape[0], word)
    with pytest.raises(TypeError):
        t_packet.packet_traverse(*args[:5], args[5].double(), root, word)
    with pytest.raises(TypeError):
        t_packet.packet_traverse(args[0], args[1].long(), *args[2:], root,
                                 word)
    # the root word is checked against the tables on the CPU
    with pytest.raises(ValueError, match="root_word"):
        t_packet.packet_traverse(*args, root, word + 1)
    # only CPU tensors take the plain version: any other device launches
    # the kernel or raises
    with pytest.raises(ValueError, match="no traversal kernel"):
        t_packet.packet_traverse(*(a.to("meta") for a in args), root, word)


@pytest.mark.parametrize("case", ["closest", "clipped"])
def test_narrow_route_matches_jax(scenes, rand, case):
    """``traverse`` and ``traverse_anyhit`` under ``Routing(wide=False)``
    against the JAX package's narrow route (its kernel in interpret mode),
    spheres included on the room scene."""
    jsc, sc, name = scenes
    n = 700
    o, d = route_rays(rand, name, n)
    act = np.ones(n, bool)
    act[::5] = False
    tmax = route_tmax(rand, case, n) if case == "clipped" else None
    rt = Routing(wide=False)
    assert t_traverse.prim_space(sc, rt) == "tri"
    assert j_traverse.prim_space(jsc, JRouting(packet="interpret",
                                               wide=False)) == "tri"
    t_args = [torch.from_numpy(x) for x in (o, d, act)]
    j_args = [jnp.asarray(x) for x in (o, d, act)]
    got = t_traverse.traverse(
        sc, *t_args, tmax=None if tmax is None else torch.from_numpy(tmax),
        routing=rt)
    want = j_traverse.traverse(
        jsc, *j_args, tmax=None if tmax is None else jnp.asarray(tmax),
        raw=True, routing=JRouting(packet="interpret", wide=False),
        need_uv=False)
    kind, jkind = got.kind.numpy(), np.asarray(want.kind)
    np.testing.assert_array_equal(kind, jkind)
    assert (kind == t_traverse.KIND_TRI).sum() > 20
    np.testing.assert_allclose(got.dst.numpy(), np.asarray(want.dst), **TOL)
    tri = kind == t_traverse.KIND_TRI
    assert_tri_ties(sc, o, d, got.prim.numpy(), np.asarray(want.prim), tri)
    np.testing.assert_array_equal(got.prim.numpy()[~tri],
                                  np.asarray(want.prim)[~tri])

    occ_tmax = route_tmax(rand, "clipped", n)
    occ = t_traverse.traverse_anyhit(sc, *t_args, torch.from_numpy(occ_tmax),
                                     routing=rt)
    jocc = j_traverse.traverse_anyhit(
        jsc, *j_args, jnp.asarray(occ_tmax),
        routing=JRouting(packet="interpret", wide=False))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert 0 < occ.sum() < act.sum()
    assert not occ.numpy()[~act].any()


@pytest.mark.parametrize("compiler", ["port", "jax"])
@pytest.mark.parametrize("name", list(SCENES))
def test_meta_holds_the_narrow_root(name, compiler, tmp_path):
    """The narrow route reads its root and the root's word from ``meta``
    (no device read per call): both ways into a CompiledScene (the port's
    compile, and from_numpy of the JAX compiler's arrays) store the first
    object's BVH root and its word, which packs that node's row."""
    make, kw = SCENES[name]
    if compiler == "port":
        sc = make(trt, str(tmp_path)).compile(device="cpu", **kw)
    else:
        jsc = make(jrt, str(tmp_path)).compile(**kw)
        sc = CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")
    root = sc.meta["bvh_root"]
    assert root == int(sc.obj_bvh_root[0])
    word = sc.meta["bvh_root_word"]
    first, count = sc.bvh_packed[root].view(torch.int32)[6:].tolist()
    tag = count if count > 0 else (t_packet.NARROW_INTERIOR
                                   + int(sc.bvh_axis[root]))
    assert word == first << t_packet.NARROW_TAG_BITS | tag
    assert count == 0 and tag > t_packet.NARROW_INTERIOR - 1


def _chain(depth, loose):
    nodes, axis, tris = (torch.from_numpy(x)
                         for x in binary_chain(depth, loose=loose))
    return nodes, axis, tris, t_packet.narrow_root_word(nodes, axis, 0)


def _chain_rays(n, seed, inside):
    """Rays from the middle of a chain's innermost cubes: random
    directions, or (``inside``) directions positive on every axis, which
    enter both children of every node of a loose chain, the interior one
    first."""
    rand = np.random.default_rng(seed)
    o = rand.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    if inside:
        d = np.abs(d) + 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("loose", [False, True])
def test_narrow_walk_on_a_chain_at_the_depth_cap_matches_jax(loose):
    """A binary chain of MAX_TREE_DEPTH interior levels (the host's cap):
    the plain walk holds one pushed leaf per level on rays that enter both
    children everywhere, and equals the JAX kernel's walk."""
    depth = t_packet.MAX_TREE_DEPTH
    nodes, axis, tris, word = _chain(depth, loose)
    assert word == 1 << t_packet.NARROW_TAG_BITS | (
        t_packet.NARROW_INTERIOR + int(axis[0]))
    o, d = _chain_rays(300, 9, inside=loose)
    tmax = np.full(300, BIG, np.float32)
    tmax[::7] = 2.0
    stats = {}
    got = t_packet.packet_traverse_reference(
        nodes, axis, tris, *map(torch.from_numpy, (o, d, tmax)), 0,
        stats=stats)
    if loose:  # every leaf of the chain tested by every ray
        assert stats["tris"] == 300 * len(tris)
    direct = t_packet.packet_traverse(
        nodes, axis, tris, *map(torch.from_numpy, (o, d, tmax)), 0, word)
    for a, b in zip(got, direct):
        assert torch.equal(a, b)
    meta = torch.stack([nodes.view(torch.int32)[:, 6],
                        nodes.view(torch.int32)[:, 7], axis,
                        torch.zeros_like(axis)], dim=1)
    want = j_packet.packet_traverse(
        *(jnp.asarray(x.numpy()) for x in (nodes, meta, tris)),
        *map(jnp.asarray, (o, d, tmax)), 0, max_leaf=3, interpret=True,
        packet_size=1024)
    (dst, prim, *_), (jdst, jprim, *_) = got, want
    np.testing.assert_array_equal(prim.numpy() >= 0, np.asarray(jprim) >= 0)
    assert (prim >= 0).sum() > 100
    np.testing.assert_allclose(dst.numpy(), np.asarray(jdst), **TOL)


@pytest.mark.parametrize("beyond", ["count", "first", "axis"])
def test_narrow_word_limits_refuse_a_bvh_beyond_them(beyond):
    """The compile-time check of the node word's fields: a hand-built BVH
    with a leaf of NARROW_INTERIOR triangles, a first index past
    NARROW_MAX_FIRST or an interior split axis of 3 gets the word -1, which
    the narrow walk refuses with ValueError; the same BVH within the limits
    walks."""
    nodes, axis, tris, word = _chain(4, False)
    assert word >= 0
    ints = nodes.view(torch.int32)
    leaf = int((ints[:, 7] > 0).nonzero()[-1, 0])
    bad_nodes, bad_axis = nodes.clone(), axis.clone()
    if beyond == "count":
        bad_nodes.view(torch.int32)[leaf, 7] = t_packet.NARROW_INTERIOR
    elif beyond == "first":
        bad_nodes.view(torch.int32)[leaf, 6] = t_packet.NARROW_MAX_FIRST + 1
    else:
        bad_axis[0] = 3
    assert t_packet.narrow_root_word(bad_nodes, bad_axis, 0) == -1
    o, d = (torch.from_numpy(x) for x in _chain_rays(8, 2, inside=False))
    tmax = torch.full((8,), BIG)
    with pytest.raises(ValueError, match="beyond the narrow walk"):
        t_packet.packet_traverse(bad_nodes, bad_axis, tris, o, d, tmax, 0, -1)
    got = t_packet.packet_traverse(nodes, axis, tris, o, d, tmax, 0, word)
    assert got[0].shape == (8,)
