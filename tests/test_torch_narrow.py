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
from ray_tracer_tpu_torch import CompiledScene, Routing
from ray_tracer_tpu_torch.kernels import packet as t_packet
from ray_tracer_tpu_torch.ops import traverse as t_traverse

from torch_parity import (
    assert_tri_ties,
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
    root = int(sc.obj_bvh_root[0])
    t_packet.reset_launches()
    got = t_packet.packet_traverse(sc.bvh_packed, sc.bvh_axis, sc.tri_packed,
                                   *args, root)
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
    with pytest.raises(ValueError, match="root"):
        t_packet.packet_traverse(*args, sc.bvh_packed.shape[0])
    with pytest.raises(TypeError):
        t_packet.packet_traverse(*args[:5], args[5].double(), 0)
    with pytest.raises(TypeError):
        t_packet.packet_traverse(args[0], args[1].long(), *args[2:], 0)
    # only CPU tensors take the plain version: any other device launches
    # the kernel or raises
    with pytest.raises(ValueError, match="no traversal kernel"):
        t_packet.packet_traverse(*(a.to("meta") for a in args), 0)


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
