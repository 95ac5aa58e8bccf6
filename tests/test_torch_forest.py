"""Forest (non-flattened) scenes: ``compile(flatten_instances=False)``,
the reference renderer's own per-object BVH loop (quirk Q11).

The port walks every instance's tree in turn in object space in one
forest walk (``kernels/packet.py::forest_traverse``; on the CPU its
plain version, ``forest_traverse_reference``, which takes each ray to
object space elementwise in a fixed order and walks the tree with the
narrow walk's plain twin); the JAX package scans the instances with its
gather walk.  Against the JAX forest ``traverse`` and
``traverse_anyhit``: hit masks and instances equal, ``dst`` within
rtol 1e-5, atol 1e-6, ``prim`` equal up to exact-t ties
(``torch_parity.assert_tri_ties``); the transform within rtol 1e-6 of
the JAX package's; renders within the image tolerance of
``torch_parity.assert_images_match``, against the JAX forest render and
against the port's flattened render of the same builder.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.ops import traverse as j_traverse
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch import CompiledScene
from ray_tracer_tpu_torch.kernels import packet as t_packet
from ray_tracer_tpu_torch.ops import traverse as t_traverse
from ray_tracer_tpu_torch.scene.types import narrow_root_meta

from torch_parity import (
    BIG,
    assert_images_match,
    assert_tri_ties,
    room_scene,
    route_rays,
    route_tmax,
    scene_arrays,
    write_obj,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def soup_pair(pkg, tmp, seed=7, n_tris=60, twin=False):
    """One triangle soup placed twice, the second instance rotated, moved
    and scaled unevenly (``tests/test_traverse.py``'s forest scene), or
    with ``twin`` placed where the first is."""
    rand = np.random.default_rng(seed)
    tris = (rand.uniform(-1, 1, (n_tris, 1, 3))
            + rand.uniform(-0.3, 0.3, (n_tris, 3, 3)))
    path = write_obj(os.path.join(tmp, "pair.obj"), tris.reshape(-1, 3),
                     [(3 * i + 1, 3 * i + 2, 3 * i + 3)
                      for i in range(n_tris)])
    b = pkg.SceneBuilder()
    b.add_material(pkg.Material())
    b.add_material(pkg.Material(albedo=(0.9, 0.3, 0.2)))
    b.add_obj(path, material=0)
    if twin:
        b.add_obj(path, material=1)
    else:
        b.add_obj(path, material=1, position=(0.5, 0.2, 0.1),
                  rotation_deg=(10, 20, 30), scale=(1.1, 0.9, 1.0))
    return b


SCENES = {"room": room_scene, "soup_pair": soup_pair}


@pytest.fixture(scope="module", params=list(SCENES))
def forest(request, tmp_path_factory):
    """(JAX forest scene, the port's forest scene of the same builder,
    the port's flattened scene, its name)."""
    tmp = str(tmp_path_factory.mktemp("forest"))
    make = SCENES[request.param]
    jsc = make(jrt, tmp).compile(flatten_instances=False).device_put()
    tb = make(trt, tmp)
    return (jsc, tb.compile(flatten_instances=False, device="cpu"),
            tb.compile(device="cpu"), request.param)


def _rays(name, n=2048, seed=11):
    rand = np.random.default_rng(seed)
    return route_rays(rand, "room" if name == "room" else "soup", n)


def _jhit(jsc, o, d, tmax):
    act = jnp.asarray(tmax > -BIG)
    return j_traverse.traverse(jsc, jnp.asarray(o), jnp.asarray(d), act,
                               tmax=jnp.asarray(np.where(tmax > -BIG, tmax,
                                                         BIG)))


@pytest.mark.parametrize("case", ["open", "clipped", "inactive"])
def test_forest_traverse_matches_jax(forest, case):
    jsc, sc, _, name = forest
    o, d = _rays(name)
    tmax = route_tmax(np.random.default_rng(3), case, o.shape[0])
    want = _jhit(jsc, o, d, tmax)
    act = torch.from_numpy(tmax > -BIG)
    got = t_traverse.traverse(
        sc, torch.from_numpy(o), torch.from_numpy(d), act,
        tmax=torch.from_numpy(np.where(tmax > -BIG, tmax, BIG)))
    hit = got.did_hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(want.did_hit))
    assert hit.any()
    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(want.kind))
    tri = got.kind.numpy() == t_traverse.KIND_TRI
    np.testing.assert_array_equal(got.obj.numpy()[tri],
                                  np.asarray(want.obj)[tri])
    np.testing.assert_allclose(got.dst.numpy()[hit],
                               np.asarray(want.dst)[hit], **TOL)
    prim, jprim = got.prim.numpy(), np.asarray(want.prim)
    differ = assert_tri_ties(sc, o, d, prim, jprim, tri,
                             obj=got.obj.numpy())
    same = tri & ~differ
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[same],
                                   np.asarray(getattr(want, f))[same],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.front.numpy()[hit & ~differ],
                                  np.asarray(want.front)[hit & ~differ])


@pytest.mark.parametrize("case", ["clipped", "inactive"])
def test_forest_anyhit_matches_jax(forest, case):
    jsc, sc, _, name = forest
    o, d = _rays(name, seed=12)
    tmax = route_tmax(np.random.default_rng(4), case, o.shape[0])
    tmax = np.where(tmax > -BIG, np.minimum(tmax, 3.0), tmax)
    act = tmax > -BIG
    want = np.asarray(j_traverse.traverse_anyhit(
        jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(act),
        jnp.asarray(np.where(act, tmax, BIG))))
    got = t_traverse.traverse_anyhit(
        sc, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act),
        torch.from_numpy(np.where(act, tmax, BIG))).numpy()
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


def _reference_args(sc):
    return (sc.bvh_packed, sc.bvh_axis, sc.tri_packed, sc.obj_inv_transform,
            sc.meta["obj_roots"])


@pytest.mark.parametrize("mode", ["closest", "anyhit"])
@pytest.mark.parametrize("case", ["open", "clipped", "inactive"])
def test_forest_reference_matches_jax(forest, case, mode):
    """The forest walk's plain version alone, given the bound the sphere
    pass leaves (``traverse._sphere_hits``), against the JAX forest
    ``traverse`` and ``traverse_anyhit``: the triangle hits, instances and
    occlusion equal, ``dst`` at the file's tolerances."""
    jsc, sc, _, name = forest
    o, d = _rays(name, seed=15)
    tmax = route_tmax(np.random.default_rng(6), case, o.shape[0])
    if mode == "anyhit":
        tmax = np.where(tmax > -BIG, np.minimum(tmax, 3.0), tmax)
    act = tmax > -BIG
    bound = np.where(act, tmax, BIG)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    best = t_traverse._sphere_hits(sc, to, td, torch.from_numpy(act),
                                   torch.from_numpy(bound))
    if mode == "anyhit":
        got = t_packet.forest_traverse_reference(
            *_reference_args(sc), to, td, torch.from_numpy(
                np.where(act, tmax, -BIG)), anyhit=True)
        occ = torch.zeros_like(got)
        if sc.n_spheres:
            s_dst, _ = t_traverse._sphere_dst(sc, to, td)
            occ = torch.min(s_dst, dim=1).values < torch.from_numpy(bound)
        want = np.asarray(j_traverse.traverse_anyhit(
            jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(act),
            jnp.asarray(bound)))
        assert want.any() and not want.all()
        np.testing.assert_array_equal(((got | occ) & torch.from_numpy(act))
                                      .numpy(), want)
        return
    tmax0 = torch.where(torch.from_numpy(act), best.dst, -BIG)
    dst, prim, obj, u, v, front = t_packet.forest_traverse_reference(
        *_reference_args(sc), to, td, tmax0)
    want = _jhit(jsc, o, d, tmax)
    tri = prim.numpy() >= 0
    np.testing.assert_array_equal(
        tri, np.asarray(want.kind) == t_traverse.KIND_TRI)
    assert tri.any()
    np.testing.assert_array_equal(obj.numpy()[tri], np.asarray(want.obj)[tri])
    np.testing.assert_array_equal(obj.numpy()[~tri], -1)
    np.testing.assert_allclose(dst.numpy()[tri], np.asarray(want.dst)[tri],
                               **TOL)
    np.testing.assert_array_equal(dst.numpy()[~tri], tmax0.numpy()[~tri])
    differ = assert_tri_ties(sc, o, d, prim.numpy(), np.asarray(want.prim),
                             tri, obj=obj.numpy())
    same = tri & ~differ
    for got_f, f in ((u, "u"), (v, "v")):
        np.testing.assert_allclose(got_f.numpy()[same],
                                   np.asarray(getattr(want, f))[same],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(front.numpy()[same],
                                  np.asarray(want.front)[same])


def test_object_ray_matches_jax_transform(forest):
    """The forest walk's transform (``packet.object_ray``, elementwise in
    the JAX form's order) against the JAX package's ``_transform_point``
    and ``_transform_dir`` on every instance, within rtol 1e-6."""
    _, sc, _, name = forest
    o, d = _rays(name, n=512, seed=16)
    for k in range(sc.meta["n_objects"]):
        m = sc.obj_inv_transform[k]
        got_o, got_d = t_packet.object_ray(m, torch.from_numpy(o),
                                           torch.from_numpy(d))
        jm = jnp.broadcast_to(jnp.asarray(m.numpy()), (o.shape[0], 4, 4))
        np.testing.assert_allclose(
            got_o.numpy(), np.asarray(j_traverse._transform_point(
                jm, jnp.asarray(o))), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            got_d.numpy(), np.asarray(j_traverse._transform_dir(
                jm, jnp.asarray(d))), rtol=1e-6, atol=1e-7)


def _one_instance(sc, k):
    """``sc`` cut to its instance ``k`` (a forest of one)."""
    return dataclasses.replace(
        sc, obj_inv_transform=sc.obj_inv_transform[k:k + 1].contiguous(),
        meta={**sc.meta, "n_objects": 1,
              "obj_roots": sc.meta["obj_roots"][k:k + 1],
              "obj_root_words": sc.meta["obj_root_words"][k:k + 1],
              "forest_cull": sc.meta["forest_cull"][k:k + 1]})


@pytest.mark.parametrize("anyhit", [False, True])
def test_forest_walk_of_one_instance(forest, anyhit):
    """A forest of one instance is that instance's narrow walk in object
    space, field for field (through the wrapper, whose CPU path checks
    the root words)."""
    _, sc, _, name = forest
    one = _one_instance(sc, 1)
    o, d = (torch.from_numpy(x) for x in _rays(name, seed=17))
    tmax0 = torch.from_numpy(route_tmax(np.random.default_rng(7), "inactive",
                                        o.shape[0]))
    roots, words = one.forest_roots
    got = t_packet.forest_traverse(
        one.bvh_packed, one.bvh_axis, one.tri_packed, one.obj_inv_transform,
        roots, words, one.forest_cull, o, d, tmax0, anyhit=anyhit)
    oo, dd = t_packet.object_ray(one.obj_inv_transform[0], o, d)
    t, p, u, v, f = t_packet.packet_traverse_reference(
        one.bvh_packed, one.bvh_axis, one.tri_packed, oo, dd, tmax0,
        one.meta["obj_roots"][0])
    assert (p >= 0).any()
    if anyhit:
        assert torch.equal(got, p >= 0)
        return
    obj = torch.where(p >= 0, 0, -1).to(torch.int32)
    for a, b in zip(got, (t, p, obj, u, v, f)):
        assert torch.equal(a, b)


def test_forest_walk_ray_missing_every_root(forest):
    """Rays that enter no instance's root box: no hit, ``dst`` their
    bound, ``prim`` and ``obj`` -1, ``u``, ``v`` 0, not facing; not
    occluded."""
    _, sc, _, _ = forest
    n = 64
    o = torch.full((n, 3), 50.0)
    d = torch.nn.functional.normalize(torch.rand(n, 3) + 0.1, dim=1)
    tmax0 = torch.full((n,), BIG)
    tmax0[::4] = 2.0
    dst, prim, obj, u, v, front = t_packet.forest_traverse_reference(
        *_reference_args(sc), o, d, tmax0)
    assert torch.equal(dst, tmax0)
    assert (prim == -1).all() and (obj == -1).all()
    assert (u == 0).all() and (v == 0).all() and not front.any()
    assert not t_packet.forest_traverse_reference(
        *_reference_args(sc), o, d, tmax0, anyhit=True).any()


def test_forest_walk_ties_go_to_the_first_instance(tmp_path):
    """Two instances of one mesh in the same place meet every ray at the
    same t: the first in order is kept (a later instance replaces an
    earlier one only at a strictly smaller t); under occlusion a lane
    stops at its first instance, so only the lanes that missed it are
    taken to the second's object space."""
    sc = soup_pair(trt, str(tmp_path), twin=True).compile(
        flatten_instances=False, device="cpu")
    assert sc.meta["n_objects"] == 2
    rand = np.random.default_rng(18)
    o = torch.from_numpy(rand.uniform(-4, 4, (2048, 3)).astype(np.float32))
    aim = torch.from_numpy(rand.uniform(-1, 1, (2048, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(aim - o, dim=1)
    tmax0 = torch.full((o.shape[0],), BIG)
    dst, prim, obj, _, _, _ = t_packet.forest_traverse_reference(
        *_reference_args(sc), o, d, tmax0)
    hit = prim >= 0
    assert hit.float().mean() > 0.2
    assert (obj[hit] == 0).all()
    first = t_packet.forest_traverse_reference(
        *_reference_args(_one_instance(sc, 0)), o, d, tmax0)
    assert torch.equal(dst, first[0]) and torch.equal(prim, first[1])
    stats = {}
    occ = t_packet.forest_traverse_reference(
        *_reference_args(sc), o, d, tmax0, anyhit=True, stats=stats)
    assert torch.equal(occ, hit)
    assert stats["scans"] == o.shape[0] + int((~hit).sum())


def test_forest_traverse_matches_flattened(forest):
    """The forest walk and the flattened scene's default route see the
    same geometry: hit masks equal, ``dst`` within the tolerance of
    ``tests/test_traverse.py``'s forest check, and instances equal but
    where two instances meet the ray at the same t (the room's boxes
    stand on its floor): there each tree's walk order picks one."""
    _, sc, flat, name = forest
    o, d = _rays(name, seed=13)
    act = torch.ones(o.shape[0], dtype=torch.bool)
    args = (torch.from_numpy(o), torch.from_numpy(d), act)
    a = t_traverse.traverse(sc, *args)
    b = t_traverse.traverse(flat, *args, raw=False)
    hit = a.did_hit.numpy()
    np.testing.assert_array_equal(hit, b.did_hit.numpy())
    np.testing.assert_allclose(a.dst.numpy()[hit], b.dst.numpy()[hit],
                               rtol=2e-4, atol=1e-5)
    tri = a.kind.numpy() == t_traverse.KIND_TRI
    moved = tri & (a.obj.numpy() != b.obj.numpy())
    assert moved.mean() < (0.01 if name == "room" else 1e-9)


@pytest.mark.parametrize("tmax", [None, "clipped"])
def test_forest_counting_walk_matches_jax(forest, tmax):
    """The heatmaps' counting walk, instance by instance: box and triangle
    test counts equal the JAX walk's ray by ray."""
    jsc, sc, _, name = forest
    o, d = _rays(name, n=512, seed=14)
    act = np.ones(o.shape[0], bool)
    act[::5] = False
    tm = None
    if tmax:
        tm = np.random.default_rng(5).uniform(0.1, 4.0, o.shape[0])
        tm = tm.astype(np.float32)
    jh, (jb, jt) = j_traverse.traverse_with_stats(
        jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(act),
        tmax=None if tm is None else jnp.asarray(tm))
    th, (tb, tt) = t_traverse.traverse_with_stats(
        sc, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act),
        tmax=None if tm is None else torch.from_numpy(tm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(th.kind.numpy(), np.asarray(jh.kind))
    tri = th.kind.numpy() == t_traverse.KIND_TRI
    np.testing.assert_array_equal(th.prim.numpy()[tri],
                                  np.asarray(jh.prim)[tri])
    np.testing.assert_array_equal(th.obj.numpy()[tri],
                                  np.asarray(jh.obj)[tri])


def test_forest_root_words(forest):
    """Every instance's root and its narrow-walk word are computed at
    compile; the JAX package's forest tables give the same ones, and the
    tallest tree stays within the walks' stack."""
    jsc, sc, _, _ = forest
    roots = [int(r) for r in sc.obj_bvh_root.numpy()]
    assert list(sc.meta["obj_roots"]) == roots
    assert len(set(roots)) < len(roots) or len(roots) == 2
    assert list(sc.meta["obj_root_words"]) == [
        t_packet.narrow_root_word(sc.bvh_packed, sc.bvh_axis, r)
        for r in roots]
    assert min(sc.meta["obj_root_words"]) >= 0
    jarr, jmeta = scene_arrays(jsc)
    from_jax = CompiledScene.from_numpy(jarr, jmeta, device="cpu")
    for k, v in narrow_root_meta(jarr).items():
        assert sc.meta[k] == v == from_jax.meta[k], k


FRAME = dict(width=23, height=19, samples_per_pixel=2, bounce_limit=4)
RENDERS = {  # the port's changes, the JAX package's
    "wavefront": ({}, {}),
    "closest_nee": (dict(nee_anyhit=False), dict(nee_anyhit=False)),
    "static_scan": (dict(path_regen=False), dict(path_regen=False)),
    "unbinned": (dict(bin_rays=False), dict(bin_rays=False)),
}


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The room scene as a forest in both packages, and flattened in the
    port."""
    tmp = str(tmp_path_factory.mktemp("room"))
    jsc = room_scene(jrt, tmp).compile(flatten_instances=False).device_put()
    tb = room_scene(trt, tmp)
    return (jsc, tb.compile(flatten_instances=False, device="cpu"),
            tb.compile(device="cpu"))


@pytest.mark.parametrize("what", list(RENDERS))
def test_forest_render_matches_jax(room, what):
    """The forest frame against the JAX forest frame (its packet mode is
    off on forest scenes: the gather walk) and against the port's
    flattened frame."""
    jsc, sc, flat = room
    tkw, jkw = RENDERS[what]
    want = np.asarray(jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(packet="off"), **FRAME, **jkw)))
    got = trt.render(sc, trt.RenderConfig(**FRAME, **tkw)).numpy()
    assert got.mean() > 0.05
    assert_images_match(got, want)
    assert_images_match(got, trt.render(flat, trt.RenderConfig(
        **FRAME, **tkw)).numpy())


def test_forest_render_debug_matches_jax(room):
    """The heatmaps over whole paths on a forest scene: equal to the JAX
    heatmaps but in at most 2% of the pixels (a diverged path)."""
    jsc, sc, _ = room
    kw = dict(width=17, height=15, samples_per_pixel=1, bounce_limit=3)
    caps = dict(box_cap=120.0, tri_cap=30.0)
    want = np.asarray(jrt.render_debug(jsc, jrt.RenderConfig(**kw), mode=2,
                                       **caps))
    got = trt.render_debug(sc, trt.RenderConfig(**kw), mode=2,
                           **caps).numpy()
    assert 0.0 < got.mean() < 1.0
    assert (got != want).any(axis=-1).mean() <= 0.02
