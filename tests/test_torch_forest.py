"""Forest (non-flattened) scenes: ``compile(flatten_instances=False)``,
the reference renderer's own per-object BVH loop (quirk Q11).

The port walks each instance's tree in turn in object space with the
narrow walk (on the CPU its plain twin); the JAX package scans the
instances with its gather walk.  Against the JAX forest ``traverse`` and
``traverse_anyhit``: hit masks and instances equal, ``dst`` within
rtol 1e-5, atol 1e-6, ``prim`` equal up to exact-t ties
(``torch_parity.assert_tri_ties``); renders within the image tolerance
of ``torch_parity.assert_images_match``, against the JAX forest render
and against the port's flattened render of the same builder.
"""

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


def soup_pair(pkg, tmp, seed=7, n_tris=60):
    """One triangle soup placed twice, the second instance rotated, moved
    and scaled unevenly (``tests/test_traverse.py``'s forest scene)."""
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
