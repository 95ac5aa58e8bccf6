"""Whole-frame parity of the torch port with the JAX package, on CPU.

The port renders through its plain traversal on CPU tensors.  The
sphere_diffuse frame (against the JAX package run op by op) and the
sponza_proxy frame match on every pixel within atol=2e-3; the golden and
the room scene, whose paths meet exact-t ties on box edges and XLA's
contracted FMAs, match within atol=2e-3 except for rare diverged sample
paths (see ``torch_parity.assert_images_match``)."""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.scene import presets as j_presets
from ray_tracer_tpu_torch.scene import presets as t_presets

from torch_parity import assert_images_match, room_scene, sponza_builders

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("room"))
    return (room_scene(jrt, tmp).compile().device_put(),
            room_scene(trt, tmp).compile(device="cpu"))


def test_sphere_diffuse_golden():
    """2 of the 1600 pixels diverge: the golden holds XLA's rounding."""
    golden = np.load(
        os.path.join(GOLDEN, "sphere_diffuse_40x40_8spp.npy")
    ).astype(np.float32)
    cfg = trt.RenderConfig(width=40, height=40, samples_per_pixel=8,
                           bounce_limit=6)
    img = trt.render(t_presets.sphere_diffuse().compile(device="cpu"), cfg)
    assert_images_match(img.numpy(), golden)


def test_sphere_diffuse_matches_unfused_jax():
    """Every pixel within atol=2e-3 of the JAX package run op by op: with
    no XLA fusion (so no contracted FMAs) the integrators agree to the last
    bits, and the two golden pixels that the port misses above are XLA's
    rounding, not a difference of the port."""
    cfg = dict(width=40, height=40, samples_per_pixel=8, bounce_limit=6)
    img = trt.render(t_presets.sphere_diffuse().compile(device="cpu"),
                     trt.RenderConfig(**cfg))
    with jax.disable_jit():
        want = jrt.render(j_presets.sphere_diffuse().compile().device_put(),
                          jrt.RenderConfig(**cfg))
    np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=2e-3)


def test_sponza_proxy_matches_jax(tmp_path, monkeypatch):
    """The main-path scene, cut to 8k triangles, at 160x90, spp 2, bounce 8:
    every pixel within atol=2e-3 of the JAX package's binned render."""
    jb, tb = sponza_builders(str(tmp_path), monkeypatch, 8000)
    cfg = dict(width=160, height=90, samples_per_pixel=2, bounce_limit=8)
    want = jrt.render(jb.compile().device_put(), jrt.RenderConfig(
        routing=JRouting(packet="off"), bin_rays=True, **cfg))
    img = trt.render(tb.compile(device="cpu"), trt.RenderConfig(**cfg))
    np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=2e-3)


def test_room_matches_jax_group_kernel_route(room):
    """40x40, spp 8, bounce 6 against the JAX kernel route: the group
    kernel itself (Pallas interpret mode) for closest hit and occlusion."""
    jsc, tsc = room
    kw = dict(width=40, height=40, samples_per_pixel=8, bounce_limit=6)
    want = jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(packet="interpret", groups=4, groups_packet=512),
        **kw,
    ))
    got = trt.render(tsc, trt.RenderConfig(**kw))
    assert_images_match(got.numpy(), np.asarray(want))


ROUTE_CFG = dict(width=32, height=32, samples_per_pixel=4, bounce_limit=6)
ROUTES = {
    "cluster": dict(cluster="on"),
    "cluster_boxes": dict(cluster="on", cluster_enum="boxes"),
    "packet": dict(groups=0, anyhit_group=False),
}


@pytest.fixture(scope="module")
def room_clusters(tmp_path_factory):
    """The room scene with cluster tables (clusters of 16 triangles), and
    each package's image of it on its default (group kernel) route."""
    tmp = str(tmp_path_factory.mktemp("room_clusters"))
    jsc = room_scene(jrt, tmp).compile(cluster_t_c=16).device_put()
    ref = jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(packet="interpret", groups=4, groups_packet=512),
        **ROUTE_CFG))
    tsc = room_scene(trt, tmp).compile(cluster_t_c=16, device="cpu")
    own = trt.render(tsc, trt.RenderConfig(**ROUTE_CFG))
    return jsc, tsc, np.asarray(ref), own.numpy()


def _moved(a, b):
    """(H,W) bool: pixels that differ by more than 2e-3."""
    return np.abs(a - b).max(axis=-1) > 2e-3


@pytest.mark.parametrize("route", list(ROUTES))
def test_room_matches_jax_route(room_clusters, route):
    """32x32, spp 4, bounce 6 through the cluster route (both enumerations)
    and the packet walk, against the JAX package on the same route, its
    kernels in Pallas interpret mode.

    The glass box stands on the floor: its bottom face lies in the
    floor's plane, so a ray that reaches it meets two triangles of two
    materials at exactly the same t, and each route's tie rule picks the
    pixel's path.  The group walks keep the first triangle visited, the
    port's cluster route the lowest global id, and the JAX cluster
    kernel's min-tree neither (it moves 8 of these 1024 pixels off its
    own group-route image).  Ray by ray, the cluster and group routes of
    either package part only at such ties: no hit mask or distance
    differs.  So the cluster routes must reproduce the group-route image
    by the usual criterion; the port's cluster route may leave its own
    group-route image in at most 2 pixels (1 on this render); and every
    pixel where it departs from the JAX cluster route must be a pixel
    where one of the two packages' cluster routes leaves its own group
    route."""
    jsc, tsc, group_img, own_group_img = room_clusters
    kw = ROUTES[route]
    want = np.asarray(jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(packet="interpret", **kw), **ROUTE_CFG)))
    got = trt.render(tsc, trt.RenderConfig(routing=trt.Routing(**kw),
                                           **ROUTE_CFG)).numpy()
    if route == "packet":
        assert_images_match(got, want)
        return
    assert_images_match(got, group_img)
    own_ties = _moved(got, own_group_img)
    jax_ties = _moved(want, group_img)
    assert own_ties.sum() <= 2, np.argwhere(own_ties)
    stray = _moved(got, want) & ~own_ties & ~jax_ties
    assert not stray.any(), np.argwhere(stray)


TRI_ROUTE_CFG = dict(width=32, height=32, samples_per_pixel=2,
                     bounce_limit=6)
TRI_ROUTES = {  # the port's routing, the JAX package's for the same route
    "narrow": (dict(wide=False), dict(packet="interpret", wide=False)),
    "lanewalk": (dict(lanewalk="force"),
                 dict(packet="off", lanewalk="interpret")),
}


@pytest.fixture(scope="module")
def room_ropes(tmp_path_factory):
    """The room scene with rope streams (the JAX package builds them by
    default), and each package's image of it on its group-kernel route."""
    tmp = str(tmp_path_factory.mktemp("room_ropes"))
    jsc = room_scene(jrt, tmp).compile().device_put()
    ref = jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(packet="interpret", groups=4, groups_packet=512),
        **TRI_ROUTE_CFG))
    tsc = room_scene(trt, tmp).compile(rope_streams=True, device="cpu")
    own = trt.render(tsc, trt.RenderConfig(**TRI_ROUTE_CFG))
    return jsc, tsc, np.asarray(ref), own.numpy()


@pytest.mark.parametrize("route", list(TRI_ROUTES))
def test_room_matches_jax_tri_route(room_ropes, route):
    """32x32, spp 2, bounce 6 through the narrow route and the rope walk,
    whose hits are global triangle ids (``shade_tri`` rows), against the
    JAX package on the same route, its kernels in Pallas interpret mode,
    and against the port's own group-route image.  Ray by ray these routes
    part from the group route only at exact-t ties (the visit order picks
    the triangle); on this render no pixel moves, in either package."""
    jsc, tsc, group_img, own_group_img = room_ropes
    tkw, jkw = TRI_ROUTES[route]
    want = np.asarray(jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(**jkw), **TRI_ROUTE_CFG)))
    got = trt.render(tsc, trt.RenderConfig(routing=trt.Routing(**tkw),
                                           **TRI_ROUTE_CFG)).numpy()
    assert_images_match(got, want)
    assert_images_match(got, group_img)
    moved = _moved(got, own_group_img)
    assert not moved.any(), np.argwhere(moved)


def test_room_drain_phases_match_jax(room):
    """128x128 spp 2 = 32,768 lanes: the smallest wavefront at which one
    multi-phase drain step runs (widths 32768 -> 8192)."""
    jsc, tsc = room
    kw = dict(width=128, height=128, samples_per_pixel=2, bounce_limit=3)
    want = jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(packet="off"), bin_rays=True, **kw
    ))
    got = trt.render(tsc, trt.RenderConfig(**kw))
    assert_images_match(got.numpy(), np.asarray(want))


CHANGES = {  # the port's value, the JAX package's on its binned walk
    "closest_nee": ({"nee_anyhit": False}, {"nee_anyhit": False}),
    "normal_maps": ({"enable_normal_maps": True},
                    {"enable_normal_maps": True}),
    "unbinned": ({"bin_rays": False}, {"bin_rays": False}),
    "bin_leaf": ({"routing": trt.Routing(bin_mode="leaf")},
                 {"routing": JRouting(packet="off", bin_mode="leaf")}),
    "prebin_nosort": ({"routing": trt.Routing(nee_prebin="nosort")},
                      {"routing": JRouting(packet="off",
                                           nee_prebin="nosort")}),
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_config_values_match_jax(room, change):
    """The values that once raised render the room at 24x20, spp 2, bounce
    3 as the JAX package does with the same value; the room has no bump
    map and no emitter between a surface and its light, so each image is
    also the port's default image (bit for bit, but for the closest-hit
    resolve's own rounding)."""
    jsc, tsc = room
    kw = dict(width=24, height=20, samples_per_pixel=2, bounce_limit=3)
    tkw, jkw = CHANGES[change]
    jkw = {"routing": JRouting(packet="off"), "bin_rays": True, **jkw}
    got = trt.render(tsc, trt.RenderConfig(**kw, **tkw))
    want = np.asarray(jrt.render(jsc, jrt.RenderConfig(**kw, **jkw)))
    assert_images_match(got.numpy(), want)
    default = trt.render(tsc, trt.RenderConfig(**kw))
    if change == "closest_nee":
        np.testing.assert_allclose(got.numpy(), default.numpy(), atol=1e-6)
    else:
        assert torch.equal(got, default)


def test_forest_scene_matches_jax_kernel_route(room, tmp_path):
    """The room compiled as a forest (``flatten_instances=False``) against
    the JAX package's flattened kernel route and the port's flattened
    image, 40x40, spp 4, bounce 6."""
    jsc, tsc = room
    sc = room_scene(trt, str(tmp_path)).compile(flatten_instances=False,
                                                device="cpu")
    kw = dict(width=40, height=40, samples_per_pixel=4, bounce_limit=6)
    want = jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(packet="interpret", groups=4, groups_packet=512),
        **kw,
    ))
    got = trt.render(sc, trt.RenderConfig(**kw)).numpy()
    assert_images_match(got, np.asarray(want))
    assert_images_match(got, trt.render(tsc, trt.RenderConfig(**kw)).numpy())
