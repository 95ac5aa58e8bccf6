"""The port's static-scan integrator and debug heatmaps against the JAX
package's, on CPU.

``render`` with ``path_regen=False`` or an ``estimator`` ablation runs
``integrator/wavefront.py::trace`` one sample at a time; ``render_debug``
runs it with the counting walk (``ops/traverse.py::traverse_with_stats``).
The scene is the room of ``torch_parity.room_scene`` (triangles, spheres,
a rect light, the sky), compiled by the JAX package and handed to the
port (``CompiledScene.from_numpy``), so both walk the same tables.
Images agree at ``atol=2e-3`` up to the rare pixels whose path XLA's
contracted arithmetic sends the other way
(``torch_parity.assert_images_match``).  The box and triangle counts of
one traversal are equal; a heatmap sums them over whole paths, so its
pixels are equal except where such a path diverges.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.ops import traverse as j_traverse
from ray_tracer_tpu_torch import CompiledScene
from ray_tracer_tpu_torch.api import _camera_arrays, scene_camera
from ray_tracer_tpu_torch.integrator import wavefront
from ray_tracer_tpu_torch.kernels import group
from ray_tracer_tpu_torch.ops import traverse as t_traverse

from torch_parity import assert_images_match, room_scene, route_rays, \
    scene_arrays

# odd sizes: no camera ray has an exactly zero x or y direction
KW = dict(width=25, height=23, samples_per_pixel=2, bounce_limit=4)


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """(JAX scene on the device, the port's scene of the same arrays)."""
    tmp = str(tmp_path_factory.mktemp("room"))
    jsc = room_scene(jrt, tmp).compile()
    tsc = CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")
    return jsc.device_put(), tsc


def _render_both(room, **kw):
    jsc, tsc = room
    want = jrt.render(jsc, jrt.RenderConfig(routing=JRouting(packet="off"),
                                            **{**KW, **kw}))
    got = trt.render(tsc, trt.RenderConfig(**{**KW, **kw}))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("change", [
    {"path_regen": False},
    {"path_regen": False, "estimator": "cosine"},
    {"estimator": "cosine"},
    {"estimator": "uniform"},
    {"path_regen": False, "nee_anyhit": False},
    {"path_regen": False, "nee_anyhit": False, "sort_bounce_rays": True},
])
def test_static_scan_matches_jax(room, change):
    got, want = _render_both(room, **change)
    assert float(got.mean()) > 0.05
    assert_images_match(got, want)


def test_estimators_differ(room):
    """The ablations trace no shadow rays: their images differ from the
    NEE estimator's and from each other's."""
    _, tsc = room
    imgs = [trt.render(tsc, trt.RenderConfig(estimator=e, **KW))
            for e in ("mis", "cosine", "uniform")]
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert float((imgs[a] - imgs[b]).abs().mean()) > 1e-3


def test_static_scan_runs_the_group_kernel(room, monkeypatch):
    """On the default route the static scan takes closest hit and
    occlusion from ``group.group_traverse``, as the wavefront does."""
    _, tsc = room
    calls = []
    walk = group.group_traverse

    def record(*args, anyhit=False):
        calls.append(anyhit)
        return walk(*args, anyhit=anyhit)

    monkeypatch.setattr(group, "group_traverse", record)
    trt.render(tsc, trt.RenderConfig(path_regen=False, **KW))
    # per sample: the primary rays, then bounce and shadow rays at each
    # of the 5 bounces (the last bounce's, all lanes dead, are never read,
    # as in the JAX scan)
    assert calls.count(False) == 2 * 6 and calls.count(True) == 2 * 5


def test_trace_ray_counts_match_jax(room):
    """``trace(with_stats=True)``: the semantic and traced ray counts."""
    from ray_tracer_tpu.integrator import wavefront as j_wavefront

    jsc, tsc = room
    cfg = trt.RenderConfig(path_regen=False, **KW)
    jcfg = jrt.RenderConfig(path_regen=False,
                            routing=JRouting(packet="off"), **KW)
    cam = _camera_arrays(scene_camera(tsc), cfg, "cpu")
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32)
    rays = wavefront.raygen(*cam, ids, cfg.width, cfg.height)
    got, n_rays = wavefront.trace(tsc, rays, ids, 0, 1, cfg,
                                  with_stats=True)
    jrays = j_wavefront.CameraRays(jnp.asarray(rays.origin.numpy()),
                                   jnp.asarray(rays.direction.numpy()))
    want, j_rays = j_wavefront.trace(jsc, jrays, jnp.asarray(ids.numpy()),
                                     jnp.int32(0), jnp.int32(1), jcfg,
                                     with_stats=True)
    assert_images_match(got.numpy().reshape(23, 25, 3),
                        np.asarray(want).reshape(23, 25, 3))
    np.testing.assert_allclose(n_rays.numpy(), np.asarray(j_rays),
                               rtol=2e-3)
    assert n_rays[0] > n_rays[1] > cfg.n_pixels


def test_traverse_with_stats_matches_jax(room):
    """Per-ray box and triangle test counts, hit kind, triangle and
    distance of the counting walk, on rays inside the room (a quarter
    straight down, every seventh lane inactive) with per-lane bounds."""
    jsc, tsc = room
    rand = np.random.default_rng(3)
    n = 3000
    o, d = route_rays(rand, "room", n)
    tmax = rand.uniform(0.5, 6.0, n).astype(np.float32)
    tmax[::3] = 99999999.0
    act = np.ones(n, bool)
    act[::7] = False
    jhit, (jbox, jtri) = j_traverse.traverse_with_stats(
        jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(act),
        tmax=jnp.asarray(tmax))
    hit, (box, tri) = t_traverse.traverse_with_stats(
        tsc, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(act), tmax=torch.from_numpy(tmax))
    np.testing.assert_array_equal(box.numpy(), np.asarray(jbox))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    np.testing.assert_array_equal(hit.kind.numpy(), np.asarray(jhit.kind))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(jhit.prim))
    np.testing.assert_allclose(hit.dst.numpy(), np.asarray(jhit.dst),
                               rtol=1e-5, atol=1e-6)
    assert (box.numpy()[~act] == 0).all() and box.numpy()[act].min() >= 1
    assert np.unique(box.numpy()).size > 10  # lanes end at many steps


def test_traverse_with_stats_agrees_with_traverse(room):
    """The counting walk finds the closest hit the group route finds."""
    _, tsc = room
    rand = np.random.default_rng(4)
    o, d = (torch.from_numpy(x) for x in route_rays(rand, "room", 2000))
    act = torch.ones(2000, dtype=torch.bool)
    hit, _ = t_traverse.traverse_with_stats(tsc, o, d, act)
    ref = t_traverse.traverse(tsc, o, d, act)
    assert torch.equal(hit.kind, ref.kind)
    torch.testing.assert_close(hit.dst, ref.dst, rtol=1e-5, atol=1e-6)
    tri = ref.kind == t_traverse.KIND_TRI
    slot_tri = tsc.leaf_map[ref.prim[tri].long()]
    assert (hit.prim[tri] == slot_tri).float().mean() > 0.99  # exact ties


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_render_debug_matches_jax(room, mode):
    """The heatmaps at 17x15, spp 2, bounce 3, caps low enough that some
    pixels pass them: equal to the JAX heatmaps but in at most 2% of the
    pixels (a diverged path)."""
    jsc, tsc = room
    kw = dict(width=17, height=15, samples_per_pixel=2, bounce_limit=3)
    caps = dict(box_cap=120.0, tri_cap=30.0)
    want = np.asarray(jrt.render_debug(jsc, jrt.RenderConfig(**kw),
                                       mode=mode, **caps))
    got = trt.render_debug(tsc, trt.RenderConfig(**kw), mode=mode, **caps)
    got = got.numpy()
    assert got.shape == (15, 17, 3) and got.dtype == np.float32
    assert 0.0 < got.mean() < 1.0
    differ = (got != want).any(axis=-1).mean()
    assert differ <= 0.02, differ
    if mode == 2:
        assert (got[..., 1] == 0).all()
    else:
        red = (got == [1.0, 0.0, 0.0]).all(axis=-1)
        assert red.any()  # the cap is passed somewhere


def test_static_scan_unported_values_raise(room):
    """The wavefront's binning switches do not apply to the static scan,
    which renders them as its default; the bump-map switch renders too
    (the room has no bump map: the same image); an unknown estimator
    raises."""
    _, tsc = room
    cfg = trt.RenderConfig(width=4, height=4, path_regen=False,
                           bin_rays=False)
    img = trt.render(tsc, cfg)
    assert img.shape == (4, 4, 3)
    assert torch.equal(trt.render(tsc, cfg.replace(bin_rays=None)), img)
    assert torch.equal(
        trt.render(tsc, cfg.replace(enable_normal_maps=True)), img)
    with pytest.raises(ValueError, match="estimator"):
        trt.render(tsc, cfg.replace(estimator="bogus"))
