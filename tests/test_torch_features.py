"""The wavefront's configuration values, the bump maps and the static
scan's occupancy profile, against the JAX package on CPU.

* ``Routing.bin_mode`` ``"leaf"`` and ``"hier"``, ``Routing.nee_prebin``
  ``"sort"`` and ``"nosort"``, and ``bin_rays=False`` only re-order the
  lanes or move the shadow query before the permute: the port's image is
  ``torch.equal`` to its default image, and within the image tolerance
  (``torch_parity.assert_images_match``, atol 2e-3) of the JAX package's
  render with the same value.
* ``nee_anyhit=False`` on the path-regeneration wavefront: the
  closest-hit NEE resolve, against JAX ``trace_wave`` and the static scan.
* ``enable_normal_maps``: the height-map bump branch of the shade fetch,
  on a scene built here (``tests/test_normal_maps.py``'s quad, wall and
  light, its height map a generated PNG), against both JAX integrators.
* ``trace(with_profile=True)``: the per-bounce ``(alive, nee_active)``
  counts equal the JAX package's exactly.
"""

import io

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.api import _camera_arrays as j_camera_arrays
from ray_tracer_tpu.integrator import wavefront as j_wavefront
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch.api import _camera_arrays as t_camera_arrays
from ray_tracer_tpu_torch.integrator import wavefront as t_wavefront
from ray_tracer_tpu_torch.scene.textures import decode_png

from torch_parity import (
    assert_images_match,
    bump_scene,
    downhill,
    level,
    room_scene,
    sponza_builders,
    uphill,
)

FRAME = dict(width=23, height=19, samples_per_pixel=2, bounce_limit=4)
VALUES = {  # the port's change, the JAX package's (its binned gather walk)
    "bin_leaf": (dict(routing=trt.Routing(bin_mode="leaf")),
                 dict(routing=JRouting(packet="off", bin_mode="leaf"))),
    "bin_hier": (dict(routing=trt.Routing(bin_mode="hier")),
                 dict(routing=JRouting(packet="off", bin_mode="hier"))),
    "prebin_sort": (dict(routing=trt.Routing(nee_prebin="sort")),
                    dict(routing=JRouting(packet="off", nee_prebin="sort"))),
    "prebin_nosort": (dict(routing=trt.Routing(nee_prebin="nosort")),
                      dict(routing=JRouting(packet="off",
                                            nee_prebin="nosort"))),
    "hier_prebin_sort": (
        dict(routing=trt.Routing(bin_mode="hier", nee_prebin="sort")),
        dict(routing=JRouting(packet="off", bin_mode="hier",
                              nee_prebin="sort"))),
    "unbinned": (dict(bin_rays=False),
                 dict(routing=JRouting(packet="off"), bin_rays=False)),
    "unbinned_prebin": (
        dict(bin_rays=False, routing=trt.Routing(nee_prebin="sort")),
        dict(routing=JRouting(packet="off", nee_prebin="sort"),
             bin_rays=False)),
}


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """The room scene in both packages and the port's default image."""
    tmp = str(tmp_path_factory.mktemp("room"))
    jsc = room_scene(jrt, tmp).compile().device_put()
    tsc = room_scene(trt, tmp).compile(device="cpu")
    return jsc, tsc, trt.render(tsc, trt.RenderConfig(**FRAME))


@pytest.mark.parametrize("value", list(VALUES))
def test_config_value_bit_identical_and_matches_jax(room, value):
    jsc, tsc, default = room
    tkw, jkw = VALUES[value]
    got = trt.render(tsc, trt.RenderConfig(**FRAME, **tkw))
    assert torch.equal(got, default)
    want = np.asarray(jrt.render(jsc, jrt.RenderConfig(
        **FRAME, **{"bin_rays": True, **jkw})))
    assert_images_match(got.numpy(), want)


@pytest.mark.parametrize("routing", [
    dict(bin_mode="leaf"), dict(bin_mode="hier"),
    dict(nee_prebin="sort"), dict(bin_mode="leaf", nee_prebin="nosort"),
])
def test_config_value_drain_bit_identical(room, routing):
    """128x128 spp 2 = 32,768 lanes: the multi-phase drain slices the
    wavefront (32768 -> 8192), which needs every bin order to put the
    dead lanes last."""
    _, tsc, _ = room
    kw = dict(width=128, height=128, samples_per_pixel=2, bounce_limit=3)
    want = trt.render(tsc, trt.RenderConfig(**kw))
    got = trt.render(tsc, trt.RenderConfig(
        routing=trt.Routing(**routing), **kw))
    assert torch.equal(got, want)


def test_unbinned_keeps_one_host_read_per_round(room, monkeypatch):
    """``bin_rays=False`` still reads the device once a round (its live
    count) and traces as many rounds as the binned wavefront."""
    _, tsc, _ = room
    counts = {}

    def counted(cfg):
        n = 0
        real = t_wavefront.traverse.traverse

        def traverse(*a, **k):
            nonlocal n
            n += 1
            return real(*a, **k)

        monkeypatch.setattr(t_wavefront.traverse, "traverse", traverse)
        img = trt.render(tsc, cfg)
        monkeypatch.setattr(t_wavefront.traverse, "traverse", real)
        return img, n

    a, counts["binned"] = counted(trt.RenderConfig(**FRAME))
    b, counts["unbinned"] = counted(trt.RenderConfig(**FRAME,
                                                     bin_rays=False))
    assert torch.equal(a, b)
    assert counts["binned"] == counts["unbinned"] > 3


def _wave(pkg, wf, camera_arrays, sc, cfg, n_spp):
    """``trace_wave`` of every pixel with its ray counts."""
    cam = pkg.scene_camera(sc)
    if pkg is trt:
        rot, pos, fov, aspect, near = camera_arrays(cam, cfg, sc.device)
        ids = torch.arange(cfg.n_pixels, dtype=torch.int32)
    else:
        import jax.numpy as jnp

        rot, pos, fov, aspect, near = camera_arrays(cam, cfg)
        ids = jnp.arange(cfg.n_pixels, dtype=jnp.int32)
    acc, n_rays = wf.trace_wave(sc, rot, pos, fov, aspect, near, ids, 0, 0,
                                n_spp, cfg, with_stats=True)
    return np.asarray(acc) / n_spp, np.asarray(n_rays)


@pytest.mark.parametrize("scene", ["room", "sphere_diffuse"])
def test_closest_hit_nee_wavefront_matches_jax(room, scene):
    """``nee_anyhit=False`` on the path-regeneration wavefront: the image
    and the (semantic, traced) ray counts against JAX ``trace_wave`` (on
    ``sphere_diffuse``, a scene without rect lights, every shadow ray is
    still traced and counted), and the image against the port's own
    static scan and occlusion-NEE image."""
    if scene == "room":
        jsc, tsc, default = room
    else:
        from ray_tracer_tpu.scene import presets as j_presets
        from ray_tracer_tpu_torch.scene import presets as t_presets

        jsc = j_presets.sphere_diffuse().compile().device_put()
        tsc = t_presets.sphere_diffuse().compile(device="cpu")
        default = trt.render(tsc, trt.RenderConfig(**FRAME))
    tcfg = trt.RenderConfig(**FRAME, nee_anyhit=False)
    jcfg = jrt.RenderConfig(**FRAME, nee_anyhit=False, bin_rays=True,
                            routing=JRouting(packet="off"))
    got, t_rays = _wave(trt, t_wavefront, t_camera_arrays, tsc, tcfg, 2)
    want, j_rays = _wave(jrt, j_wavefront, j_camera_arrays, jsc, jcfg, 2)
    got, want = got.reshape(19, 23, 3), want.reshape(19, 23, 3)
    assert_images_match(got, want)
    # a path that diverges at an exact-t tie (the room's boxes stand on
    # its floor) moves its few rays
    np.testing.assert_allclose(t_rays, j_rays, rtol=1e-3)
    static = trt.render(tsc, tcfg.replace(path_regen=False)).numpy()
    np.testing.assert_allclose(got, static, atol=1e-5)
    # only the shadow rays' resolve differs; no emitter lies between a
    # surface and the light, so the image is the occlusion image
    assert_images_match(got, default.numpy())


BUMP = dict(width=25, height=23, samples_per_pixel=4, bounce_limit=2)


@pytest.mark.parametrize("ramp", [uphill, downhill, level])
@pytest.mark.parametrize("path_regen", [True, False])
def test_bump_maps_match_jax(tmp_path, ramp, path_regen):
    """The bump branch against the JAX package's, on the wavefront and on
    the static scan."""
    tmp = str(tmp_path)
    jsc = bump_scene(jrt, tmp, ramp).compile().device_put()
    tsc = bump_scene(trt, tmp, ramp).compile(device="cpu")
    assert tsc.tex_size.tolist() == [[16, 16]]
    kw = dict(BUMP, enable_normal_maps=True, bump_scale=4.0,
              path_regen=path_regen)
    want = np.asarray(jrt.render(jsc, jrt.RenderConfig(
        routing=JRouting(packet="off"), **kw)))
    got = trt.render(tsc, trt.RenderConfig(**kw)).numpy()
    assert_images_match(got, want)
    off = trt.render(tsc, trt.RenderConfig(**{**kw, "enable_normal_maps":
                                              False})).numpy()
    if ramp is level:  # no gradient: the normals do not move
        np.testing.assert_allclose(got, off, atol=1e-6)
    else:
        assert np.abs(got - off).max() > 1e-2


def test_bump_tilts_away_from_uphill(tmp_path):
    """A u-ramp rising toward +x tilts the normals toward -x and darkens
    the quad under the +x light; the falling ramp brightens it; off is
    the default and leaves the image bit for bit."""
    tmp = str(tmp_path)
    on = trt.RenderConfig(**BUMP, enable_normal_maps=True, bump_scale=4.0)
    quad = {}
    for ramp in (uphill, level, downhill):
        sc = bump_scene(trt, tmp, ramp).compile(device="cpu")
        quad[ramp.__name__] = float(trt.render(sc, on)[8:16, 6:18].mean())
    assert quad["uphill"] < quad["level"] < quad["downhill"]
    assert quad["downhill"] > 1.05 * quad["uphill"]
    sc = bump_scene(trt, tmp, uphill).compile(device="cpu")
    assert torch.equal(trt.render(sc, trt.RenderConfig(**BUMP)),
                       trt.render(sc, on.replace(enable_normal_maps=False)))


def test_bump_maps_ignored_on_forest_scenes(tmp_path):
    """Forest scenes ignore the flag, as in the JAX package."""
    sc = bump_scene(trt, str(tmp_path), uphill).compile(
        flatten_instances=False, device="cpu")
    cfg = trt.RenderConfig(**BUMP)
    assert torch.equal(trt.render(sc, cfg),
                       trt.render(sc, cfg.replace(enable_normal_maps=True)))


@pytest.mark.parametrize("change", [{}, {"nee_anyhit": False},
                                    {"estimator": "cosine"}])
def test_static_scan_profile_matches_jax(tmp_path, monkeypatch, change):
    """``trace(..., with_profile=True)`` on ``sponza_proxy`` cut to 8k
    triangles, one sample of 48x27 pixels, bounce 8: the color and ray
    counts as ``with_stats`` gives them, and the per-bounce ``(alive,
    nee_active)`` counts equal to the JAX package's."""
    import jax.numpy as jnp

    jb, tb = sponza_builders(str(tmp_path), monkeypatch, 8000)
    kw = dict(width=48, height=27, samples_per_pixel=1, bounce_limit=8,
              path_regen=False, **change)
    jsc, tsc = jb.compile().device_put(), tb.compile(device="cpu")
    jcfg = jrt.RenderConfig(routing=JRouting(packet="off"), **kw)
    tcfg = trt.RenderConfig(**kw)
    rot, pos, fov, aspect, near = j_camera_arrays(jrt.scene_camera(jsc),
                                                  jcfg)
    ids = jnp.arange(jcfg.n_pixels, dtype=jnp.int32)
    rays = j_wavefront.raygen(rot, pos, fov, aspect, near, ids, 48, 27)
    _, j_rays, (j_alive, j_nee) = j_wavefront.trace(
        jsc, rays, ids, jnp.int32(0), jnp.int32(0), jcfg, with_profile=True)
    rot, pos, fov, aspect, near = t_camera_arrays(trt.scene_camera(tsc),
                                                  tcfg, "cpu")
    tids = torch.arange(tcfg.n_pixels, dtype=torch.int32)
    trays = t_wavefront.raygen(rot, pos, fov, aspect, near, tids, 48, 27)
    color, n_rays, (alive, nee) = t_wavefront.trace(
        tsc, trays, tids, 0, 0, tcfg, with_profile=True)
    assert alive.shape == nee.shape == (9,)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(j_alive))
    np.testing.assert_array_equal(nee.numpy(), np.asarray(j_nee))
    np.testing.assert_array_equal(n_rays.numpy(), np.asarray(j_rays))
    stats = t_wavefront.trace(tsc, trays, tids, 0, 0, tcfg, with_stats=True)
    assert torch.equal(stats[0], color) and torch.equal(stats[1], n_rays)
    assert float(alive[0]) > 0 and float(alive[-1]) == 0.0
    if change.get("estimator") == "cosine":
        assert float(nee.sum()) == 0.0


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_png_decoder_matches_pillow(mode):
    """The texture loader's own PNG decoder (for machines without Pillow)
    against Pillow on every row filter Pillow writes."""
    from PIL import Image

    rand = np.random.default_rng(len(mode))
    shape = {"RGB": (7, 9, 3), "RGBA": (5, 6, 4), "L": (4, 3),
             "LA": (3, 5, 2)}[mode]
    img = rand.integers(0, 256, shape, np.uint8)
    img[0] = 7  # flat rows and smooth ramps choose other filters
    img[-1] = np.arange(shape[1]).reshape(shape[1], *([1] * (len(shape)
                                                            - 2))) * 9
    for opt in ({}, {"optimize": True}):
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, "PNG", **opt)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue()))
                          .convert("RGB"))
        np.testing.assert_array_equal(decode_png(buf.getvalue()), want)
