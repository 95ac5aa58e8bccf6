"""Parity of paths the port has beside its main frame: textures, the
albedo, metalness and alpha maps, ``tint_spec_diel``, ``aa_jitter``,
``lane_pool`` and ``drain_div``, each against the JAX package on CPU.

The scenes are built in a temporary directory (``torch_parity.maps_scene``:
quads with full uv coverage, PNG maps written by the port's own encoder),
as ``tests/test_material_maps.py`` builds its own.  Images agree at
``atol=2e-3`` up to the rare pixels whose path XLA's contracted
arithmetic sends the other way (``torch_parity.assert_images_match``);
each case also checks that its option changes the image, so that the
comparison is not of two images that ignore it.
"""

import os

import jax
import numpy as np
import pytest

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.scene import presets as j_presets
from ray_tracer_tpu_torch.scene import presets as t_presets

from torch_parity import assert_images_match, maps_scene


# odd sizes: no camera ray has an exactly zero x or y direction, on which
# the JAX gather walk jitted and run op by op part ways
KW = dict(width=33, height=25, samples_per_pixel=2, bounce_limit=3)


def _pair(tmp, maps):
    return (maps_scene(jrt, tmp, maps).compile().device_put(),
            maps_scene(trt, tmp, maps).compile(device="cpu"))


def _render_both(jsc, tsc, **kw):
    want = jrt.render(jsc, jrt.RenderConfig(routing=JRouting(packet="off"),
                                            **{**KW, **kw}))
    got = trt.render(tsc, trt.RenderConfig(**{**KW, **kw}))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("maps", [("albedo",), ("albedo", "metal"),
                                  ("albedo", "alpha"), ("metal", "alpha")])
def test_material_maps_match_jax(tmp_path, maps):
    """``_sample_texture`` (bilinear and nearest) and
    ``_apply_material_maps``: the albedo map multiplies the albedo, the
    metalness map's red channel replaces the reflectance, the alpha map's
    red channel below 0.5 cuts the surface out."""
    jsc, tsc = _pair(str(tmp_path), maps)
    assert tsc.meta["n_textures"] == 3
    got, want = _render_both(jsc, tsc)
    assert_images_match(got, want)
    plain, _ = _render_both(jsc, tsc, enable_textures=False)
    assert np.abs(got - plain).max() > 0.05  # the maps change the image


def test_textured_scene_through_schema(tmp_path):
    """A textured scene saved by the JAX package and loaded by the port
    renders as the JAX scene does."""
    from ray_tracer_tpu.scene import schema as j_schema
    from ray_tracer_tpu_torch.scene import schema as t_schema

    tmp = str(tmp_path)
    jb = maps_scene(jrt, tmp, ("albedo", "metal", "alpha"))
    path = os.path.join(tmp, "maps.json")
    j_schema.save_scene(jb, path)
    tsc = t_schema.load_scene(path).compile(device="cpu")
    got, want = _render_both(jb.compile().device_put(), tsc)
    assert_images_match(got, want)


def test_tint_spec_diel_matches_jax():
    """The gold mirror of ``sphere_reflectance`` carries its albedo into
    the reflection under ``tint_spec_diel``.  Against the JAX package run
    op by op: jitted, XLA's contracted arithmetic on the radius-100 planet
    moves 56 of the 825 pixels of its own op-by-op image; op by op, every
    pixel agrees."""
    jsc = j_presets.sphere_reflectance().compile().device_put()
    tsc = t_presets.sphere_reflectance().compile(device="cpu")
    got = trt.render(tsc, trt.RenderConfig(tint_spec_diel=True, **KW))
    with jax.disable_jit():
        want = jrt.render(jsc, jrt.RenderConfig(tint_spec_diel=True, **KW))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    untinted = trt.render(tsc, trt.RenderConfig(**KW))
    assert float((got - untinted).abs().max()) > 0.05


def test_aa_jitter_matches_jax(tmp_path):
    jsc, tsc = _pair(str(tmp_path), ("albedo",))
    got, want = _render_both(jsc, tsc, aa_jitter=True)
    assert_images_match(got, want)
    corner, _ = _render_both(jsc, tsc)
    assert np.abs(got - corner).max() > 0.05


@pytest.mark.parametrize("change", [
    {"lane_pool": 1},  # one lane per pixel
    {"lane_pool": 8192},  # two lanes per pixel, four samples each
    {"drain_div": 2},  # drain widths 32768, 16384, 8192
    {"drain_div": 8},  # no drain: 32768 / 8 is below 8192
])
def test_lane_pool_and_drain_div_match_jax(change):
    """``sphere_diffuse`` at 64x64, spp 8 (32768 lanes at the default
    pool): the lane split and the drain widths change the schedule, not
    the image, in both packages."""
    kw = dict(width=64, height=64, samples_per_pixel=8, bounce_limit=2)
    jsc = j_presets.sphere_diffuse().compile().device_put()
    tsc = t_presets.sphere_diffuse().compile(device="cpu")
    want = jrt.render(jsc, jrt.RenderConfig(**kw, **change))
    got = trt.render(tsc, trt.RenderConfig(**kw, **change))
    assert_images_match(got.numpy(), np.asarray(want))
    default = trt.render(tsc, trt.RenderConfig(**kw))
    np.testing.assert_allclose(got.numpy(), default.numpy(), atol=1e-6)
