"""The port's presets against the JAX package's: the same builder
compiles to the same tables, NaN-equal (``torch_parity.assert_tables_match``).

The asset-free presets compile as they are.  The others read OBJ, MTL and
PNG files from their ``assets`` directory, which is not in the
repository: both packages are handed the same stand-ins, written to a
temporary directory (``torch_parity.stand_in_assets``).  Comparing their
renders with the committed goldens waits for the real files.
"""

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.scene import presets as j_presets
from ray_tracer_tpu_torch.scene import presets as t_presets

from torch_parity import assert_images_match, assert_tables_match, \
    stand_in_assets

ASSET_FREE = ["spheres_demo", "unlit_sphere", "sphere_reflectance",
              "triangle_reflectance"]

# preset -> (positional arguments, keyword arguments) besides ``assets``
WITH_ASSETS = {
    "default_scene": ((), {}),
    "cornell_spheres": ((), {}),
    "cornell_rainbow": ((), {}),
    "monkey_demo": ((), {}),
    "dread_demo": ((), {}),
    "dread_demo-white": ((), {"kind": "white"}),
    "dread_demo-metallic": ((), {"kind": "metallic"}),
    "dread_demo-texture_metallic": ((), {"kind": "texture_metallic"}),
    "mtlmap_demo-rb": (("rb",), {}),
    "mtlmap_demo-slosher": (("slosher",), {"metalness": False}),
    "mtlmap_demo-solid": (("squeezer",), {"solid": "gold"}),
    "mesh_scene": (("bunny.obj",), {}),
    "dielectrics": ((), {}),
    "obj_normals_demo": ((), {}),
    "obj_reflectance_demo": ((), {}),
    "rb_metallic_demo": ((), {}),
    "bobadog_demo": ((), {}),
}


def _build(pkg_presets, pkg, name, assets):
    args, kw = WITH_ASSETS[name]
    if kw.get("solid") == "gold":
        kw = {**kw, "solid": pkg.Material(albedo=(1.0, 0.8, 0.3),
                                          reflectance=1.0, name="gold")}
    fn = getattr(pkg_presets, name.split("-")[0])
    return fn(*args, assets=assets, **kw)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return stand_in_assets(str(tmp_path_factory.mktemp("assets")))


@pytest.mark.parametrize("name", ASSET_FREE)
def test_asset_free_presets_match_jax(name):
    jb = getattr(j_presets, name)()
    tb = getattr(t_presets, name)()
    assert_tables_match(jb.compile(), tb.compile(device="cpu",
                                                 rope_streams=True))


@pytest.mark.parametrize("name", sorted(WITH_ASSETS))
def test_presets_with_assets_match_jax(name, assets):
    jb = _build(j_presets, jrt, name, assets)
    tb = _build(t_presets, trt, name, assets)
    tsc = tb.compile(device="cpu", rope_streams=True)
    assert tsc.meta["n_tris"] > 0
    assert_tables_match(jb.compile(), tsc)
    assert [i.name for _, i in tb.instances] == \
        [i.name for _, i in jb.instances]


def test_bobadog_reads_its_mtl(assets):
    """The automatic OBJ -> MTL -> texture route: each ``usemtl`` group
    gets its MTL material, ``map_Ka`` its texture, and the render agrees
    with the JAX package's."""
    tb = t_presets.bobadog_demo(assets=assets)
    names = [trt_mat.name for trt_mat in tb.materials]
    assert "body" in names and "eyes" in names
    tsc = tb.compile(device="cpu")
    assert tsc.meta["n_textures"] == 1
    kw = dict(width=19, height=15, samples_per_pixel=2, bounce_limit=3)
    jsc = j_presets.bobadog_demo(assets=assets).compile().device_put()
    want = jrt.render(jsc, jrt.RenderConfig(routing=JRouting(packet="off"),
                                            **kw))
    got = trt.render(tsc, trt.RenderConfig(**kw))
    assert float(got.mean()) > 0.01
    assert_images_match(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bump", [False, True])
def test_obj_normals_demo_renders_with_normal_maps(assets, bump):
    """``obj_normals_demo`` under ``enable_normal_maps`` against the JAX
    package at 19x15, spp 2, bounce 1 (the preset's bounce limit).  The
    preset itself carries no bump map, so the flag leaves its image bit
    for bit; with ``bump`` its weapon's albedo texture doubles as the
    height map in both packages, and the map moves the image."""
    builders = [p.obj_normals_demo(assets=assets)
                for p in (j_presets, t_presets)]
    if bump:
        for b in builders:
            (rb,) = [m for m in b.materials if m.name == "rb"]
            rb.bump_tex = rb.albedo_tex
    jsc = builders[0].compile().device_put()
    sc = builders[1].compile(device="cpu")
    assert sc.meta["n_bump_maps"] == int(bump)
    kw = dict(width=19, height=15, samples_per_pixel=2, bounce_limit=1,
              enable_normal_maps=True, bump_scale=4.0)
    want = jrt.render(jsc, jrt.RenderConfig(routing=JRouting(packet="off"),
                                            **kw))
    got = trt.render(sc, trt.RenderConfig(**kw))
    assert_images_match(got.numpy(), np.asarray(want))
    off = trt.render(sc, trt.RenderConfig(**{**kw, "enable_normal_maps":
                                              False}))
    if bump:
        assert float((got - off).abs().max()) > 1e-3
    else:
        assert torch.equal(got, off)


def test_default_assets_from_the_environment(monkeypatch, tmp_path):
    """``RT_ASSETS`` names the assets directory, as in the JAX package;
    without it the port looks in ``assets/`` at the repository's root."""
    import importlib
    import os

    monkeypatch.setenv("RT_ASSETS", str(tmp_path))
    try:
        assert importlib.reload(t_presets).DEFAULT_ASSETS == str(tmp_path)
        monkeypatch.delenv("RT_ASSETS")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert importlib.reload(t_presets).DEFAULT_ASSETS == \
            os.path.join(root, "assets")
    finally:
        importlib.reload(t_presets)


def test_single_triangle_obj():
    path = t_presets._single_tri_obj((0, 0, 0), (1, 0, 0), (0, 1, 0))
    try:
        b = trt.SceneBuilder()
        b.add_material(trt.Material())
        b.add_obj(path)
        assert b.compile(device="cpu").meta["n_tris"] == 1
    finally:
        import os

        os.remove(path)
