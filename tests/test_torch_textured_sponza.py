"""The textured Sponza (the benchmark's ``sponza_textured`` configuration)
at its small size on the CPU: its geometry is the flat cell's, its files
load through the port into the intended materials and maps, the port's
progressive render equals the configuration's plain reference within the
cell's limit with foliage cutouts and bump maps in the frame, the scene
read without its bump maps, its alpha maps or its bilinear sampler does
not, and the round counts its cutout lanes.

Imports no JAX: the ``gpu`` test here runs on the card with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_textured_sponza.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import ray_tracer_tpu_torch as trt  # noqa: E402
from ray_tracer_tpu_torch.integrator import shading, wavefront  # noqa: E402
from ray_tracer_tpu_torch.kernels import shade  # noqa: E402
from rt_bench import handoff_textured, harness, traffic  # noqa: E402
from rt_bench.reference import compare  # noqa: E402
from rt_bench.reference import scene as plain_scene  # noqa: E402
from rt_bench.reference_textured import integrator as ref_integrator  # noqa: E402
from rt_bench.reference_textured import scene as ref_scene  # noqa: E402
from rt_bench.scenes import sponza_proxy, sponza_textured  # noqa: E402

from torch_parity import first_wave  # noqa: E402

CELL = "sponza_textured.progressive1080"
CONFIG = harness.load_json(ROOT, "rt_bench", "configs", "sponza_textured.json")
ARGS = dict(CONFIG["generator_args"], **CONFIG["small_args"])
LIMIT = compare.limits(ROOT, CELL)["rel_l1"]
FRAME = dict(width=24, height=16)
SEEDS = (5, 2**31 + 12345, 4_000_000_017)


@pytest.fixture(scope="module")
def spec():
    return sponza_textured.generate(**ARGS)


def compiled(spec, tmp, **files):
    """The port's scene of ``spec`` from its files (``handoff_textured``),
    on the CPU, and the builder."""
    os.makedirs(tmp, exist_ok=True)
    b = handoff_textured.build(spec, tmp, **files)
    return b.compile(device="cpu", **CONFIG["compile"]), b


@pytest.fixture(scope="module")
def built(spec, tmp_path_factory):
    return compiled(spec, str(tmp_path_factory.mktemp("sponza")))


@pytest.fixture(scope="module")
def reference(spec):
    return ref_scene.build(spec, torch.device("cpu"))


def config(seed, frame=FRAME, **render):
    mix = traffic.load(ROOT, "progressive1080")
    return trt.RenderConfig(width=frame["width"], height=frame["height"],
                            samples_per_pixel=mix["spp"],
                            bounce_limit=mix["bounce_limit"], seed=seed,
                            **dict(CONFIG["render"], **render))


def rel_l1(scene, reference, spec, seed, steps=2, **render):
    """The port's image after ``steps`` steps against the reference's, at
    every pixel."""
    cfg = config(seed, **render)
    r = trt.ProgressiveRenderer(scene, cfg)
    for _ in range(steps):
        r.step()
    ref_cfg = dict(width=cfg.width, height=cfg.height,
                   spp=cfg.samples_per_pixel, bounce_limit=cfg.bounce_limit,
                   seed=seed, **CONFIG["render"])
    pix = torch.arange(cfg.width * cfg.height)
    want = ref_integrator.render_pixels(reference, ref_cfg, spec.camera, pix,
                                        steps)
    return compare.numbers(r.accum.reshape(-1, 3), want)["rel_l1"]


def test_geometry_is_the_flat_cells(spec):
    flat = sponza_proxy.generate(
        **{k: ARGS[k] for k in ("n_tris_target", "seed", "objects")})
    got = plain_scene.world_triangles(spec.base)
    want = plain_scene.world_triangles(flat)
    assert np.array_equal(got[0], want[0])  # corners, triangle for triangle
    assert np.array_equal(got[3], want[3])  # front-only faces
    assert [i.group for i in spec.base.instances] == [
        i.group for i in flat.instances]
    assert len(spec.maps) <= 64
    assert {m.shape for m in spec.maps} == {(ARGS["map_size"],) * 2 + (3,)}


def test_files_load_into_the_intended_materials_and_maps(spec, built):
    sc, b = built
    names = [os.path.basename(p)[:-4] for p in b._texture_paths]
    assert sorted(names) == sorted(spec.map_names)
    stems = {i.group: i for i in spec.base.instances}
    seen = []
    for gid, inst in b.instances:
        g = b._groups[gid]
        group = next(k for k, i in stems.items() if np.array_equal(
            spec.base.meshes[i.mesh].positions(), g.positions))
        seen.append(group)
        assert np.array_equal(g.uvs, spec.uvs[group])
        mat = b.materials[inst.material]
        if group not in spec.slots:  # the skylight: the light's material
            assert mat.emission_strength > 0 and mat.albedo_tex < 0
            continue
        assert inst.sampler == 1 and mat.name == group
        assert tuple(mat.albedo) == (1.0, 1.0, 1.0)
        slot = spec.slots[group]
        for attr, which in (("albedo_tex", "albedo"), ("bump_tex", "bump"),
                            ("alpha_tex", "alpha")):
            k = getattr(mat, attr)
            assert (k >= 0) == (slot[which] >= 0), (group, which)
            if k >= 0:
                assert names[k] == spec.map_names[slot[which]]
                assert np.array_equal(sc.tex_data[k].numpy(),
                                      spec.maps[slot[which]])
    assert seen == [i.group for i in spec.base.instances]
    assert sc.meta["n_textures"] == len(spec.maps)
    assert sc.meta["n_alpha_maps"] == 1
    assert sc.meta["n_bump_maps"] == len(spec.slots) - 1


@pytest.mark.parametrize("seed", SEEDS)
def test_render_matches_the_reference(spec, built, reference, seed):
    assert rel_l1(built[0], reference, spec, seed) <= LIMIT


@pytest.mark.parametrize("fault", ["bump_off", "alpha_dropped", "nearest"])
def test_a_scene_read_otherwise_is_over_the_limit(spec, built, reference,
                                                  tmp_path, fault):
    sc, render = built[0], {}
    if fault == "bump_off":
        render = dict(enable_normal_maps=False)
    elif fault == "alpha_dropped":
        sc, _ = compiled(spec, str(tmp_path), maps=("map_Kd", "map_bump"))
        assert sc.meta["n_alpha_maps"] == 0
    else:
        sc, _ = compiled(spec, str(tmp_path), sampler=0)
    assert rel_l1(sc, reference, spec, SEEDS[0], **render) > LIMIT


def cutouts_of(c, w):
    """Shaded lanes of the wave ``w`` whose sampled alpha is below 0.5,
    and those that hit a bump-mapped triangle."""
    scene = c.scene
    fetched = shading.shade_fetch(
        scene, shading.CameraRays(w.origin, w.direction), w.hit, c.space,
        c.cfg)
    uv, sampler, alpha_tex = fetched[2], fetched[8], fetched[10]
    alpha = shading.sample_texture(scene, alpha_tex, uv, sampler)[:, 0]
    shaded = w.alive & w.hit.did_hit & ~w.bad
    tri = torch.where(w.hit.kind == 2, w.hit.prim, 0).long()
    table = scene.shade_tri if c.space == "tri" else scene.shade_slot
    bumped = shaded & (table[tri, 31] >= 0)
    return int((shaded & (alpha_tex >= 0) & (alpha < 0.5)).sum()), int(
        bumped.sum())


def test_the_round_counts_its_cutouts(built):
    sc = built[0]
    cfg = config(SEEDS[1])
    c, round_, w = first_wave(sc, cfg, frame=0, n_spp=2)
    assert round_ is wavefront._fused_round
    cut = bump = 0
    for _ in range(4):
        want, bumped = cutouts_of(c, w)
        _, _, tally = shade.shade_round_reference(c, w)
        nxt = wavefront._torch_round(c, w)
        assert tally.shape == (5,) and nxt.tally.shape == (5,)
        assert int(tally[4]) == int(nxt.tally[4]) == want
        cut, bump = cut + want, bump + bumped
        w = round_(c, w)
        assert torch.equal(w.tally[:3], nxt.tally[:3])
    assert cut > 0 and bump > 0


def test_untextured_rounds_keep_four_words(built):
    cfg = config(SEEDS[0], enable_textures=False)
    c, round_, w = first_wave(built[0], cfg, frame=0, n_spp=2)
    assert round_(c, w).tally.shape == (4,)
    assert wavefront._torch_round(c, w).tally.shape == (4,)


@pytest.mark.gpu
def test_the_maps_instance_counts_as_its_plain_version(spec,
                                                       tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tmp = str(tmp_path_factory.mktemp("sponza_gpu"))
    sc = handoff_textured.build(spec, tmp).compile(**CONFIG["compile"])
    cfg = config(SEEDS[2], dict(width=320, height=180))
    c, round_, w = first_wave(sc, cfg, frame=0, n_spp=2)
    total = 0
    for _ in range(6):
        shade.reset_launches()
        packed, key, tally = shade.shade_round(c, w)
        assert shade.launches["shade_round_maps"] == 1
        want = shade.shade_round_reference(c, w)
        torch.cuda.synchronize()
        assert torch.equal(tally, want[2])
        assert torch.equal(packed.view(torch.int32),
                           want[0].view(torch.int32))
        total += int(tally[4])
        w = round_(c, w)
    assert total > 0
