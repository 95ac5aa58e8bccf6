"""The wavefront round's kernels (``kernels/shade.py``) on the CPU.

On CPU tensors the wrappers run their plain versions, so here the fused
round (``integrator/wavefront.py::_fused_round``: shade, argsort, permute,
traversal, NEE resolve) runs on the CPU and is held against the torch
round bit for bit, round after round, on reduced scenes, textured ones
(albedo, metalness, alpha and bump maps, both samplers) and forests
among them; the route predicate picks it for the main configuration,
textures and normal maps, forest scenes, and for no excluded value; a
forest frame through it equals the torch round's; the maps instance's
sRGB table equals the texture fetch's decode;
a main-path frame goes through the three wrappers once a round; the plain
versions' pieces equal the JAX package's; and one frame of the new path
agrees with the JAX package's render of its group-kernel route.  The
kernels themselves are held against these plain versions on the card in
``tests/test_torch_gpu.py`` and by ``chip_smoke.py``.
"""

import ctypes
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.integrator import wavefront as j_wavefront
from ray_tracer_tpu_torch.integrator import shading, wavefront
from ray_tracer_tpu_torch.kernels import shade
from ray_tracer_tpu_torch.scene import presets

from torch_parity import (
    assert_images_match,
    bump_scene,
    first_wave,
    maps_scene,
    room_scene,
    same_bits,
    sphere_maps_scene,
    uphill,
    with_lights,
)

SIZE = dict(width=13, height=9, samples_per_pixel=2, bounce_limit=5)
SPACE = {"slot": trt.Routing(), "tri": trt.Routing(wide=False)}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("shade"))
    return {
        "sponza": presets.sponza_proxy(n_tris_target=8000).compile(
            device="cpu"),
        "spheres": presets.sphere_diffuse().compile(device="cpu"),
        "room": room_scene(trt, tmp).compile(device="cpu"),
        "maps": maps_scene(trt, tmp, ("albedo", "metal", "alpha")).compile(
            device="cpu"),
        "bump": bump_scene(trt, tmp, uphill).compile(device="cpu"),
        "bump_bilinear": bump_scene(trt, tmp, uphill, sampler=1).compile(
            device="cpu"),
        "sphere_maps": sphere_maps_scene(trt, tmp).compile(device="cpu"),
        # forests: one tree per instance, the walk's u, v, front and obj
        "room_forest": room_scene(trt, tmp).compile(flatten_instances=False,
                                                    device="cpu"),
        "maps_forest": maps_scene(trt, tmp, ("albedo", "metal", "alpha"))
        .compile(flatten_instances=False, device="cpu"),
        "sponza_forest": presets.sponza_proxy(n_tris_target=8000).compile(
            flatten_instances=False, device="cpu"),
    }


# the configuration values each scene is rendered with
SCENE_CFG = {name: dict(enable_normal_maps=True, bump_scale=4.0)
             for name in ("bump", "bump_bilinear")}


def assert_waves_equal(got, want):
    for name, a, b in zip(wavefront.Wave._fields, got, want):
        pairs = zip(a, b) if name == "hit" else [(a, b)]
        for x, y in pairs:
            assert same_bits(x, y), name


# each scene with 0, 1 and 2 lights in both triangle id spaces; jitter and
# the tint of the delta lobes each on in half of the cases.  The textured
# scenes: two quads with albedo, metalness and alpha maps, one bilinear and
# one nearest ("maps"), a bump-mapped quad, nearest and bilinear, under
# enable_normal_maps, and spheres with maps (no meshes).  The forests: the
# room and the maps scene compiled with flatten_instances=False (triangle
# hits in the "tri" space on every route)
TEXTURED = ("maps", "bump", "bump_bilinear", "sphere_maps", "maps_forest")
CASES = [
    pytest.param(name, space, n_lights, space == "tri", n_lights != 1,
                 id=f"{name}-{space}-{n_lights}")
    for name, space, n_lights in itertools.product(
        ("sponza", "spheres", "room") + TEXTURED[:-1], ("slot", "tri"),
        (0, 1, 2))
] + [
    pytest.param(name, space, n_lights, space == "tri", n_lights != 1,
                 id=f"{name}-{space}-{n_lights}")
    for name, space, n_lights in itertools.product(
        ("room_forest", "maps_forest"), ("slot", "tri"), (0, 1, 2))
]


@pytest.mark.parametrize("name,space,n_lights,jitter,tint", CASES)
def test_plain_versions_equal_the_torch_round(scenes, name, space, n_lights,
                                              jitter, tint):
    """The three plain versions chained (the fused round on the CPU)
    equal the torch round on every field of the next wave, bit for bit,
    in every round of a frame."""
    sc = with_lights(scenes[name], n_lights)
    cfg = trt.RenderConfig(**SIZE, routing=SPACE[space], aa_jitter=jitter,
                           tint_spec_diel=tint, **SCENE_CFG.get(name, {}))
    c, round_, w = first_wave(sc, cfg)
    assert round_ is wavefront._fused_round
    assert (c.srgb is not None) == (name in TEXTURED)
    assert c.space == (space if sc.meta["flattened"] else "tri")
    rounds = 0
    while int(w.n_alive) > 0:
        want = wavefront._torch_round(c, w)
        got = wavefront._fused_round(c, w)
        assert_waves_equal(got, want)
        w = got
        rounds += 1
    assert rounds >= 3
    assert w.n_rays[0] >= w.n_rays[1] >= cfg.n_pixels


def textured(sc):
    return dataclasses.replace(sc, meta={**sc.meta, "n_textures": 1})


EXCLUDED = {  # each value that keeps the torch round
    "bin_leaf": dict(routing=trt.Routing(bin_mode="leaf")),
    "bin_hier": dict(routing=trt.Routing(bin_mode="hier")),
    "prebin_sort": dict(routing=trt.Routing(nee_prebin="sort")),
    "prebin_nosort": dict(routing=trt.Routing(nee_prebin="nosort")),
    "closest_nee": dict(nee_anyhit=False),
    "unbinned": dict(bin_rays=False),
}


@pytest.mark.parametrize("value", sorted(EXCLUDED))
def test_fused_round_ok_excludes(scenes, value):
    cfg = trt.RenderConfig(**EXCLUDED[value])
    for name in ("sponza", "room_forest"):
        assert not wavefront._fused_round_ok(scenes[name], cfg,
                                             cfg.resolved_routing())


MAIN = {  # id -> (RenderConfig values, the scene, textured)
    "main": ({}, "sponza", False),
    "textures_off": (dict(enable_textures=False), "sponza", True),
    "narrow": (dict(routing=trt.Routing(wide=False)), "sponza", False),
    "dir_bits": (dict(routing=trt.Routing(bin_dir_bits=2)), "sponza", False),
    "jitter": (dict(aa_jitter=True), "sponza", False),
    "textures": ({}, "sponza", True),
    "normal_maps": (dict(enable_normal_maps=True), "sponza", True),
    "forest": ({}, "room_forest", False),
    "textured_forest": (dict(enable_normal_maps=True), "room_forest", True),
}


@pytest.mark.parametrize("value", list(MAIN))
def test_fused_round_ok_main(scenes, value):
    """The main configuration, and values the kernels take: a textured
    scene with textures on or off, normal maps, any route, direction
    bits, forest scenes, textured or not."""
    kw, name, with_textures = MAIN[value]
    sc = textured(scenes[name]) if with_textures else scenes[name]
    cfg = trt.RenderConfig(**kw)
    assert wavefront._fused_round_ok(sc, cfg, cfg.resolved_routing())
    assert wavefront._fused_round_ok(scenes["spheres"], cfg,
                                     cfg.resolved_routing())


@pytest.mark.parametrize("name", ["room_forest", "maps_forest"])
def test_forest_frame_runs_the_round_kernels(scenes, name, monkeypatch):
    """A forest frame (the room, and the textured quads) runs the round
    kernels' wrappers every round and equals the torch round's frame bit
    for bit."""
    calls = {"round": 0}
    fused = wavefront._fused_round

    def counting(*args, **kw):
        calls["round"] += 1
        return fused(*args, **kw)

    monkeypatch.setattr(wavefront, "_fused_round", counting)
    cfg = trt.RenderConfig(width=21, height=15, samples_per_pixel=2,
                           bounce_limit=6)
    img = trt.render(scenes[name], cfg)
    assert calls["round"] >= 6
    assert img.mean() > 0.02
    monkeypatch.setattr(wavefront, "_fused_round_ok", lambda *a: False)
    assert torch.equal(img, trt.render(scenes[name], cfg))


def test_main_path_runs_the_wrappers(scenes, monkeypatch):
    """A main-path frame calls each wrapper once a round (the CPU adds
    no launch), and its image equals the torch round's."""
    calls = {k: 0 for k in ("round", "shade_round", "permute_rows",
                            "nee_resolve")}

    def counting(module, name, key):
        fn = getattr(module, name)

        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, call)

    counting(wavefront, "_fused_round", "round")
    for name in ("shade_round", "permute_rows", "nee_resolve"):
        counting(shade, name, name)
    shade.reset_launches()
    cfg = trt.RenderConfig(width=24, height=14, samples_per_pixel=2,
                           bounce_limit=8)
    img = trt.render(scenes["sponza"], cfg)
    assert calls["round"] >= 9
    assert len(set(calls.values())) == 1, calls
    assert sum(shade.launches.values()) == 0
    monkeypatch.setattr(wavefront, "_fused_round_ok", lambda *a: False)
    assert torch.equal(img, trt.render(scenes["sponza"], cfg))
    assert calls["round"] == calls["shade_round"]


def test_srgb_table_equals_the_fetch_decode():
    """``shading.srgb_to_linear``, and so the maps instance's table, equals
    the texture fetch's decode as written before it was factored out, on
    every byte, bit for bit."""
    texels = torch.arange(256, dtype=torch.uint8)
    srgb = texels.to(torch.float32) / 255.0
    want = torch.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4)
    assert same_bits(shading.srgb_to_linear(texels), want)
    assert same_bits(shade.srgb_table("cpu"), want)
    grid = texels.view(4, 8, 8)  # any shape, value by value
    assert same_bits(shading.srgb_to_linear(grid), want.view(4, 8, 8))


def test_bin_key_matches_jax(scenes):
    """The shade kernel's key (its plain version, ``shading.bin_key``)
    against the JAX package's on seeded lanes, with direction bits."""
    sc = scenes["sponza"]
    rand = np.random.default_rng(3)
    box = sc.bvh_packed[0].numpy()
    o = rand.uniform(box[0:3] - 1.0, box[3:6] + 1.0, (4096, 3))
    d = rand.normal(size=(4096, 3))
    d[::7, 0] = 0.0
    o, d = o.astype(np.float32), d.astype(np.float32)
    alive = rand.uniform(size=4096) < 0.8
    for mb, db in ((6, 0), (5, 2)):
        got = shading.bin_key(sc, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(alive), mb, db)
        want = j_wavefront._bin_key(_JaxKeyScene(sc), jnp.asarray(o),
                                    jnp.asarray(d), jnp.asarray(alive),
                                    mb, db)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _box_key(o, d, alive, mn, mx, mb, db):
    """The bin key over the box ``mn..mx`` as ``shading.bin_key`` wrote it
    for a flattened scene's BVH root box before forests took the morton
    key: (octant, direction bits, morton cell of the origin)."""
    key = shading.octant(d) << (3 * mb + 3 * db)
    if db:
        dq = torch.clamp(torch.abs(d) * (1 << db), 0, (1 << db) - 1).to(
            torch.int32)
        key = key | (((dq[:, 0] << (2 * db)) | (dq[:, 1] << db) | dq[:, 2])
                     << (3 * mb))
    cell = torch.clamp(((o - mn) / torch.clamp(mx - mn, min=1e-6))
                       * (1 << mb), 0.0, float((1 << mb) - 1)).to(torch.int32)
    for b in range(mb):
        for ax in range(3):
            key = key | (((cell[:, ax] >> b) & 1) << (3 * b + ax))
    return torch.where(alive, key, 1 << 30).to(torch.int32)


def _seeded_lanes(box, n=4096, seed=5):
    rand = np.random.default_rng(seed)
    o = rand.uniform(box[0:3] - 1.0, box[3:6] + 1.0, (n, 3))
    d = rand.normal(size=(n, 3))
    d[::7, 1] = 0.0
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(rand.uniform(size=n) < 0.8))


@pytest.mark.parametrize("name", ["room", "sponza"])
def test_flattened_keys_are_unchanged(scenes, name):
    """A flattened scene keys over its BVH root box exactly as before
    forests took the morton key, and the shade kernel's constants carry
    that box."""
    sc = scenes[name]
    root = sc.bvh_packed[sc.obj_bvh_root[0].long()]
    o, d, alive = _seeded_lanes(root.numpy())
    for mb, db in ((6, 0), (5, 2), (0, 0)):
        got = shading.bin_key(sc, o, d, alive, mb, db)
        want = _box_key(o, d, alive, root[0:3], root[3:6], mb, db)
        assert same_bits(got, want), (mb, db)
    box = torch.cat([root[0:3], torch.clamp(root[3:6] - root[0:3], min=1e-6)])
    consts = shade.frame_constants(sc, first_wave(
        sc, trt.RenderConfig(**SIZE))[0].cam)
    assert same_bits(consts[16:22], box)


@pytest.mark.parametrize("name", ["room_forest", "maps_forest"])
def test_forest_key_has_the_forest_box_morton_bits(scenes, name):
    """A forest keys by (octant, morton cell of the origin) over its world
    box, the union of its instances' world boxes (the finite rows of
    ``meta["forest_cull"]``), as a flattened scene keys over its root box;
    the shade kernel's constants carry that box."""
    sc = scenes[name]
    rows = np.array(sc.meta["forest_cull"], np.float32)
    assert np.isfinite(rows).all() and len(rows) == len(sc.meta["obj_roots"])
    mn = torch.from_numpy(rows[:, 0:3].min(0))
    mx = torch.from_numpy(rows[:, 4:7].max(0))
    assert shading.morton_bits(sc)
    o, d, alive = _seeded_lanes(torch.cat([mn, mx]).numpy())
    for mb, db in ((6, 0), (5, 2)):
        got = shading.bin_key(sc, o, d, alive, mb, db)
        assert same_bits(got, _box_key(o, d, alive, mn, mx, mb, db))
        cells = got[alive] & ((1 << 3 * mb) - 1)
        assert cells.unique().numel() > 100  # morton bits, not octant alone
        octant = _box_key(o, d, alive, mn, mx, 0, db) << (3 * mb)
        assert same_bits(torch.where(alive, got >> 3 * mb << 3 * mb, got),
                         torch.where(alive, octant, got))
    consts = shade.frame_constants(sc, first_wave(
        sc, trt.RenderConfig(**SIZE))[0].cam)
    assert same_bits(consts[16:22],
                     torch.cat([mn, torch.clamp(mx - mn, min=1e-6)]))


def test_mesh_free_scenes_key_by_octant(scenes):
    """Without meshes the key is the octant alone and the constants' box
    zero."""
    sc = scenes["spheres"]
    o, d, alive = _seeded_lanes(np.array([-5, -5, -5, 5, 5, 5], np.float32))
    assert not shading.morton_bits(sc) and shading.bin_box(sc) is None
    assert same_bits(shading.bin_key(sc, o, d, alive, 6, 0),
                     torch.where(alive, shading.octant(d) << 18, 1 << 30))
    consts = shade.frame_constants(sc, first_wave(
        sc, trt.RenderConfig(**SIZE))[0].cam)
    assert not consts[16:22].any()


@pytest.mark.parametrize("name", ["room_forest", "sponza_forest"])
def test_forest_frame_is_the_same_under_the_octant_key(scenes, name):
    """A forest's frame through the round kernels' plain versions keyed by
    the morton cell and by the octant alone (``bin_bits=0``): the same
    image bit for bit, as every lane's path is its own."""
    sc = scenes[name]
    cfg = trt.RenderConfig(width=24, height=14, samples_per_pixel=2,
                           bounce_limit=8)
    img = trt.render(sc, cfg)
    assert img.mean() > 0.01
    assert torch.equal(img, trt.render(
        sc, cfg.replace(routing=trt.Routing(bin_bits=0))))


def _round_runs(sc, cfg):
    """``(live, runs)`` of each fused round of a frame: the live count
    and the tally's key runs, each round's runs checked against the
    distinct live keys torch finds in the wave it leaves."""
    c, round_, w = first_wave(sc, cfg)
    assert round_ is wavefront._fused_round
    out = []
    while int(w.n_alive) > 0:
        w = round_(c, w)
        key = shading.bin_key(sc, w.origin, w.direction, w.alive,
                              c.rt.bin_bits, c.rt.bin_dir_bits)
        live_keys = key[key != shading.DEAD_KEY]
        assert int(w.tally[3]) == live_keys.unique().numel()
        assert int(w.tally[3]) == int(shading.key_runs(key.sort().values))
        out.append((int(w.n_alive), int(w.tally[3])))
    return out


@pytest.mark.parametrize("name", ["room_forest", "sponza_forest", "sponza"])
def test_tally_counts_the_key_runs(scenes, name):
    """The tally's last word is the runs of equal keys among a round's
    live lanes after its sort.  Under the octant key a round has at most 8
    runs, so a run holds about a round's live lanes over 8; under the
    morton key many times fewer."""
    sc = scenes[name]
    cfg = trt.RenderConfig(width=48, height=27, samples_per_pixel=2,
                           bounce_limit=8)
    morton = _round_runs(sc, cfg)
    octant = _round_runs(sc, cfg.replace(routing=trt.Routing(bin_bits=0)))
    assert [n for n, _ in morton] == [n for n, _ in octant]
    assert all(r <= 8 and (r > 0) == (n > 0) for n, r in octant)
    per_run = lambda rounds: (sum(n for n, _ in rounds)
                              / sum(r for _, r in rounds))
    assert per_run(octant) >= sum(n for n, _ in octant) / (8 * len(octant))
    assert per_run(morton) * 8 < per_run(octant)


class _JaxKeyScene:
    """The two tables and the meta the JAX key reads, as JAX arrays."""

    def __init__(self, sc):
        self.bvh_packed = jnp.asarray(sc.bvh_packed.numpy())
        self.obj_bvh_root = jnp.asarray(sc.obj_bvh_root.numpy())
        self.meta = dict(sc.meta)


def test_resolve_matches_jax():
    """The NEE kernel's MIS resolve (its plain version,
    ``shading.resolve_direct``) against the JAX package's on seeded
    lanes: zero, negative and NaN pdfs included."""
    rand = np.random.default_rng(11)
    n = 4096
    pdf = rand.normal(size=n).astype(np.float32)
    pdf[::5] = 0.0
    pdf[::97] = np.nan
    cos_pdf = np.abs(rand.normal(size=n)).astype(np.float32)
    cos_pdf[::11] = 0.0
    l_emit = rand.uniform(0, 4, (n, 3)).astype(np.float32)
    nee_k = rand.uniform(0, 1, (n, 3)).astype(np.float32)
    is_diff = rand.uniform(size=n) < 0.7
    fresh = rand.uniform(size=n) < 0.6
    base = rand.normal(size=(n, 3)).astype(np.float32)
    for n_lights in (1.0, 2.0, 3.0):
        args = (pdf, n_lights, cos_pdf, l_emit, nee_k, is_diff, fresh, base)
        got = shading.resolve_direct(*(
            torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args))
        want = j_wavefront._resolve_direct(*(
            jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def jax_room(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("jroom"))
    return room_scene(jrt, tmp).compile().device_put()


def test_fused_frame_matches_jax(scenes, jax_room):
    """One frame of the room through the fused round against the JAX
    package's render of its group-kernel route (the Pallas kernel in
    interpret mode), at test_torch_render.py's tolerance."""
    kw = dict(width=24, height=18, samples_per_pixel=4, bounce_limit=6)
    cfg = trt.RenderConfig(**kw)
    assert wavefront._fused_round_ok(scenes["room"], cfg,
                                     cfg.resolved_routing())
    got = trt.render(scenes["room"], cfg)
    want = jrt.render(jax_room, jrt.RenderConfig(
        routing=JRouting(packet="interpret", groups=4, groups_packet=512),
        **kw))
    assert_images_match(got.numpy(), np.asarray(want))


C_SCALARS = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
             "float": ctypes.c_float}


def c_struct_fields(src, name):
    """``[(field, ctypes type)]`` of ``struct name { ... };`` in the C
    source ``src``: a pointer of any type as ``c_void_p``, else its scalar
    type, one entry for each name of a declaration list."""
    import re

    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (" ".join(d.split()) for d in body.split(";"))):
        m = re.fullmatch(r"(.*?)(\*?) ?([A-Za-z_]\w*(?:, [A-Za-z_]\w*)*)",
                         decl)
        assert m, decl
        ctype = ctypes.c_void_p if m.group(2) else C_SCALARS[m.group(1).strip()]
        fields += [(field, ctype) for field in m.group(3).split(", ")]
    return fields


@pytest.mark.parametrize("name,mirror", [("ShadeArgs", shade._ShadeArgs),
                                         ("NeeArgs", shade._NeeArgs)])
def test_argument_structs_match_the_source(name, mirror):
    """The ctypes mirrors of the kernels' argument structs name the
    source's fields in its order with its C types, so the wrappers fill
    every field where the kernel reads it."""
    with open(shade._SRC) as f:
        want = c_struct_fields(f.read(), name)
    assert len(want) > 10
    assert [(field, t) for field, t in mirror._fields_] == want
