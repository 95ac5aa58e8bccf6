"""The port's bench (``python -m ray_tracer_tpu_torch.bench``) and the
``RT_*`` routing variables, on CPU.

* ``bench.run`` under ``RT_BENCH_CPU`` against a JAX loop written here
  after the JAX bench's (``bench.py``: one ``trace_wave(...,
  with_stats=True)`` per tile, the last tile's ids clamped to the last
  pixel, frame 1), on ``sponza_proxy`` at a size that is not a multiple
  of the tile.
* ``Routing.from_env`` and ``RenderConfig().resolved_routing()`` against
  the JAX package's under each variable; the traversal and the compile
  read them where ``routing`` or ``spatial_splits`` is None.
* Without a card and without ``RT_BENCH_CPU`` the bench prints no value;
  a scene whose files are missing raises with the file's name.
"""

import functools

import numpy as np
import pytest
import torch

import ray_tracer_tpu as jrt
from ray_tracer_tpu.config import Routing as JRouting
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch import bench
from ray_tracer_tpu_torch.ops import traverse
from ray_tracer_tpu_torch.scene import presets as t_presets

from torch_parity import stand_in_assets

ROUTING_VARS = ("RT_BIN_BITS", "RT_BIN_DIR_BITS", "RT_BIN_MODE",
                "RT_NEE_PREBIN", "RT_WIDE", "RT_GROUPS", "RT_ANYHIT_GROUP",
                "RT_CLUSTER", "RT_CLUSTER_K", "RT_CLUSTER_ENUM",
                "RT_LANEWALK", "RT_TWO_PHASE", "RT_TOP_K")
SMALL = dict(width=24, height=16, spp=2, tile_log2=8)  # 384 px, tiles of 256
N_TRIS = 3000


@pytest.fixture
def clean_env(monkeypatch):
    """No RT_* routing or bench variable set."""
    for var in ROUTING_VARS + ("RT_SBVH", "RT_BENCH_CPU"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def jax_bench(scene, width, height, spp, tile_log2):
    """The JAX bench's measure of frame 1 (``bench.py``'s tile loop) ->
    (checksum, (semantic, traced) rays)."""
    import jax
    import jax.numpy as jnp
    from ray_tracer_tpu.api import _camera_arrays, scene_camera
    from ray_tracer_tpu.integrator import wavefront

    cfg = jrt.RenderConfig(width=width, height=height, bounce_limit=8,
                           max_rays_per_batch=1 << tile_log2)
    cam = _camera_arrays(scene_camera(scene), cfg)
    n_pix = cfg.n_pixels
    tile = min(n_pix, cfg.max_rays_per_batch)

    @functools.partial(jax.jit, static_argnames=("cfg", "n_spp"))
    def tile_with_stats(scene, cam, frame, t, cfg, n_spp):
        ids = jnp.minimum(t * tile + jnp.arange(tile, dtype=jnp.int32),
                          jnp.int32(n_pix - 1))
        c, nr = wavefront.trace_wave(scene, *cam, ids, frame, jnp.int32(0),
                                     n_spp, cfg, with_stats=True)
        return jnp.sum(c), nr

    checksum, n_rays = 0.0, np.zeros(2)
    for t in range(-(-n_pix // tile)):
        c, nr = tile_with_stats(scene, cam, jnp.int32(1), jnp.int32(t),
                                cfg=cfg, n_spp=spp)
        checksum += float(c)
        n_rays += np.asarray(nr)
    return checksum, n_rays


def test_bench_matches_jax_bench(tmp_path, clean_env):
    """The line's checksum and ray counts against the JAX bench's loop on
    the same scene: the ray counts within rtol 1e-3 (a path that parts at
    an exact-t tie moves its rays, as ``test_torch_features.py`` allows)
    and the checksum within rtol 1e-4 (float32 sums in another order; on
    this scene no path parts, and one that did would move a sample's
    radiance, about 1e-3 of the sum)."""
    from ray_tracer_tpu.scene import presets as j_presets

    clean_env.setattr(j_presets, "DEFAULT_ASSETS",
                      stand_in_assets(str(tmp_path)))
    jsc = j_presets.sponza_proxy(N_TRIS).compile().device_put()
    want_sum, want_rays = jax_bench(jsc, **SMALL)

    clean_env.setenv("RT_BENCH_CPU", "1")
    line = bench.run(**{**SMALL, "scene": f"sponza_proxy:{N_TRIS}",
                        "cpu": bench.env_knobs()["cpu"]})
    assert line["device"] == "cpu" and line["gate"] == "cpu"
    assert line["metric"] == (f"Mrays/s sponza_proxy:{N_TRIS} @24x16 spp2 "
                              "b8")
    assert line["routing"] == {f: getattr(trt.Routing(), f)
                               for f in line["routing"]}
    assert line["repeats_bitwise"]
    assert len(line["frame_s_all"]) == bench.TIMED
    assert line["frame_s"] == sorted(line["frame_s_all"])[1]
    assert line["value"] == pytest.approx(
        line["rays_sem"] / line["frame_s"] / 1e6)
    assert sum(line["launches"].values()) == 0  # the CPU runs no kernel
    np.testing.assert_allclose([line["rays_sem"], line["rays_traced"]],
                               want_rays, rtol=1e-3)
    np.testing.assert_allclose(line["checksum"], want_sum, rtol=1e-4)


def test_last_tile_is_clamped(clean_env):
    """The last tile's padded lanes trace pixel n_pix - 1 again and count:
    two tiles of 256 over 384 pixels trace more rays than one whole-frame
    tile, and the ids are the JAX bench's."""
    ids = bench.tile_ids(1, 256, 384, "cpu")
    assert ids.tolist() == [min(256 + i, 383) for i in range(256)]
    sc = t_presets.sponza_proxy(N_TRIS).compile(device="cpu")
    tiled = trt.RenderConfig(width=24, height=16, bounce_limit=8,
                             max_rays_per_batch=256)
    whole = tiled.replace(max_rays_per_batch=1 << 21)
    m_tiled = bench.measure(sc, tiled, 2, timed=1, warmup=False)
    m_whole = bench.measure(sc, whole, 2, timed=1, warmup=False)
    assert m_tiled["rays_sem"] > m_whole["rays_sem"]


VALUES = [  # a non-default value of each variable; then the JAX parse
    ("RT_BIN_BITS", "4"), ("RT_BIN_DIR_BITS", "2"), ("RT_BIN_MODE", "hier"),
    ("RT_NEE_PREBIN", "sort"), ("RT_WIDE", "0"), ("RT_GROUPS", "0"),
    ("RT_ANYHIT_GROUP", "0"), ("RT_CLUSTER", "on"), ("RT_CLUSTER_K", "8"),
    ("RT_CLUSTER_ENUM", "boxes"), ("RT_LANEWALK", "force"),
    ("RT_TWO_PHASE", "1"), ("RT_TOP_K", "3"),
    ("RT_WIDE", "false"),  # != "0": still wide
    ("RT_TWO_PHASE", "2"),  # != "0": two-phase
    ("RT_ANYHIT_GROUP", "true"),  # not "1": off
]


@pytest.mark.parametrize("var,value", VALUES)
def test_from_env_matches_jax(clean_env, var, value):
    clean_env.setenv(var, value)
    want = JRouting.from_env()
    fields = [f.name for f in trt.Routing.__dataclass_fields__.values()]
    assert len(fields) == 13
    for got in (trt.Routing.from_env(),
                trt.RenderConfig().resolved_routing()):
        assert {f: getattr(got, f) for f in fields} == \
            {f: getattr(want, f) for f in fields}
    # an explicit Routing reads no variable
    assert trt.RenderConfig(routing=trt.Routing()).resolved_routing() == \
        trt.Routing()


def test_from_env_unset_is_the_default(clean_env):
    assert trt.Routing.from_env() == trt.Routing()
    assert trt.RenderConfig().resolved_routing() == trt.Routing()


@pytest.mark.parametrize("var,value", [("RT_BIN_MODE", "zorder"),
                                       ("RT_LANEWALK", "interpret"),
                                       ("RT_TOP_K", "0")])
def test_from_env_checks_values(clean_env, var, value):
    clean_env.setenv(var, value)
    with pytest.raises(ValueError):
        trt.Routing.from_env()


def test_traverse_resolves_from_env(clean_env):
    """``routing=None`` in the traversal reads the variables: the rope walk
    asked for by ``RT_LANEWALK=force`` raises on a scene without its
    streams, and the narrow route of ``RT_WIDE=0`` names global triangle
    ids."""
    sc = t_presets.sponza_proxy(2000).compile(device="cpu")
    o = torch.tensor([[0.0, -1.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    active = torch.ones(1, dtype=torch.bool)
    assert traverse.prim_space(sc) == "slot"
    clean_env.setenv("RT_WIDE", "0")
    assert traverse.prim_space(sc) == "tri"
    clean_env.delenv("RT_WIDE")
    clean_env.setenv("RT_LANEWALK", "force")
    with pytest.raises(ValueError, match="rope_streams"):
        traverse.traverse(sc, o, d, active)
    with pytest.raises(ValueError, match="rope_streams"):
        traverse.traverse_anyhit(sc, o, d, active, torch.full((1,), 1e30))


@pytest.mark.parametrize("value,spatial", [(None, True), ("1", True),
                                           ("0", False)])
def test_compile_reads_rt_sbvh(clean_env, value, spatial):
    """``compile(spatial_splits=None)`` builds spatial splits unless
    ``RT_SBVH=0``, as the JAX builder does."""
    b = t_presets.sponza_proxy(2000)
    want = b.compile(spatial_splits=spatial, device="cpu")
    if value is not None:
        clean_env.setenv("RT_SBVH", value)
    got = b.compile(device="cpu")
    assert got.meta["n_tris"] == want.meta["n_tris"]
    for f in want.array_fields():  # NaN pads the empty BVH8 slots
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("var,value,table", [
    ("RT_LANEWALK", "force", "rope_rows"), ("RT_CLUSTER", "on",
                                            "n_clusters")])
def test_bench_compiles_the_routes_tables(clean_env, var, value, table):
    """The route of the variables gets its tables, and its line agrees with
    the default route's within 1%."""
    kw = {**SMALL, "scene": "sponza_proxy:2000", "cpu": True, "timed": 1}
    default = bench.run(**kw)
    assert default["routing"][var[3:].lower()] != value
    clean_env.setenv(var, value)
    sc = bench.build_scene("sponza_proxy:2000", trt.Routing.from_env(),
                           "cpu")
    assert sc.meta[table] > 0
    line = bench.run(**kw)
    assert line["routing"][var[3:].lower()] == value
    for key in ("checksum", "rays_sem"):
        assert line[key] == pytest.approx(default[key], rel=1e-2)


def test_no_card_prints_no_value(clean_env, capsys):
    """Without a card and without ``RT_BENCH_CPU``: a non-zero exit, the
    reason on stderr and no value."""
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() != 0
    out, err = capsys.readouterr()
    assert "value" not in out and "CUDA" in err
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(**SMALL)


@pytest.mark.parametrize("scene,missing", [
    ("cornell", "cube.obj"), ("klein_bottle.obj", "klein_bottle.obj"),
    ("no_such_mesh.obj", "no_such_mesh.obj")])
def test_missing_assets_raise_with_the_file(tmp_path, clean_env, scene,
                                            missing):
    clean_env.setattr(t_presets, "DEFAULT_ASSETS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=missing) as err:
        bench.run(**{**SMALL, "scene": scene, "cpu": True})
    assert str(tmp_path) in str(err.value)


def test_env_knobs(clean_env):
    assert bench.env_knobs({}) == dict(
        width=1920, height=1080, spp=2, scene="sponza_proxy", tile_log2=21,
        cpu=False)
    assert bench.env_knobs({
        "RT_BENCH_WIDTH": "32", "RT_BENCH_HEIGHT": "18", "RT_BENCH_SPP": "4",
        "RT_BENCH_SCENE": "cornell", "RT_BENCH_TILE_LOG2": "8",
        "RT_BENCH_CPU": "1"}) == dict(width=32, height=18, spp=4,
                                      scene="cornell", tile_log2=8, cpu=True)


def test_images_agree():
    """The gate: >= 99% of pixels within 2e-3, mean |diff| < 1e-3, and a
    finite card image."""
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(rng.random((36, 64, 3), dtype=np.float32))
    assert bench.images_agree(ref.clone(), ref)["agree"]
    near = ref + 1e-3
    assert bench.images_agree(near, ref)["agree"]
    few = ref.clone()
    few[0, :20] += 1.0  # 20 of 2304 pixels, 0.9%, by a whole sample
    stats = bench.images_agree(few, ref)
    assert stats["pixels_within_2e3"] > 0.99 and not stats["agree"]
    off = ref.clone()
    off[:1] += 0.1  # 64 pixels, 2.8%
    assert not bench.images_agree(off, ref)["agree"]
    bad = ref.clone()
    bad[5, 5, 0] = float("nan")
    assert not bench.images_agree(bad, ref)["agree"]
