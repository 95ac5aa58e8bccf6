"""The port's rope-walk route against the JAX rope-walk kernel.

The port's streams hold only the tree's BOX rows, 8 floats each, with a
leaf's triangles read from ``tri_packed``; its own build equals
``rope_box_rows`` of the JAX package's streams (BOX and TRI rows) bit for
bit.  On CPU ``lanewalk_traverse`` runs its plain torch version (the CUDA
kernel's twin) on that layout; the JAX side runs ``_lanewalk_kernel``
through Pallas' interpreter on the JAX scene's own streams.  Walking
each 1024-ray block in the block's majority octant, as the TPU kernel
does, the port tests the same boxes and triangles in the same order:
``prim`` equal and ``dst`` within the cross-implementation tolerance of
tests/test_torch_group.py (XLA contracts multiply-adds into FMAs, the port
does not).  Walking each ray in its own octant, the port's default, only
ties can change ``prim``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.kernels import lanewalk as j_lanewalk
from ray_tracer_tpu.ops import traverse as j_traverse
from ray_tracer_tpu_torch import CompiledScene, Routing
from ray_tracer_tpu_torch.kernels import lanewalk as t_lanewalk
from ray_tracer_tpu_torch.ops import traverse as t_traverse
from ray_tracer_tpu_torch.scene.types import (
    ROPE_DEAD,
    rope_box_rows,
    rope_leaf_words,
    rope_rows_layout,
)

from torch_parity import (
    assert_tri_ties,
    room_scene,
    route_rays,
    route_tmax,
    scene_arrays,
    soup_scene,
)

BIG = 99999999.0
SCENES = {
    "soup_leaf4": (soup_scene, dict(max_leaf_tris=4)),
    "soup_leaf8": (soup_scene, dict(max_leaf_tris=8)),
    "room": (room_scene, {}),
}
TOL = dict(rtol=1e-5, atol=1e-6)
N = 1500  # two 1024-ray blocks, the second one partly padding


@pytest.fixture(scope="module", params=list(SCENES))
def scenes(request, tmp_path_factory):
    """(JAX scene, the port's scene of the same arrays, its name, the
    builder directory)."""
    make, kw = SCENES[request.param]
    tmp = str(tmp_path_factory.mktemp("lanewalk"))
    jsc = make(jrt, tmp).compile(**kw)
    sc = CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")
    assert sc.meta["rope_rows"] > 0
    return jsc.device_put(), sc, request.param, tmp


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_streams_match_jax(scenes):
    """The port's own build equals the conversion of the JAX package's
    streams bit for bit (one BOX row per binary node); ``from_numpy`` of
    the JAX scene converts them to the same tensor; every JAX BOX row's
    hit link is the next row, which the BOX-only layout relies on."""
    jsc, sc, name, tmp = scenes
    make, kw = SCENES[name]
    own = make(trt, tmp).compile(device="cpu", rope_streams=True, **kw)
    jstreams = np.asarray(jsc.rope_streams)
    n_tris = own.tri_packed.shape[0]
    box, n_box = rope_box_rows(jstreams, jsc.meta["rope_rows"], n_tris)
    assert own.meta["rope_rows"] == n_box == own.bvh_packed.shape[0]
    assert own.rope_streams.shape == (8, n_box, 8)
    assert torch.equal(_bits(own.rope_streams), _bits(torch.from_numpy(box)))
    assert torch.equal(_bits(own.rope_streams), _bits(sc.rope_streams))
    assert sc.meta["rope_rows"] == n_box
    rows = rope_rows_layout(jstreams)[:, :jsc.meta["rope_rows"]]
    for o in range(8):
        at = np.nonzero(rows[o, :, 15] <= 0.5)[0]
        assert at.size == n_box
        np.testing.assert_array_equal(rows[o, at, 6], at + 1)
    # every leaf's triangles: the words cover each triangle once per octant
    words = _bits(own.rope_streams)[..., 7].long()
    count = words >> 24
    assert int(count.sum()) == 8 * n_tris
    assert bool((words[count == 0] == 0).all())


def _block_majority_octants(d):
    """The TPU kernel's stream per ray: its 1024-ray block's most common
    direction octant, padding lanes counting as octant 0."""
    octs = ((d[:, 0] < 0) + 2 * (d[:, 1] < 0) + 4 * (d[:, 2] < 0)).astype(
        np.int32)
    pad = -len(octs) % 1024
    blocks = np.pad(octs, (0, pad)).reshape(-1, 1024)
    counts = (blocks[:, :, None] == np.arange(8)).sum(axis=1)
    return np.repeat(counts.argmax(axis=1), 1024)[: len(octs)].astype(
        np.int32)


def _both(jsc, sc, o, d, tmax, anyhit, octant=None):
    """The port's plain walk on its BOX-row streams and the JAX kernel on
    the JAX scene's own streams."""
    args = [torch.from_numpy(x) for x in (o, d, tmax)]
    t_lanewalk.reset_launches()
    got = t_lanewalk.lanewalk_traverse(
        sc.rope_streams, sc.tri_packed, sc.meta["rope_rows"], *args,
        anyhit=anyhit,
        octant=None if octant is None else torch.from_numpy(octant))
    assert sum(t_lanewalk.launches.values()) == 0  # CPU: the plain version
    want = j_lanewalk.lanewalk_traverse(
        jsc.rope_streams, jsc.meta["rope_rows"],
        *(jnp.asarray(x) for x in (o, d, tmax)), interpret=True,
        anyhit=anyhit)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive"])
def test_block_majority_octants_match_jax(scenes, rand, case):
    """Given the TPU kernel's octants the walk is the TPU kernel's: the
    same prim on every ray."""
    jsc, sc, name, _ = scenes
    o, d = route_rays(rand, name, N)
    tmax = route_tmax(rand, case, N)
    (dst, prim), (jdst, jprim) = _both(jsc, sc, o, d, tmax, False,
                                       _block_majority_octants(d))
    np.testing.assert_array_equal(prim, jprim)
    assert (prim >= 0).sum() > 50
    np.testing.assert_allclose(dst, jdst, **TOL)
    np.testing.assert_array_equal(dst[prim < 0], tmax[prim < 0])


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive"])
def test_own_octants_match_jax(scenes, rand, case):
    """Each ray in its own octant: the same hits and distances, ``prim``
    off the TPU kernel's only on ties."""
    jsc, sc, name, _ = scenes
    o, d = route_rays(rand, name, N)
    tmax = route_tmax(rand, case, N)
    (dst, prim), (jdst, jprim) = _both(jsc, sc, o, d, tmax, False)
    hit = jprim >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(dst, jdst, **TOL)
    if case == "inactive":
        assert not hit[::3].any()
    assert_tri_ties(sc, o, d, prim, jprim, hit)


@pytest.mark.parametrize("majority", [False, True])
def test_anyhit_matches_jax(scenes, rand, majority):
    jsc, sc, name, _ = scenes
    o, d = route_rays(rand, name, N)
    tmax = rand.uniform(0.1, 6.0, N).astype(np.float32)
    tmax[::7] = -BIG
    (dst, prim), (jdst, _) = _both(
        jsc, sc, o, d, tmax, True,
        _block_majority_octants(d) if majority else None)
    occ = jdst < -1.0
    live = tmax > -BIG
    assert 0 < (occ & live).sum() < live.sum()
    np.testing.assert_array_equal(dst < -1.0, occ)
    np.testing.assert_array_equal(dst[~occ], tmax[~occ])
    np.testing.assert_array_equal(dst[~live], np.float32(-BIG))  # untouched
    assert (prim == -1).all()


def test_rope_route_matches_jax(scenes, rand):
    """``traverse`` and ``traverse_anyhit`` under
    ``Routing(lanewalk="force")`` against the JAX package's rope-walk
    route (its kernel in interpret mode), spheres included on the room
    scene."""
    jsc, sc, name, _ = scenes
    n = 700
    o, d = route_rays(rand, name, n)
    act = np.ones(n, bool)
    act[::5] = False
    rt = Routing(lanewalk="force")
    jrt_ = JRouting(packet="off", lanewalk="interpret")
    assert t_traverse.prim_space(sc, rt) == "tri"
    assert j_traverse.prim_space(jsc, jrt_) == "tri"
    t_args = [torch.from_numpy(x) for x in (o, d, act)]
    j_args = [jnp.asarray(x) for x in (o, d, act)]
    got = t_traverse.traverse(sc, *t_args, routing=rt)
    want = j_traverse.traverse(jsc, *j_args, raw=True, routing=jrt_,
                               need_uv=False)
    kind = got.kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(want.kind))
    tri = kind == t_traverse.KIND_TRI
    assert tri.sum() > 20
    np.testing.assert_allclose(got.dst.numpy(), np.asarray(want.dst), **TOL)
    assert_tri_ties(sc, o, d, got.prim.numpy(), np.asarray(want.prim), tri)

    tmax = route_tmax(rand, "clipped", n)
    occ = t_traverse.traverse_anyhit(sc, *t_args, torch.from_numpy(tmax),
                                     routing=rt)
    jocc = j_traverse.traverse_anyhit(jsc, *j_args, jnp.asarray(tmax),
                                      routing=jrt_)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert 0 < occ.sum() < act.sum()
    assert not occ.numpy()[~act].any()


def test_streams_only_when_asked(tmp_path):
    """``compile()`` builds no streams by default (a one-row placeholder,
    ``rope_rows`` 0), and asking for the route then raises, naming the
    option that builds them."""
    sc = soup_scene(trt, str(tmp_path)).compile(device="cpu")
    assert sc.meta["rope_rows"] == 0
    assert tuple(sc.rope_streams.shape) == (1, 1, 8)
    n = 4
    args = [torch.zeros(n, 3), torch.ones(n, 3), torch.ones(n, dtype=bool)]
    with pytest.raises(ValueError, match=r"compile\(rope_streams=True\)"):
        t_traverse.traverse(sc, *args, routing=Routing(lanewalk="force"))
    with pytest.raises(ValueError, match=r"compile\(rope_streams=True\)"):
        t_traverse.traverse_anyhit(sc, *args, torch.ones(n),
                                   routing=Routing(lanewalk="force"))
    with pytest.raises(ValueError, match=r"compile\(rope_streams=True\)"):
        t_lanewalk.lanewalk_traverse(sc.rope_streams, sc.tri_packed, 0,
                                     args[0], args[1], torch.ones(n))
    # "auto" reads as "off", as the JAX package's off-TPU default
    hit = t_traverse.traverse(sc, *args, routing=Routing(lanewalk="auto"))
    assert hit.kind.shape == (n,)


def test_no_plain_version_off_the_cpu(scenes):
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises."""
    _, sc, _, _ = scenes
    n = 8
    args = [t.to("meta") for t in (sc.rope_streams, sc.tri_packed,
                                   torch.zeros(n, 3), torch.ones(n, 3),
                                   torch.full((n,), BIG))]
    with pytest.raises(ValueError, match="no rope-walk kernel"):
        t_lanewalk.lanewalk_traverse(args[0], args[1], sc.meta["rope_rows"],
                                     *args[2:])


@pytest.mark.parametrize("value", ["interpret", "on"])
def test_bad_lanewalk_values_raise(value):
    with pytest.raises(ValueError, match="lanewalk"):
        Routing(lanewalk=value)


def test_malformed_stream_raises(scenes):
    """A stream whose miss links loop back ends in an error after n_rows +
    2 steps, not in an endless walk; a miss link out of the stream raises
    too."""
    _, sc, name, _ = scenes
    rand = np.random.default_rng(3)
    o, d = route_rays(rand, name, 64)
    args = [torch.from_numpy(o), torch.from_numpy(d),
            torch.full((64,), BIG)]
    n_rows = sc.meta["rope_rows"]
    streams = sc.rope_streams.clone()
    streams[:, :, 6] = 0.0  # every miss links back to row 0
    with pytest.raises(RuntimeError, match="did not end"):
        t_lanewalk.lanewalk_traverse(streams, sc.tri_packed, n_rows, *args)
    streams = sc.rope_streams.clone()
    streams[:, :, 6] = float(n_rows)  # every miss links past the end
    with pytest.raises(RuntimeError, match="left its stream"):
        t_lanewalk.lanewalk_traverse(streams, sc.tri_packed, n_rows, *args)


@pytest.mark.parametrize("case", ["count", "first", "past_the_triangles"])
def test_leaf_word_limits_raise(case):
    """A leaf beyond the leaf word's limits (126 triangles, a first
    triangle below 2^24, within the scene's triangles) raises
    ``ValueError``, from the word and from the build of the streams."""
    first, count, n_tris = {
        "count": (0, 127, 1000),
        "first": (1 << 24, 1, (1 << 24) + 1),
        "past_the_triangles": (998, 3, 1000),
    }[case]
    with pytest.raises(ValueError, match="leaf word"):
        rope_leaf_words(np.array([0, first]), np.array([0, count]), n_tris)
    # a root over two leaves, the second one beyond the limits
    index = np.array([1, 0, first])
    cnt = np.array([0, 1, count])
    links = np.full((8, 3), t_lanewalk.SENTINEL)
    links[:, 0] = 1
    links[:, 1] = 2
    with pytest.raises(ValueError, match="leaf word"):
        t_lanewalk.build_rope_streams(np.zeros((3, 3)), np.ones((3, 3)),
                                      index, cnt, links, links, n_tris)
    # at the limits the words hold
    w = rope_leaf_words(np.array([(1 << 24) - 1, 0]), np.array([126, 0]),
                        1 << 25)
    assert w[0] == (126 << 24) + (1 << 24) - 1 and w[1] == 0
    assert np.isfinite(w.view(np.float32)).all()


@pytest.mark.parametrize("fault", ["hit_link", "tri_ids", "miss_to_tri"])
def test_conversion_refuses_other_streams(scenes, fault):
    """``rope_box_rows`` raises on JAX-layout streams that the BOX-only
    layout cannot hold: a hit link other than the next row, a leaf whose
    TRI rows are not its consecutive triangles, a miss link to a TRI
    row."""
    jsc, sc, _, _ = scenes
    n_rows = jsc.meta["rope_rows"]
    rows = rope_rows_layout(np.asarray(jsc.rope_streams)).copy()
    tri = np.nonzero(rows[0, :n_rows, 15] > 0.5)[0]
    box = np.nonzero(rows[0, :n_rows, 15] <= 0.5)[0]
    if fault == "hit_link":
        rows[3, box[1], 6] += 1.0
    elif fault == "tri_ids":
        rows[0, tri[0], 14] += 1.0
    else:
        live = box[rows[0, box, 7] < ROPE_DEAD]
        rows[0, live[0], 7] = tri[0]
    with pytest.raises(ValueError):
        rope_box_rows(rows, n_rows, sc.tri_packed.shape[0])


def test_twin_stats_count_the_walk(scenes, rand):
    """The plain walk's stats, which bound the kernel's work: BOX steps and
    triangle tests, the distinct BOX rows and triangles; anyhit stops a
    lane at its first accepted triangle, so it tests no more."""
    _, sc, name, _ = scenes
    o, d = route_rays(rand, name, 400)
    args = [torch.from_numpy(x) for x in (o, d)]
    n_rows = sc.meta["rope_rows"]
    stats = {}
    t_lanewalk.lanewalk_traverse_reference(
        sc.rope_streams, sc.tri_packed, n_rows, *args,
        torch.full((400,), BIG), stats=stats)
    assert 400 <= stats["box"] <= 400 * n_rows
    assert stats["row_seen"].shape == (8 * n_rows,)
    assert 0 < int(stats["row_seen"].sum()) <= stats["box"]
    assert 0 < int(stats["tri_seen"].sum()) <= stats["tri"]
    shadow = {}
    t_lanewalk.lanewalk_traverse_reference(
        sc.rope_streams, sc.tri_packed, n_rows, *args,
        torch.full((400,), BIG), anyhit=True, stats=shadow)
    assert shadow["box"] <= stats["box"] and shadow["tri"] <= stats["tri"]


def test_route_reads_the_error_flag_with_the_round(scenes, monkeypatch):
    """On the card the route's rope walks OR into one flag that the
    integrator reads with each round's live count; a set flag raises
    within the round.  (Here the flag is handed to the CPU integrator.)"""
    _, sc, _, _ = scenes
    flag = torch.ones(1, dtype=torch.int32)
    monkeypatch.setattr(t_traverse, "rope_error_flag",
                        lambda *a: flag)
    cfg = trt.RenderConfig(width=8, height=8, samples_per_pixel=1,
                           bounce_limit=2,
                           routing=Routing(lanewalk="force"))
    with pytest.raises(RuntimeError, match="did not end"):
        trt.render(sc, cfg)
    flag.zero_()
    assert bool(torch.isfinite(trt.render(sc, cfg)).all())
    t_lanewalk.raise_on_flag(0, 10)
    with pytest.raises(RuntimeError, match="did not end within 12 steps"):
        t_lanewalk.raise_on_flag(1, 10)
