"""The port's rope-walk route against the JAX rope-walk kernel.

The port builds the same per-octant row streams as the JAX package, in a
row-major layout: equal bit for bit after ``rope_rows_layout``.  On CPU
``lanewalk_traverse`` runs its plain torch version (the CUDA kernel's
twin); the JAX side runs ``_lanewalk_kernel`` through Pallas'
interpreter.  Walking each 1024-ray block in the block's majority octant,
as the TPU kernel does, the port visits the same rows in the same order:
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
from ray_tracer_tpu_torch.scene.types import rope_rows_layout

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


def test_streams_match_jax(scenes):
    """The port's own build equals the JAX package's streams bit for bit
    after the layout change; ``from_numpy`` of the JAX scene converts its
    layout to the same tensor."""
    jsc, sc, name, tmp = scenes
    make, kw = SCENES[name]
    own = make(trt, tmp).compile(device="cpu", rope_streams=True, **kw)
    jstreams = np.asarray(jsc.rope_streams)
    assert own.meta["rope_rows"] == jsc.meta["rope_rows"]
    assert own.rope_streams.shape == (8, jstreams.shape[1] * 128, 16)
    np.testing.assert_array_equal(own.rope_streams.numpy(),
                                  rope_rows_layout(jstreams))
    assert torch.equal(own.rope_streams, sc.rope_streams)


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


def _both(sc, o, d, tmax, anyhit, octant=None):
    args = [torch.from_numpy(x) for x in (o, d, tmax)]
    t_lanewalk.reset_launches()
    got = t_lanewalk.lanewalk_traverse(
        sc.rope_streams, sc.meta["rope_rows"], *args, anyhit=anyhit,
        octant=None if octant is None else torch.from_numpy(octant))
    assert sum(t_lanewalk.launches.values()) == 0  # CPU: the plain version
    want = j_lanewalk.lanewalk_traverse(
        jnp.asarray(j_rope_streams(sc)), sc.meta["rope_rows"],
        *(jnp.asarray(x) for x in (o, d, tmax)), interpret=True,
        anyhit=anyhit)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


def j_rope_streams(sc):
    """The JAX layout of the port's streams (the inverse of
    ``rope_rows_layout``)."""
    s = sc.rope_streams.numpy()
    return s.reshape(8, -1, 128, 16).transpose(0, 1, 3, 2).reshape(
        8, -1, 16 * 128)


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive"])
def test_block_majority_octants_match_jax(scenes, rand, case):
    """Given the TPU kernel's octants the walk is the TPU kernel's: the
    same prim on every ray."""
    _, sc, name, _ = scenes
    o, d = route_rays(rand, name, N)
    tmax = route_tmax(rand, case, N)
    (dst, prim), (jdst, jprim) = _both(sc, o, d, tmax, False,
                                       _block_majority_octants(d))
    np.testing.assert_array_equal(prim, jprim)
    assert (prim >= 0).sum() > 50
    np.testing.assert_allclose(dst, jdst, **TOL)
    np.testing.assert_array_equal(dst[prim < 0], tmax[prim < 0])


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive"])
def test_own_octants_match_jax(scenes, rand, case):
    """Each ray in its own octant: the same hits and distances, ``prim``
    off the TPU kernel's only on ties."""
    _, sc, name, _ = scenes
    o, d = route_rays(rand, name, N)
    tmax = route_tmax(rand, case, N)
    (dst, prim), (jdst, jprim) = _both(sc, o, d, tmax, False)
    hit = jprim >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(dst, jdst, **TOL)
    if case == "inactive":
        assert not hit[::3].any()
    assert_tri_ties(sc, o, d, prim, jprim, hit)


@pytest.mark.parametrize("majority", [False, True])
def test_anyhit_matches_jax(scenes, rand, majority):
    _, sc, name, _ = scenes
    o, d = route_rays(rand, name, N)
    tmax = rand.uniform(0.1, 6.0, N).astype(np.float32)
    tmax[::7] = -BIG
    (dst, prim), (jdst, _) = _both(
        sc, o, d, tmax, True, _block_majority_octants(d) if majority else None)
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
    assert tuple(sc.rope_streams.shape) == (1, 1, 16)
    n = 4
    args = [torch.zeros(n, 3), torch.ones(n, 3), torch.ones(n, dtype=bool)]
    with pytest.raises(ValueError, match=r"compile\(rope_streams=True\)"):
        t_traverse.traverse(sc, *args, routing=Routing(lanewalk="force"))
    with pytest.raises(ValueError, match=r"compile\(rope_streams=True\)"):
        t_traverse.traverse_anyhit(sc, *args, torch.ones(n),
                                   routing=Routing(lanewalk="force"))
    with pytest.raises(ValueError, match=r"compile\(rope_streams=True\)"):
        t_lanewalk.lanewalk_traverse(sc.rope_streams, 0, args[0], args[1],
                                     torch.ones(n))
    # "auto" reads as "off", as the JAX package's off-TPU default
    hit = t_traverse.traverse(sc, *args, routing=Routing(lanewalk="auto"))
    assert hit.kind.shape == (n,)


def test_no_plain_version_off_the_cpu(scenes):
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises."""
    _, sc, _, _ = scenes
    n = 8
    args = [t.to("meta") for t in (sc.rope_streams, torch.zeros(n, 3),
                                   torch.ones(n, 3), torch.full((n,), BIG))]
    with pytest.raises(ValueError, match="no rope-walk kernel"):
        t_lanewalk.lanewalk_traverse(args[0], sc.meta["rope_rows"],
                                     *args[1:])


@pytest.mark.parametrize("value", ["interpret", "on"])
def test_bad_lanewalk_values_raise(value):
    with pytest.raises(ValueError, match="lanewalk"):
        Routing(lanewalk=value)


def test_malformed_stream_raises(scenes):
    """A stream whose links loop back ends in an error after n_rows + 2
    steps, not in an endless walk; a link out of the stream raises too."""
    _, sc, name, _ = scenes
    rand = np.random.default_rng(3)
    o, d = route_rays(rand, name, 64)
    args = [torch.from_numpy(o), torch.from_numpy(d),
            torch.full((64,), BIG)]
    streams = sc.rope_streams.clone()
    streams[:, :, 6:8] = 0.0  # every BOX row links back to row 0
    with pytest.raises(RuntimeError, match="did not end"):
        t_lanewalk.lanewalk_traverse(streams, sc.meta["rope_rows"], *args)
    streams = sc.rope_streams.clone()
    streams[:, 0, 6:8] = float(streams.shape[1])  # the root links past the end
    with pytest.raises(RuntimeError, match="left its stream"):
        t_lanewalk.lanewalk_traverse(streams, sc.meta["rope_rows"], *args)
