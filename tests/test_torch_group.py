"""The port's BVH8 traversal against the JAX group kernel (interpret mode).

On CPU ``group_traverse`` runs its plain torch version (the CUDA kernel's
twin); the JAX side runs ``_group_kernel`` itself through Pallas'
interpreter.  Hit masks and occlusion masks must be equal, ``dst`` agree
to the cross-implementation tolerance of tests/test_group.py, and
``leaf_map[prim]`` agree except on exact-t ties between duplicated
geometry, where the two child orders may report the other duplicate.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
from ray_tracer_tpu.kernels import group as j_group
from ray_tracer_tpu_torch import CompiledScene
from ray_tracer_tpu_torch.kernels import group as t_group

from torch_parity import room_scene, scene_arrays, soup_scene

BIG = 99999999.0


@pytest.fixture(scope="module", params=[4, 8], ids=["leaf4", "leaf8"])
def scene(request, tmp_path_factory):
    """Random triangle soup, 4-record leaves or merged 8-record rows."""
    tmp = str(tmp_path_factory.mktemp("soup"))
    jsc = soup_scene(jrt, tmp).compile(max_leaf_tris=request.param)
    return CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")


def _rays(rand, n):
    o = rand.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::50, 0] = 0.0  # exercise the zero-direction guard
    return o, d


def _traverse_both(sc, o, d, tmax, anyhit):
    t_group.reset_launches()
    got = t_group.group_traverse(
        sc.wide_packed, sc.leaf_rows, torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(tmax), anyhit=anyhit,
    )
    assert t_group.launches == {"group_traverse": 0, "group_anyhit": 0}
    want = j_group.group_traverse(
        jnp.asarray(sc.wide_packed.numpy()), jnp.asarray(sc.leaf_rows.numpy()),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), 0,
        interpret=True, packet_size=512, groups=4,
        max_recs=sc.meta["wide_leaf_recs"], anyhit=anyhit,
    )
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive"])
def test_closest_hit_matches_jax(scene, rand, case):
    n = 900  # not a multiple of any packet or block size
    o, d = _rays(rand, n)
    tmax = np.full(n, BIG, np.float32)
    if case == "clipped":
        tmax = rand.uniform(0.1, 6.0, n).astype(np.float32)
    if case == "inactive":
        tmax[::3] = -BIG
    (dst, prim), (jdst, jprim) = _traverse_both(scene, o, d, tmax, False)
    hit = jprim >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    assert hit.sum() > 50
    np.testing.assert_allclose(dst, jdst, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(dst[~hit], tmax[~hit])
    leaf_map = scene.leaf_map.numpy()
    tri, jtri = leaf_map[prim[hit]], leaf_map[jprim[hit]]
    differ = tri != jtri
    np.testing.assert_array_equal(dst[hit][differ], jdst[hit][differ])
    assert differ.mean() < 1e-3


def test_occlusion_matches_jax(scene, rand):
    n = 1000
    o, d = _rays(rand, n)
    tmax = rand.uniform(0.1, 6.0, n).astype(np.float32)
    tmax[::7] = -BIG
    (dst, prim), (jdst, _) = _traverse_both(scene, o, d, tmax, True)
    occ = jdst < -1.0
    assert 0 < occ.sum() < n
    np.testing.assert_array_equal(dst < -1.0, occ)
    np.testing.assert_array_equal(dst[~occ], tmax[~occ])
    np.testing.assert_array_equal(dst[occ], np.float32(-BIG))
    assert (prim == -1).all()


def test_room_scene_rays(rand, tmp_path):
    """Axis-aligned walls and boxes: exact slab ties on flat geometry."""
    jsc = room_scene(jrt, str(tmp_path)).compile()
    sc = CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")
    n = 700
    o = rand.uniform(-1.0, 0.4, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d[::4] = [0.0, 1.0, 0.0]  # straight down onto the floor grid
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, BIG, np.float32)
    (dst, prim), (jdst, jprim) = _traverse_both(sc, o, d, tmax, False)
    np.testing.assert_array_equal(prim >= 0, jprim >= 0)
    np.testing.assert_allclose(dst, jdst, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device"])
def test_wrapper_rejects_bad_inputs(scene, bad):
    n = 16
    args = dict(
        nodes=scene.wide_packed, leaf_rows=scene.leaf_rows,
        origin=torch.zeros(n, 3), direction=torch.ones(n, 3),
        tmax0=torch.full((n,), BIG),
    )
    if bad == "dtype":
        args["tmax0"] = args["tmax0"].double()
    elif bad == "shape":
        args["direction"] = torch.ones(n, 4)
    elif bad == "contiguous":
        args["origin"] = torch.zeros(3, n).t()
    else:
        args["origin"] = args["origin"].to("meta")
    with pytest.raises((TypeError, ValueError)):
        t_group.group_traverse(**args)
