"""The port's packet walk against the JAX packet kernel (interpret mode).

On CPU ``packet_traverse_wide`` runs its plain torch version (the CUDA
kernel's twin); the JAX side runs ``_packet8_kernel`` through Pallas'
interpreter.  The walk: hit masks and occlusion masks equal, ``dst``
within the cross-implementation tolerance of tests/test_torch_group.py,
``leaf_map[prim]`` equal off exact-t ties (the port walks each ray in its
own near-first order, the TPU kernel its packet's).  The emit mode: the
same SET of cluster ids per ray and the same overflow flags (the order
is the walk's).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
from ray_tracer_tpu.kernels import packet as j_packet
from ray_tracer_tpu_torch import CompiledScene
from ray_tracer_tpu_torch.kernels import packet as t_packet

from torch_parity import deep_chain, scene_arrays, soup_scene

BIG = 99999999.0
LEAVES = {  # records per slot, compile options
    "leaf4": (4, dict(max_leaf_tris=4)),
    "leaf8": (8, dict(max_leaf_tris=8)),
    "merge16": (16, dict(max_leaf_tris=8, merge_wide_leaves=True)),
}


@pytest.fixture(scope="module", params=list(LEAVES))
def scene(request, tmp_path_factory):
    """Random triangle soup with 4-record, merged 8-record one-row or
    16-record two-row leaf slots, plus cluster tables (t_c 16)."""
    tmp = str(tmp_path_factory.mktemp("soup"))
    recs, kw = LEAVES[request.param]
    jsc = soup_scene(jrt, tmp).compile(cluster_t_c=16, **kw)
    sc = CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")
    assert sc.meta["wide_leaf_recs"] == recs
    assert sc.meta["n_clusters"] > 1
    return sc


def _rays(rand, n):
    o = rand.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::50, 0] = 0.0  # exercise the zero-direction guard
    return o, d


def _jax(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _walk_both(sc, o, d, tmax, anyhit):
    recs = sc.meta["wide_leaf_recs"]
    t_packet.reset_launches()
    got = t_packet.packet_traverse_wide(
        sc.wide_packed, sc.leaf_rows, torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(tmax), recs, anyhit=anyhit,
    )
    assert sum(t_packet.launches.values()) == 0  # CPU: the plain version
    want = j_packet.packet_traverse_wide(
        _jax(sc.wide_packed), _jax(sc.leaf_rows), _jax(o), _jax(d),
        _jax(tmax), 0, interpret=True, packet_size=256, max_recs=recs,
        anyhit=anyhit, need_uv=False,
    )
    return [x.numpy() for x in got], [np.asarray(x) for x in want[:2]]


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive"])
def test_walk_matches_jax(scene, rand, case):
    n = 900  # not a multiple of the packet size
    o, d = _rays(rand, n)
    tmax = np.full(n, BIG, np.float32)
    if case == "clipped":
        tmax = rand.uniform(0.1, 6.0, n).astype(np.float32)
    if case == "inactive":
        tmax[::3] = -BIG
    (dst, prim), (jdst, jprim) = _walk_both(scene, o, d, tmax, False)
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


def test_anyhit_matches_jax(scene, rand):
    n = 1000
    o, d = _rays(rand, n)
    tmax = rand.uniform(0.1, 6.0, n).astype(np.float32)
    tmax[::7] = -BIG
    (dst, prim), (jdst, _) = _walk_both(scene, o, d, tmax, True)
    occ = jdst < -1.0
    assert 0 < occ.sum() < n
    np.testing.assert_array_equal(dst < -1.0, occ)
    np.testing.assert_array_equal(dst[~occ], tmax[~occ])
    assert (prim == -1).all()


@pytest.mark.parametrize("k", [16, 2])
def test_emit_matches_jax(scene, rand, k):
    """Candidate clusters of each ray over the cluster BVH8: equal
    overflow flags, and equal sets where the slots hold them all; K=2
    overflows many lanes."""
    n = 700
    o, d = _rays(rand, n)
    tmax = np.full(n, BIG, np.float32)
    tmax[1::4] = rand.uniform(0.5, 4.0, n)[1::4]
    tmax[::9] = -BIG
    slots, ovf = t_packet.packet_traverse_wide(
        scene.cwide_packed, scene.cwide_packed, torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(tmax), 8, top_k=k,
        emit_leaves=True,
    )
    want = j_packet.packet_traverse_wide(
        _jax(scene.cwide_packed), jnp.full((1, 128), np.nan, jnp.float32),
        _jax(o), _jax(d), _jax(tmax), 0, interpret=True, packet_size=256,
        max_recs=8, top_k=k, emit_leaves=True, need_uv=False,
    )
    jslots, jovf = np.asarray(want[5]), np.asarray(want[6])
    np.testing.assert_array_equal(ovf.numpy() > 0, jovf > 0)
    if k == 2:
        assert 0 < (jovf > 0).sum() < n
    slots = slots.numpy()
    for i in range(n):
        got, want = slots[i][slots[i] >= 0], jslots[i][jslots[i] >= 0]
        if jovf[i]:  # which k of the candidates fill the slots is the
            assert len(got) == len(want) == k  # walk order's choice
        else:
            assert sorted(got) == sorted(want), i
    assert ((slots >= 0).sum(axis=1) >= 2).any()  # several per ray


def test_reconstruct_uvfront_matches_jax(scene, rand):
    n = 500
    o, d = _rays(rand, n)
    (_, prim), _ = _walk_both(scene, o, d, np.full(n, BIG, np.float32),
                              False)
    args = (scene.leaf_rows, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(prim))
    got = t_packet.reconstruct_uvfront(*args)
    want = j_packet._reconstruct_uvfront(*map(_jax, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_wrapper_rejects_treelet_mode_and_bad_inputs(scene):
    n = 8
    args = [scene.wide_packed, scene.leaf_rows, torch.zeros(n, 3),
            torch.ones(n, 3), torch.full((n,), BIG)]
    with pytest.raises(ValueError, match="troot"):  # the TOP mode's table
        t_packet.packet_traverse_wide(*args, 8, top_k=4)
    with pytest.raises(ValueError):
        t_packet.packet_traverse_wide(*args, 12)
    args[4] = args[4].double()
    with pytest.raises(TypeError):
        t_packet.packet_traverse_wide(*args, 8)


def test_merged_two_row_compile_matches_jax(tmp_path):
    """``merge_wide_leaves=True`` compiles (it raised before the packet
    walk was ported) to the JAX package's 16-record tables."""
    kw = dict(max_leaf_tris=8, merge_wide_leaves=True)
    jarr, jmeta = scene_arrays(soup_scene(jrt, str(tmp_path)).compile(**kw))
    import ray_tracer_tpu_torch as trt

    tsc = soup_scene(trt, str(tmp_path)).compile(device="cpu", **kw)
    assert tsc.meta["wide_leaf_recs"] == jmeta["wide_leaf_recs"] == 16
    for f in ("wide_packed", "leaf_rows", "leaf_map", "shade_slot"):
        np.testing.assert_array_equal(getattr(tsc, f).numpy(), jarr[f],
                                      err_msg=f)


@pytest.mark.parametrize("loose", [False, True])
@pytest.mark.parametrize("anyhit", [False, True])
def test_two_row_walk_on_a_deep_chain_matches_jax(rand, anyhit, loose):
    """The two-row (16-record) walk from the root, which the card runs in
    group_walk_kernel<., 2>, against the JAX kernel on a hand-built chain
    of 40 wide levels whose leaf slots hold 1-16 records (a code's count
    capped at 15): the same hits, and a tie-free ``dst``."""
    nodes, rows = (torch.from_numpy(x)
                   for x in deep_chain(40, loose=loose, rows=2))
    n = 600
    o = rand.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, BIG, np.float32)
    if anyhit:
        tmax = rand.uniform(0.01, 0.3, n).astype(np.float32)
    tmax[::9] = -BIG
    stats = {}
    got = t_packet.packet_traverse_wide_reference(
        nodes, rows, *map(torch.from_numpy, (o, d, tmax)), 16, anyhit=anyhit,
        stats=stats)
    assert stats["max_sp"] >= (40 if loose else 2)
    want = j_packet.packet_traverse_wide(
        _jax(nodes), _jax(rows), _jax(o), _jax(d), _jax(tmax), 0,
        interpret=True, packet_size=256, max_recs=16, anyhit=anyhit,
        need_uv=False)
    dst, prim = (x.numpy() for x in got)
    jdst, jprim = (np.asarray(x) for x in want[:2])
    if anyhit:
        occ = jdst < -1.0
        live = tmax > 0
        assert 0 < occ[live].sum() < live.sum()
        np.testing.assert_array_equal(dst < -1.0, occ)
        np.testing.assert_array_equal(dst[~occ], tmax[~occ])
        return
    hit = jprim >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    assert hit.sum() > 300 and (prim % 16 >= 8).any()  # second rows too
    np.testing.assert_allclose(dst, jdst, rtol=1e-5, atol=1e-6)
