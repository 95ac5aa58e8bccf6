"""The port's cluster route against the JAX package's (interpret mode).

Tables: the port's ``accel/cluster.py`` builds the JAX package's arrays,
NaN-equal.  Kernels: on CPU ``cluster_pairs_test`` and ``box_hits`` run
their plain torch versions; the JAX side runs ``_cluster_kernel`` and
``_box_kernel`` through Pallas' interpreter on the same chunks.  Box words
are equal; hit distances agree within rtol 1e-4 (the JAX contraction sums
in another order, and the factorized distance cancels), hits and
in-cluster indices off exact ties.  The port's kernels compute only the
page entries the builder writes, for each page's real triangles or
boxes: on every page here they equal the full contraction they replaced
(``torch_parity.cluster_pairs_full`` / ``box_hits_full``) exactly.  The
whole
route: ``traverse``/``traverse_anyhit`` under ``Routing(cluster="on")``
against the JAX package's on the same route, with the tolerances of
tests/test_cluster.py::test_cluster_sbvh_scene.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.kernels import cluster as j_cluster
from ray_tracer_tpu.ops import cluster_trace as j_trace
from ray_tracer_tpu.ops import traverse as j_traverse
from ray_tracer_tpu_torch import CompiledScene
from ray_tracer_tpu_torch.config import Routing
from ray_tracer_tpu_torch.kernels import cluster as t_cluster
from ray_tracer_tpu_torch.kernels import packet as t_packet
from ray_tracer_tpu_torch.ops import cluster_trace as t_trace
from ray_tracer_tpu_torch.ops import traverse as t_traverse

from torch_parity import (aimed_chunks, box_hits_full, cluster_pairs_full,
                          hand_built_pages, scene_arrays, soup_scene,
                          sponza_builders)

BIG = 99999999.0
CLUSTER_FIELDS = ("clus_mt", "clus_start", "cwide_packed", "super_page",
                  "super_cpage", "super_cstart")
CLUSTER_META = ("n_clusters", "cluster_t_c", "n_supers")


@pytest.fixture(scope="module")
def soup(tmp_path_factory):
    """(JAX scene on device, port scene): 2400-triangle soup cut into
    clusters of 16, enough for several supers."""
    tmp = str(tmp_path_factory.mktemp("soup"))
    jsc = soup_scene(jrt, tmp, n_tris=2400).compile(cluster_t_c=16)
    tsc = CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")
    assert tsc.meta["n_supers"] >= 2 and tsc.meta["n_clusters"] > 128
    return jsc.device_put(), tsc


@pytest.fixture(scope="module")
def sponza(tmp_path_factory):
    """sponza_proxy cut to 8k triangles, clusters of 128 (the default)."""
    tmp = str(tmp_path_factory.mktemp("sponza"))
    mp = pytest.MonkeyPatch()
    try:
        jb, _ = sponza_builders(tmp, mp, 8000)
        jsc = jb.compile(clusters=True)
    finally:
        mp.undo()
    return jsc.device_put(), CompiledScene.from_numpy(*scene_arrays(jsc),
                                                      device="cpu")


def _rays(rand, n, scale=1.0, shift=(0.0, 0.0, 0.0)):
    o = (rand.uniform(-4, 4, (n, 3)) * scale + shift).astype(np.float32)
    d = rand.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::50, 2] = 0.0  # exercise the zero-direction guard
    return o, d


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in xs]


@pytest.mark.parametrize("name", ["soup", "sponza"])
def test_cluster_tables_match_jax(name, tmp_path, monkeypatch):
    if name == "soup":
        jb = soup_scene(jrt, str(tmp_path), n_tris=2400)
        import ray_tracer_tpu_torch as trt

        tb = soup_scene(trt, str(tmp_path), n_tris=2400)
        kw = dict(cluster_t_c=16)
    else:
        jb, tb = sponza_builders(str(tmp_path), monkeypatch, 8000)
        kw = dict(clusters=True)
    jarr, jmeta = scene_arrays(jb.compile(**kw))
    tsc = tb.compile(device="cpu", **kw)
    for f in CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(tsc, f).numpy(), jarr[f],
                                      err_msg=f)  # NaN-equal
    for k in CLUSTER_META:
        assert tsc.meta[k] == jmeta[k], k
    assert tsc.meta["n_clusters"] > 1 and tsc.meta["n_supers"] > 0


def test_default_compile_builds_no_cluster_tables(tmp_path):
    import ray_tracer_tpu_torch as trt

    sc = soup_scene(trt, str(tmp_path)).compile(device="cpu")
    assert sc.meta["n_clusters"] == 0 and sc.meta["n_supers"] == 0
    assert not t_trace.use_cluster(sc, Routing(cluster="on"))
    assert t_traverse.prim_space(sc, Routing(cluster="on")) == "slot"


def test_capacity_error_degrades_unless_forced(tmp_path, monkeypatch):
    import ray_tracer_tpu_torch as trt
    from ray_tracer_tpu_torch.accel import cluster as t_acc

    def refuse(*a, **k):
        raise t_acc.ClusterCapacityError("too many references")

    monkeypatch.setattr(t_acc, "build_cluster_tables", refuse)
    sc = soup_scene(trt, str(tmp_path)).compile(cluster_t_c=16,
                                                device="cpu")
    assert sc.meta["n_clusters"] == 0
    with pytest.raises(t_acc.ClusterCapacityError):
        soup_scene(trt, str(tmp_path)).compile(clusters=True, device="cpu")


def _pairs(sc, rand, n=600, **ray_kw):
    """Grouped (ray, cluster) chunks of random rays through the port's
    packet enumeration: (feats (n,16), chunk feats, chunk cids)."""
    o, d = _t(*_rays(rand, n, **ray_kw))
    tmax = torch.full((n,), BIG)
    feats = t_cluster.ray_features(o, d, tmax)
    slots, ovf = t_packet.packet_traverse_wide(
        sc.cwide_packed, sc.cwide_packed, o, d, tmax, 8, top_k=16,
        emit_leaves=True)
    pc, pr, _ = t_trace._compact_rows(
        slots, torch.arange(n, dtype=torch.int32), ovf == 0, n * 8)
    _, ray_p, live_p, chunk_cid, _ = t_trace._group_pairs(
        pc, pr, sc.meta["n_clusters"] + 2)
    assert (chunk_cid >= 0).sum() > 4 and (chunk_cid < 0).any()
    return feats, t_trace._chunk_feats(feats, ray_p, live_p), chunk_cid


def test_cluster_pairs_test_matches_jax(soup, rand):
    sc = soup[1]
    _, fchunks, cid = _pairs(sc, rand)
    t_c = sc.meta["cluster_t_c"]
    t, p = t_cluster.cluster_pairs_test(sc.clus_mt, fchunks, cid,
                                        sc.clus_count, t_c=t_c)
    jt, jp = j_cluster.cluster_pairs_test(*_j(sc.clus_mt, fchunks, cid),
                                          t_c=t_c, interpret=True)
    t, p, jt, jp = t.numpy(), p.numpy(), np.asarray(jt), np.asarray(jp)
    hit = jp >= 0
    np.testing.assert_array_equal(p >= 0, hit)
    assert hit.sum() > 100
    # t = T/B of the factorized quantities, whose T = o'.n - v0'.n cancels:
    # the contraction's summation order moves t by up to ~5e-5 relative
    np.testing.assert_allclose(t, jt, rtol=1e-4)
    differ = p != jp  # an exact tie between two triangles of the cluster
    assert differ.mean() < 1e-3
    np.testing.assert_array_equal(t[differ], jt[differ])
    assert (t[cid.numpy() < 0] == np.float32(BIG)).all()


def test_box_hits_match_jax(soup, rand):
    """Level 1 (the super page) and level 2 (per-super cluster pages)."""
    sc = soup[1]
    feats, _, _ = _pairs(sc, rand)
    n = feats.shape[0]
    g1 = -(-n // 128)
    f1 = torch.zeros((g1 * 128, 16))
    f1[:n] = feats
    f1 = f1.reshape(g1, 128, 16).transpose(1, 2).contiguous()
    pid1 = torch.zeros(g1, dtype=torch.int32)
    s = sc.meta["n_supers"]
    pid2 = torch.from_numpy(rand.integers(-1, s, g1).astype(np.int32))
    for pages, pid, count in (
            (sc.super_page[None].contiguous(), pid1, sc.super_page_count),
            (sc.super_cpage, pid2, sc.super_cpage_count)):
        words = t_cluster.box_hits(pages, f1, pid, count)
        jwords = j_cluster.box_hits(*_j(pages, f1, pid), interpret=True)
        np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
        assert (words != 0).any()


def test_extract_slots_matches_jax(rand):
    m = 200
    words = rand.integers(-2**31, 2**31, (m, 4)).astype(np.int64)
    words &= rand.integers(-2**31, 2**31, (m, 4))  # sparser
    words[::3, 3] |= -2**31  # bit 31 of the last word: the int32 sign bit
    words[::5] = 0
    words = words.astype(np.int32)
    for k in (2, 8):
        slots, ovf = t_cluster.extract_slots(torch.from_numpy(words), k)
        jslots, jovf = j_cluster.extract_slots(jnp.asarray(words), k)
        np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    one = torch.tensor([[0, 0, 0, -2**31]], dtype=torch.int32)
    assert t_cluster.extract_slots(one, 2)[0].tolist() == [[127, -1]]


def test_ray_features_match_jax(rand):
    o, d = _rays(rand, 64)
    tmax = rand.uniform(0, 5, 64).astype(np.float32)
    got = t_cluster.ray_features(*_t(o, d, tmax))
    want = j_cluster.ray_features(*_j(o, d, tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the compact kernels against the full contraction they replaced


@pytest.fixture(scope="module")
def compiled(soup, sponza, tmp_path_factory):
    """Cluster scenes from both compilers: the JAX package's (converted by
    ``CompiledScene.from_numpy``, which derives the page counts) and the
    port's own (which keeps the cluster tables' counts), each as the soup
    (t_c 16) and the cut ``sponza_proxy`` (t_c 128)."""
    import ray_tracer_tpu_torch as trt
    from ray_tracer_tpu_torch.scene import presets as t_presets

    tmp = str(tmp_path_factory.mktemp("port"))
    return {
        "soup_jax": soup[1],
        "soup_port": soup_scene(trt, tmp, n_tris=2400).compile(
            cluster_t_c=16, device="cpu"),
        "sponza_jax": sponza[1],
        "sponza_port": t_presets.sponza_proxy(n_tris_target=8000).compile(
            clusters=True, device="cpu"),
    }


SCENES = ["soup_jax", "soup_port", "sponza_jax", "sponza_port"]
SPONZA_RAYS = dict(scale=0.1, shift=(0.0, -0.5, -3.0))


def _scene_pairs(compiled, name, rand):
    kw = SPONZA_RAYS if name.startswith("sponza") else {}
    return _pairs(compiled[name], rand, **kw)


def _assert_pairs_equal_full(pages, fchunks, cid, count, t_c):
    t, p = t_cluster.cluster_pairs_test(pages, fchunks, cid, count, t_c)
    ft, fp = cluster_pairs_full(pages, fchunks, cid, t_c)
    assert (t == ft).all()  # the sign of a zero may differ, no value
    assert torch.equal(p, fp)
    return p


@pytest.mark.parametrize("name", SCENES)
def test_page_counts_are_range_lengths(compiled, name):
    """clus_count and the box page counts are the lengths of the clusters'
    triangle ranges and the supers' cluster ranges; a page's columns past
    its count are the NaN padding."""
    sc = compiled[name]
    n_c, n_s = sc.meta["n_clusters"], sc.meta["n_supers"]
    t_c = sc.meta["cluster_t_c"]
    n_refs = sc.tri_packed.shape[0]
    assert torch.equal(sc.clus_count, torch.diff(
        sc.clus_start, append=torch.tensor([n_refs], dtype=torch.int32)))
    assert 1 <= int(sc.clus_count.min()) <= int(sc.clus_count.max()) <= t_c
    assert sc.super_page_count.tolist() == [n_s]
    assert torch.equal(sc.super_cpage_count, torch.diff(
        sc.super_cstart, append=torch.tensor([n_c], dtype=torch.int32)))
    for page, count in ((sc.super_page, n_s),
                        *zip(sc.super_cpage, sc.super_cpage_count.tolist())):
        for k in range(6):  # block k's planes lie on axis row k // 2
            plane = page[k // 2, k * 128:(k + 1) * 128]
            assert torch.isfinite(plane[:count]).all()
            assert torch.isnan(plane[count:]).all()


@pytest.mark.parametrize("name", SCENES)
def test_compact_pairs_equal_full_contraction(compiled, name, rand):
    """The route's chunks (run-padded lanes, dead tail chunks) on every
    cluster page of both compilers."""
    sc = compiled[name]
    _, fchunks, cid = _scene_pairs(compiled, name, rand)
    p = _assert_pairs_equal_full(sc.clus_mt, fchunks, cid, sc.clus_count,
                                 sc.meta["cluster_t_c"])
    assert (p >= 0).sum() > 50


@pytest.mark.parametrize("name", SCENES)
def test_compact_boxes_equal_full_contraction(compiled, name, rand):
    """Level 1 (every ray against the super page) and level 2 (chunks
    against random super pages, dead chunks among them)."""
    sc = compiled[name]
    feats = _scene_pairs(compiled, name, rand)[0]
    n = feats.shape[0]
    g1 = -(-n // 128)
    f1 = torch.zeros((g1 * 128, 16))
    f1[:n] = feats  # the padding lanes of the last chunk stay zero
    f1 = f1.reshape(g1, 128, 16).transpose(1, 2).contiguous()
    pid2 = torch.from_numpy(
        rand.integers(-1, sc.meta["n_supers"], g1).astype(np.int32))
    for pages, pid, count in (
            (sc.super_page[None].contiguous(), torch.zeros_like(pid2),
             sc.super_page_count),
            (sc.super_cpage, pid2, sc.super_cpage_count)):
        words = t_cluster.box_hits(pages, f1, pid, count)
        assert torch.equal(words, box_hits_full(pages, f1, pid))
        assert (words != 0).any()


@pytest.mark.parametrize("t_c", [8, 16, 128])
def test_compact_pairs_on_hand_built_pages(compiled, t_c, rand):
    """Pages of one triangle, of exactly t_c, and between, in chunk
    sequences with runs of one chunk and of several of one cluster, a
    cluster change at every chunk, and dead chunks."""
    tp = compiled["soup_port"].tri_packed.numpy()
    pages, starts, counts = hand_built_pages(tp, t_c)
    cids = [0, 1, 1, 1, 2, -1, 3, 0, 2, 1, -1, -1, 3, 3]
    fchunks = aimed_chunks(tp, starts, counts, cids, rand)
    cid = torch.tensor(cids, dtype=torch.int32)
    p = _assert_pairs_equal_full(pages, fchunks, cid, counts, t_c)
    hit = p >= 0
    for ci in range(4):  # every cluster is hit, the one-triangle one too
        assert hit[cid == ci].any()
    assert int(p.max()) >= min(t_c // 2, 8)


def test_all_dead_chunks(compiled):
    sc = compiled["soup_port"]
    t_c = sc.meta["cluster_t_c"]
    feats = torch.rand((3, 16, 128))
    dead = torch.full((3,), -1, dtype=torch.int32)
    t, p = t_cluster.cluster_pairs_test(sc.clus_mt, feats, dead,
                                        sc.clus_count, t_c)
    assert (t == BIG).all() and (p == -1).all()
    words = t_cluster.box_hits(sc.super_cpage, feats, dead,
                               sc.super_cpage_count)
    assert (words == 0).all()
    assert torch.equal(words, box_hits_full(sc.super_cpage, feats, dead))


def test_box_hits_subnormal_direction_matches_jax(soup, rand):
    """A direction component of 1e-40 passes the zero guard and gives
    1/d = inf: the JAX kernel's 0 * inf terms make every plane NaN, and
    the port's lane sets no bit either, at both levels."""
    sc = soup[1]
    feats = _pairs(sc, rand)[0][:256].clone()
    feats[::3, 3] = 1e-40
    feats[1::5, 4] = -1e-40
    f = feats.reshape(2, 128, 16).transpose(1, 2).contiguous()
    tiny = ((feats[:, 3:6] != 0) & (feats[:, 3:6].abs() < 1e-38)).any(dim=1)
    for pages, pid, count in (
            (sc.super_page[None].contiguous(),
             torch.zeros(2, dtype=torch.int32), sc.super_page_count),
            (sc.super_cpage, torch.tensor([0, 1], dtype=torch.int32),
             sc.super_cpage_count)):
        words = t_cluster.box_hits(pages, f, pid, count)
        jwords = j_cluster.box_hits(*_j(pages, f, pid), interpret=True)
        np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
        assert torch.equal(words, box_hits_full(pages, f, pid))
        lane_words = words.transpose(1, 2).reshape(256, 4)
        assert (lane_words[tiny] == 0).all()
    assert (lane_words[~tiny] != 0).any()


def test_route_raises_on_a_count_of_the_wrong_length(compiled, rand):
    sc = compiled["soup_port"]
    o, d = _t(*_rays(rand, 64))
    tmax = torch.full((64,), BIG)
    boxes = Routing(cluster="on", cluster_enum="boxes")
    for field, routing in (("clus_count", Routing(cluster="on")),
                           ("super_page_count", boxes),
                           ("super_cpage_count", boxes)):
        count = getattr(sc, field)
        bad = dataclasses.replace(
            sc, **{field: torch.cat([count, count[:1]])})
        with pytest.raises(ValueError, match="counts must have shape"):
            t_trace.cluster_traverse(bad, o, d, tmax, routing)
    with pytest.raises(TypeError, match="counts must be"):
        t_cluster.cluster_pairs_test(
            sc.clus_mt, torch.zeros((1, 16, 128)),
            torch.zeros(1, dtype=torch.int32), sc.clus_count.long(),
            sc.meta["cluster_t_c"])


ROUTES = {
    "packet_enum": dict(),
    "boxes_enum": dict(cluster_enum="boxes"),
    "k2_overflow": dict(cluster_k=2),
}


def _compare_traverse(jsc, tsc, o, d, kw):
    n = o.shape[0]
    jrt_ = JRouting(packet="interpret", cluster="on", **kw)
    trt_ = Routing(cluster="on", **kw)
    active = np.ones(n, bool)
    active[::11] = False
    want = j_traverse.traverse(jsc, *_j(o, d, active), routing=jrt_)
    got = t_traverse.traverse(tsc, *_t(o, d, active), routing=trt_)
    hit = np.asarray(want.did_hit)
    np.testing.assert_array_equal(got.did_hit.numpy(), hit)
    assert hit.sum() > 50
    np.testing.assert_allclose(got.dst.numpy()[hit],
                               np.asarray(want.dst)[hit],
                               rtol=2e-4, atol=1e-5)
    pg, pw = got.prim.numpy()[hit], np.asarray(want.prim)[hit]
    tp = tsc.tri_packed.numpy()
    mm = pg != pw
    assert np.isclose(tp[pg[mm]][:, :12], tp[pw[mm]][:, :12]).all(), \
        "prim differs beyond duplicated geometry"
    tmax = np.full(n, 3.0, np.float32)
    occ = j_traverse.traverse_anyhit(jsc, *_j(o, d, active, tmax),
                                     routing=jrt_)
    tocc = t_traverse.traverse_anyhit(tsc, *_t(o, d, active, tmax),
                                      routing=trt_)
    np.testing.assert_array_equal(tocc.numpy(), np.asarray(occ))


@pytest.mark.parametrize("route", list(ROUTES))
def test_traverse_matches_jax_soup(soup, rand, route):
    o, d = _rays(rand, 500)
    _compare_traverse(*soup, o, d, ROUTES[route])


def test_traverse_sliced_matches_jax(soup, rand, monkeypatch):
    """More rays than SLICE: the slice loop (the last slice padded)."""
    monkeypatch.setattr(t_trace, "SLICE", 256)
    monkeypatch.setattr(j_trace, "SLICE", 256)
    o, d = _rays(rand, 700)
    _compare_traverse(*soup, o, d, dict(cluster_k=4))


@pytest.mark.parametrize("route", list(ROUTES))
def test_traverse_matches_jax_sponza(sponza, rand, route):
    """SBVH scene: spatial splits duplicate references, so prim may pick
    another duplicate of the same geometry."""
    o, d = _rays(rand, 768, scale=0.1, shift=(0.0, -0.5, -3.0))
    _compare_traverse(*sponza, o, d, ROUTES[route])


def test_prim_space(soup):
    tsc = soup[1]
    assert t_traverse.prim_space(tsc, Routing(cluster="on")) == "tri"
    for rt in (Routing(), Routing(cluster="auto"), Routing(cluster="off"),
               Routing(groups=0)):
        assert t_traverse.prim_space(tsc, rt) == "slot"
    assert j_traverse.prim_space(
        soup[0], JRouting(packet="interpret", cluster="on")) == "tri"


def test_uvfront_global_matches_jax(soup, rand):
    tsc = soup[1]
    o, d = _rays(rand, 300)
    got = t_traverse.traverse(tsc, *_t(o, d, np.ones(300, bool)),
                              routing=Routing(cluster="on"))
    prim = torch.where(got.kind == 2, got.prim, -1)
    uv = t_trace._uvfront_global(tsc.tri_packed, *_t(o, d), prim)
    juv = j_trace._uvfront_global(*_j(tsc.tri_packed, o, d, prim))
    for g, w in zip(uv, juv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("bad", [dict(cluster="maybe"),
                                 dict(cluster_enum="tree"),
                                 dict(cluster_k=0), dict(groups=-1)])
def test_routing_rejects_unknown_values(bad):
    with pytest.raises(ValueError):
        Routing(**bad)
