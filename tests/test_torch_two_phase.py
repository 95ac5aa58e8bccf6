"""Two-phase treelet traversal of the port against the JAX package's.

The scene is a 2000-triangle soup (131 wide nodes, 8 treelets at
``max_leaf_tris=4``); the 400-triangle soup has no treelets.  On CPU the
TOP and DEEP modes of ``packet_traverse_wide`` run their plain torch
version (the CUDA kernel's twin); the JAX side runs ``_packet8_kernel``
through Pallas' interpreter at a packet of 512 lanes.  Tolerances are the
other parity tests': hit and occlusion masks equal, ``dst`` within
``rtol=1e-5, atol=1e-6`` (XLA contracts multiply-adds into FMAs, the port
does not), ``prim`` equal up to exact-t ties (each walks in its own
order).  Against the port's own one-phase walk the route's ``dst`` is
exact: both take the minimum over the same records, rounded alike.

The kernel tests compile the soup without spatial splits.  An SBVH leaf
holds triangles clipped to its box, and the TPU kernel tests every lane of
a packet against every leaf the packet visits: a lane that walks a few
subtrees can then take a hit, found through a packet mate's leaf, whose
point lies outside those subtrees.  Without spatial splits every hit lies
inside its leaf's box, so the port's per-ray walk finds it too.  The route
is exact either way (every hit point lies in a leaf that the top walk or
an entered treelet reaches), and its tests use the SBVH soup.

The TOP walk emits a treelet root when the ray enters its box within the
best hit found so far, and that best shrinks along the walk, so two visit
orders may emit different far roots.  The roots whose entry distance lies
below the ray's final closest hit are emitted by every order: those sets
must agree.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ray_tracer_tpu as jrt
from ray_tracer_tpu.config import Routing as JRouting
from ray_tracer_tpu.kernels import packet as j_packet
from ray_tracer_tpu.ops import traverse as j_traverse
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch import CompiledScene, Routing
from ray_tracer_tpu_torch.kernels import bvh8 as t_bvh8
from ray_tracer_tpu_torch.kernels import packet as t_packet
from ray_tracer_tpu_torch.ops import traverse as t_traverse
from ray_tracer_tpu_torch.scene import builder as t_builder

from torch_parity import (
    assert_images_match,
    assert_tri_ties,
    deep_chain,
    deep_in_order,
    nearest_first,
    route_rays,
    route_tmax,
    scene_arrays,
    soup_scene,
    sponza_builders,
)

BIG = 99999999.0
TOL = dict(rtol=1e-5, atol=1e-6)
P = 512  # the JAX kernels' packet in these tests
E = 16  # entries per DEEP packet
N_TRIS = 2000


def _soup(tmp_path_factory, **kw):
    """(JAX scene on the device, the port's scene of the same arrays)."""
    tmp = str(tmp_path_factory.mktemp("soup"))
    jsc = soup_scene(jrt, tmp, n_tris=N_TRIS).compile(max_leaf_tris=4, **kw)
    sc = CompiledScene.from_numpy(*scene_arrays(jsc), device="cpu")
    assert sc.meta["n_treelets"] >= 4
    return jsc.device_put(), sc


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The 2000-triangle SBVH soup."""
    return _soup(tmp_path_factory)


@pytest.fixture(scope="module")
def kscenes(tmp_path_factory):
    """The same soup without spatial splits, for the kernel tests."""
    return _soup(tmp_path_factory, spatial_splits=False)


def _jax(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _tris(sc, prim):
    """Global triangle ids of padded leaf-slot ids (-1 stays -1)."""
    leaf_map = sc.leaf_map.numpy()
    return np.where(prim >= 0, leaf_map[np.maximum(prim, 0)], -1)


def _rays(seed, n, case):
    rand = np.random.default_rng(seed)
    o, d = route_rays(rand, "soup", n)
    return o, d, route_tmax(rand, case, n)


def _kernel_args(sc, o, d, tmax):
    return (sc.wide_packed, sc.leaf_rows, torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(tmax),
            sc.meta["wide_leaf_recs"])


def _jax_kernel(sc, o, d, tmax, **kw):
    return j_packet.packet_traverse_wide(
        _jax(sc.wide_packed), _jax(sc.leaf_rows), _jax(o), _jax(d),
        _jax(tmax), 0, interpret=True, packet_size=P,
        max_recs=sc.meta["wide_leaf_recs"], need_uv=False, **kw)


def _assert_closest(sc, o, d, tmax, got, want):
    (dst, prim), (jdst, jprim) = got, want
    hit = jprim >= 0
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(dst, jdst, **TOL)
    np.testing.assert_array_equal(dst[~hit], tmax[~hit])
    assert_tri_ties(sc, o, d, _tris(sc, prim), _tris(sc, jprim), hit)
    return hit


# ---- the tables


@pytest.mark.parametrize("name", ["soup_leaf4", "soup_leaf8",
                                  "sponza_proxy"])
def test_treelet_tables_match_jax(name, tmp_path, monkeypatch):
    tmp = str(tmp_path)
    if name == "sponza_proxy":
        jb, tb = sponza_builders(tmp, monkeypatch, 8000)
        kw = {}
    else:
        jb = soup_scene(jrt, tmp, n_tris=N_TRIS)
        tb = soup_scene(trt, tmp, n_tris=N_TRIS)
        kw = dict(max_leaf_tris=4 if name == "soup_leaf4" else 8)
    jarr, jmeta = scene_arrays(jb.compile(**kw))
    sc = tb.compile(device="cpu", **kw)
    np.testing.assert_array_equal(sc.wide_troot.numpy(), jarr["wide_troot"])
    assert sc.wide_troot.dtype == torch.int32
    for key in ("treelet_size", "n_treelets"):
        assert sc.meta[key] == jmeta[key], key
    assert sc.meta["n_treelets"] > 0
    assert sc.meta["n_treelets"] == int(sc.wide_troot.sum())
    kept = CompiledScene.from_numpy(jarr, jmeta, device="cpu").to("cpu")
    np.testing.assert_array_equal(kept.wide_troot.numpy(), jarr["wide_troot"])
    assert kept.meta["n_treelets"] == jmeta["n_treelets"]


def test_treelet_roots_of_a_small_tree(tmp_path):
    """A tree of at most TREELET_SIZE wide nodes has no treelet root (the
    root has no parent); the mesh-free scene keeps a one-entry table."""
    sc = soup_scene(trt, str(tmp_path), n_tris=40).compile(device="cpu")
    assert sc.wide_packed.shape[0] <= t_builder.TREELET_SIZE
    assert sc.meta["n_treelets"] == 0 and not sc.wide_troot.any()
    b = trt.SceneBuilder()
    b.add_material(trt.Material())
    b.add_sphere((0.0, 0.0, 0.0), 1.0, 0)
    empty = b.compile(device="cpu")
    assert empty.wide_troot.tolist() == [0]
    assert empty.meta["n_treelets"] == 0


# ---- the TOP table (scene/builder.py::top_table) and the TOP walk over it


def _top_direct(wp, troot):
    """The TOP table derived node by node, apart from builder.top_table: a
    depth-first walk from the root that does not enter treelet roots; the
    rows in node order, each child's code rewritten by its class."""
    ids, todo = [], [0]
    while todo:
        node = todo.pop()
        ids.append(node)
        for c in range(8):
            code = wp[node, 8 * c + 6]
            if code > 0 and troot[int(code)] == 0:
                todo.append(int(code))
    ids = sorted(ids)
    row = {node: i for i, node in enumerate(ids)}
    t = len(ids)
    table = wp[ids, :64].copy()
    for i, node in enumerate(ids):
        for c in range(8):
            code = wp[node, 8 * c + 6]
            if code > 0:
                table[i, 8 * c + 6] = (row[int(code)] if troot[int(code)] == 0
                                       else t + int(code))
    return table, ids


def _compiled(name, tmp, monkeypatch):
    """The port's scene ``name``, compiled for the CPU."""
    if name == "mesh_free":
        b = trt.SceneBuilder()
        b.add_material(trt.Material())
        b.add_sphere((0.0, 0.0, 0.0), 1.0, 0)
        return b.compile(device="cpu")
    if name == "sponza_proxy":
        return sponza_builders(tmp, monkeypatch, 8000)[1].compile(
            device="cpu")
    kw = dict(max_leaf_tris=4 if name == "soup_leaf4" else 8)
    if name == "soup_merged":
        kw.update(merge_wide_leaves=True)
    return soup_scene(trt, tmp, n_tris=N_TRIS).compile(device="cpu", **kw)


@pytest.mark.parametrize("name", ["soup_leaf4", "soup_leaf8", "soup_merged",
                                  "sponza_proxy", "mesh_free"])
def test_top_table_from_the_tree(name, tmp_path, monkeypatch):
    """The compiled TOP table equals a node-by-node derivation from
    wide_packed and wide_troot: its rows are the nodes with more than
    TREELET_SIZE wide nodes in their subtree (the root alone where there
    are no treelets), root first; each treelet root is one code T + id;
    boxes, leaf and empty codes and the sort axis are the rows' own bits."""
    sc = _compiled(name, str(tmp_path), monkeypatch)
    wp, troot = sc.wide_packed.numpy(), sc.wide_troot.numpy()
    top = sc.wide_top.numpy()
    assert top.dtype == np.float32 and top.flags.c_contiguous
    want, ids = _top_direct(wp, troot)
    t = len(ids)
    assert top.shape == (t, 64) and ids[0] == 0
    np.testing.assert_array_equal(top, want)  # NaN-equal
    keep = np.ones(64, bool)
    keep[6::8] = False  # every float but the codes, bit for bit
    np.testing.assert_array_equal(top[:, keep].view(np.int32),
                                  wp[ids, :64][:, keep].view(np.int32))
    codes, old = top[:, 6::8], wp[ids, 6:64:8]
    assert np.array_equal(codes[old <= 0], old[old <= 0])
    roots = codes >= t
    assert roots.sum() == sc.meta["n_treelets"] == troot.sum()
    assert (troot[(codes[roots] - t).astype(np.int64)] == 1).all()
    inner = (old > 0) & ~roots
    assert np.array_equal(np.array(ids)[codes[inner].astype(np.int64)],
                          old[inner].astype(np.int64))
    if sc.meta["n_treelets"]:
        # the top level: the nodes whose subtree is not small
        @functools.lru_cache(maxsize=None)
        def size(w):
            kids = wp[w, 6:64:8]
            return 1 + sum(size(int(c)) for c in kids[kids > 0])

        assert ids == [w for w in range(len(wp))
                       if size(w) > t_builder.TREELET_SIZE]
    else:
        assert t == len(wp)


@pytest.mark.parametrize("name", ["soup_leaf4", "soup_leaf8",
                                  "sponza_proxy"])
def test_top_table_of_both_compilers(name, tmp_path, monkeypatch):
    """The port's compile() and from_numpy() of the JAX package's compiled
    scene (which has no TOP table: from_numpy derives it) give the same
    table, the one builder.top_table derives from those arrays."""
    tmp = str(tmp_path)
    if name == "sponza_proxy":
        jb, tb = sponza_builders(tmp, monkeypatch, 8000)
        kw = {}
    else:
        jb = soup_scene(jrt, tmp, n_tris=N_TRIS)
        tb = soup_scene(trt, tmp, n_tris=N_TRIS)
        kw = dict(max_leaf_tris=4 if name == "soup_leaf4" else 8)
    jarr, jmeta = scene_arrays(jb.compile(**kw))
    assert "wide_top" not in jarr
    sc = tb.compile(device="cpu", **kw)
    kept = CompiledScene.from_numpy(jarr, jmeta, device="cpu")
    direct = t_builder.top_table(jarr["wide_packed"], jarr["wide_troot"])
    t = kept.wide_top.shape[0]
    assert int((kept.wide_top[:, 6::8] >= t).sum()) == jmeta["n_treelets"] > 0
    for table in (sc.wide_top, kept.wide_top):
        np.testing.assert_array_equal(table.numpy(), direct)


def _top_case(case, kscenes, merged_soup):
    """(nodes, troot, TOP table, leaf_rows, rows, origin, direction, tmax)
    of a TOP walk case, 1500 rays, every fifth at -BIG: the soup (its top
    level is the root, whose children are treelet roots: emission), a
    chain with one- or two-row slots whose top level holds TOP_STACK nodes
    with leaves and one treelet root below (leaf tests and the deepest
    stack), and the merged soup, which has no treelets (the TOP walk is
    the whole walk)."""
    if case in ("chain", "chain2"):
        rows = 2 if case == "chain2" else 1
        nodes, leaf_rows = deep_chain(t_bvh8.TOP_STACK + 64, rows=rows)
        troot = t_builder.treelet_roots(nodes)
        top = t_builder.top_table(nodes, troot)
        rand = np.random.default_rng(27)
        o = rand.uniform(-0.1, 0.1, (1500, 3)).astype(np.float32)
        d = rand.normal(size=(1500, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.where(rand.uniform(size=1500) < 0.5, BIG,
                        rand.uniform(0.5, 4.0, 1500)).astype(np.float32)
        tables = [torch.from_numpy(x) for x in (nodes, troot, top,
                                                 leaf_rows)]
    else:
        sc = merged_soup if case == "merged" else kscenes[1]
        rows = 2 if case == "merged" else 1
        o, d, tmax = _rays(24, 1500, "clipped")
        tables = [sc.wide_packed, sc.wide_troot, sc.wide_top, sc.leaf_rows]
    tmax[::5] = -BIG
    return (*tables, rows, *(torch.from_numpy(x) for x in (o, d, tmax)))


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("case", ["soup", "chain", "chain2", "merged"])
@pytest.mark.parametrize("anyhit", [False, True])
def test_top_twin_matches_walk_reference(kscenes, merged_soup, k, case,
                                         anyhit):
    """top_walk_kernel's twin over the TOP table equals walk_reference's TOP
    mode over the (W,128) rows and troot with torch.equal on dst, prim,
    slots and ovf, and so does the wrapper's CPU path given the table:
    closest hit and occlusion, one- and two-row slots, with lanes that
    overflow their slots and -BIG lanes."""
    nodes, troot, top, leaf_rows, rows, o, d, tmax = _top_case(
        case, kscenes, merged_soup)
    args = (nodes, leaf_rows, o, d, tmax)
    mode = "anyhit" if anyhit else "closest"
    want = t_bvh8.walk_reference(*args, mode=mode, rows=rows, top_k=k,
                                 troot=troot)
    stats = {}
    twin = t_bvh8.top_walk_reference(top, *args[1:], anyhit, rows, k,
                                     stats=stats)
    t_packet.reset_launches()
    cpu = t_packet.packet_traverse_wide(*args, 8 * rows, anyhit=anyhit,
                                        top_k=k, troot=troot, wide_top=top)
    assert sum(t_packet.launches.values()) == 0  # CPU: the plain version
    for a, b, c in zip(twin, want, cpu):
        assert torch.equal(a, b) and torch.equal(c, b)
    dst, prim, slots, ovf = want
    assert (dst[::5] == -BIG).all() and (prim[::5] == -1).all()
    assert stats["node_seen"].shape == (top.shape[0],)
    assert 1 <= stats["max_sp"] <= t_bvh8.TOP_STACK
    n_roots = int(troot.sum())
    if case != "merged":
        # occlusion rays in the chain stop at a leaf above its treelet root
        if case == "soup" or not anyhit:
            assert (slots >= 0).sum() > 100
        assert (ovf > 0).any() == (k < n_roots and case == "soup")
    else:
        assert n_roots == 0 and top.shape[0] == nodes.shape[0]
        assert (slots < 0).all() and (ovf == 0).all()
    if case != "soup":  # the soup's top level has no leaves
        if anyhit:
            assert int((dst[tmax > -BIG] < -1.0).sum()) > 100
        else:
            assert (prim >= 0).sum() > 100
    if case.startswith("chain") and not anyhit:
        assert stats["max_sp"] >= 20


def test_route_passes_the_top_table(scenes, monkeypatch):
    """The two-phase route hands its TOP walk the scene's TOP table."""
    _, sc = scenes
    o, d, tmax = (torch.from_numpy(x) for x in _rays(25, 200, "clipped"))
    tables = []
    walk = t_packet.packet_traverse_wide

    def record(*args, **kw):
        if kw.get("troot") is not None:
            tables.append(kw.get("wide_top"))
        return walk(*args, **kw)

    monkeypatch.setattr(t_packet, "packet_traverse_wide", record)
    act = torch.ones(200, dtype=torch.bool)
    t_traverse.traverse(sc, o, d, act, routing=Routing(two_phase=True))
    t_traverse.traverse_anyhit(sc, o, d, act, tmax,
                               routing=Routing(two_phase=True))
    assert len(tables) == 2 and all(t is sc.wide_top for t in tables)


def test_wrapper_rejects_bad_top_tables(kscenes):
    """The TOP table's checks, which run before any launch: a CUDA call
    without it raises naming compile() (the validation path, called here
    for a CUDA device); a table of the wrong shape, type, layout or
    device, an empty one, or one given without troot raises on the CPU
    path too."""
    _, sc = kscenes
    n = 300
    args = _kernel_args(sc, *_rays(26, n, "closest"))
    top, troot = sc.wide_top, sc.wide_troot
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match=r"compile\(\)"):
        t_bvh8.check_top_table(None, sc.wide_packed, cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        t_bvh8.check_top_table(top, sc.wide_packed, cuda)
    bad = {
        "shape": torch.zeros((top.shape[0], 128)),
        "limits": top[:0],
        "contiguous": torch.zeros((64, 3)).T,
    }
    for match, table in bad.items():
        with pytest.raises(ValueError, match=match):
            t_packet.packet_traverse_wide(*args, top_k=4, troot=troot,
                                          wide_top=table)
    with pytest.raises(TypeError):
        t_packet.packet_traverse_wide(*args, top_k=4, troot=troot,
                                      wide_top=top.double())
    with pytest.raises(ValueError, match="needs troot"):
        t_packet.packet_traverse_wide(*args, wide_top=top)
    with pytest.raises(ValueError, match="empty TOP table"):
        t_bvh8.top_walk_reference(top[:0], *args[1:5], False, 1, 4)


def test_top_table_limits(monkeypatch):
    """The compile-time checks of the TOP table: a top level deeper than
    the TOP walk's stack (a chain whose nodes each hold more than
    TREELET_SIZE nodes below them) and codes T + W at the f32 limit raise
    in top_table; compile() stores an empty table for such a scene
    (top_table_or_empty), on which the TOP walk's wrapper raises."""
    depth = t_bvh8.TOP_STACK + t_builder.TREELET_SIZE
    for extra, fits in ((0, True), (1, False)):
        nodes, _ = deep_chain(depth + extra)
        troot = t_builder.treelet_roots(nodes)
        assert troot.sum() == 1
        if fits:
            top = t_builder.top_table(nodes, troot)
            assert top.shape == (t_bvh8.TOP_STACK, 64)
            w, t = nodes.shape[0], top.shape[0]
        else:
            with pytest.raises(ValueError, match="levels"):
                t_builder.top_table(nodes, troot)
            assert t_builder.top_table_or_empty(nodes, troot).shape == (0, 64)
    small, _ = deep_chain(t_bvh8.TOP_STACK + 1)  # no treelets, too deep
    with pytest.raises(ValueError, match="levels"):
        t_builder.top_table(small, t_builder.treelet_roots(small))
    nodes, _ = deep_chain(depth)
    troot = t_builder.treelet_roots(nodes)
    monkeypatch.setattr(t_builder, "TOP_CODE_LIMIT", w + t)
    with pytest.raises(ValueError, match="2\\^24"):
        t_builder.top_table(nodes, troot)
    monkeypatch.setattr(t_builder, "TOP_CODE_LIMIT", w + t + 1)
    assert t_builder.top_table(nodes, troot).shape == (t, 64)
    monkeypatch.setattr(t_bvh8, "TOP_CODE_LIMIT", w + t)
    with pytest.raises(ValueError, match="2\\^24"):
        t_bvh8.check_top_table(torch.from_numpy(top), torch.from_numpy(
            nodes), torch.device("cpu"))


# ---- the DEEP walk: the list order, the padding lanes, and the entry-box
# cull and nearest-first order of tools/deep_walk_variants.cu


def _deep_tools():
    sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import deep_walk_variants

    return deep_walk_variants


@pytest.mark.parametrize("name", ["soup_leaf4", "soup_leaf8",
                                  "sponza_proxy", "mesh_free"])
def test_entry_box_table(name, tmp_path, monkeypatch):
    """Row w of the variants' entry-box table is node w's child box in its
    parent's row with flag 1, the root's a NaN box with flag 0; each
    node's children lie inside its own box (the cull's premise)."""
    if name == "mesh_free":
        b = trt.SceneBuilder()
        b.add_material(trt.Material())
        b.add_sphere((0.0, 0.0, 0.0), 1.0, 0)
        sc = b.compile(device="cpu")
    elif name == "sponza_proxy":
        sc = sponza_builders(str(tmp_path), monkeypatch, 8000)[1].compile(
            device="cpu")
    else:
        sc = soup_scene(trt, str(tmp_path), n_tris=N_TRIS).compile(
            device="cpu", max_leaf_tris=4 if name == "soup_leaf4" else 8)
    wp = sc.wide_packed.numpy()
    table = _deep_tools().entry_boxes(wp)
    w = wp.shape[0]
    assert table.shape == (w, 8) and table.dtype == np.float32
    boxes = wp[:, :64].reshape(w, 8, 8)
    want = np.full((w, 8), np.nan, np.float32)
    want[:, 6:] = 0.0
    for parent in range(w):
        for c in range(8):
            code = boxes[parent, c, 6]
            if np.isfinite(boxes[parent, c, 0]) and code > 0:
                assert want[int(code), 6] == 0.0  # one parent each
                want[int(code), :6] = boxes[parent, c, :6]
                want[int(code), 6] = 1.0
    np.testing.assert_array_equal(table, want)  # NaN-equal
    assert table[0, 6] == 0.0 and np.isnan(table[0, :6]).all()
    assert table[:, 6].sum() == w - 1  # every other node has a parent
    node, c = np.nonzero(np.isfinite(boxes[:, :, 0])
                         & (table[:, 6] == 1.0)[:, None])
    child = boxes[node, c, :6]
    assert (child[:, :3] >= table[node, :3]).all()
    assert (child[:, 3:] <= table[node, 3:6]).all()
    assert (w == 1) == (name == "mesh_free")


def _deep_lists(sc, rand, g, root_every=2):
    """(g, E) entry lists of random wide nodes (nested ones too) at random
    positions, -1 elsewhere; the root in every ``root_every``-th list."""
    w = sc.wide_packed.shape[0]
    ent = np.full((g, E), -1, np.int32)
    for row in range(g):
        k = rand.integers(1, E)
        pick = rand.permutation(np.arange(1, w))[:k]
        if row % root_every == 0:
            pick[0] = 0
        ent[row, rand.permutation(E)[:len(pick)]] = pick
    return ent


@pytest.fixture(scope="module")
def merged_soup(tmp_path_factory):
    """The soup with 16-record two-row leaf slots, without spatial splits
    as the kernel tests' soup."""
    tmp = str(tmp_path_factory.mktemp("merged"))
    sc = soup_scene(trt, tmp, n_tris=N_TRIS).compile(
        device="cpu", max_leaf_tris=8, merge_wide_leaves=True,
        spatial_splits=False)
    assert sc.meta["wide_leaf_recs"] == 16
    return sc


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive",
                                  "anyhit", "two_rows", "subnormal"])
def test_deep_cull_is_exact(kscenes, merged_soup, case):
    """The DEEP walk (the twin of deep_walk_kernel) against a chain of
    single-entry walks, every entry untested, the last listed first (the
    DEEP walk before its redesign), bit for bit; so is that chain with the
    entry-box cull of tools/deep_walk_variants.cu; nearest first (the
    variants' other order) hit masks are equal, ``dst`` within the parity tolerance and
    ``prim`` up to exact-t ties (without spatial splits every hit lies
    inside its leaf's box, so the order changes no more).  Entry lists of
    random nodes, the root in half of them; "subnormal": direction
    components of 1e-40 (1/d = inf past the zero guard) and of 1.5e-38
    from origins 60 away (o/d overflows), where every box test fails."""
    sc = merged_soup if case == "two_rows" else kscenes[1]
    rand = np.random.default_rng(21)
    p = 256
    n = 4 * p
    o, d, tmax = _rays(22, n, {"anyhit": "clipped", "two_rows": "clipped",
                               "subnormal": "closest"}.get(case, case))
    if case == "subnormal":
        d[0::4, 0] = 1e-40
        d[1::4, 1] = -1e-40
        d[2::8, 2] = 1.5e-38
        o[2::8] = o[2::8] + np.float32(60.0) * np.sign(o[2::8])
        assert (1.0 / d[0::4, 0] == np.inf).all()
    if case == "clipped":
        tmax[::7] = -BIG
    ent = torch.from_numpy(_deep_lists(sc, rand, n // p))
    anyhit = case == "anyhit"
    args = _kernel_args(sc, o, d, tmax)
    box = torch.from_numpy(_deep_tools().entry_boxes(sc.wide_packed.numpy()))
    t_packet.reset_launches()
    twin = t_packet.packet_traverse_wide(*args, anyhit=anyhit, deep_e=E,
                                         entries=ent, packet_size=p)
    assert sum(t_packet.launches.values()) == 0  # CPU: the plain version
    untested = deep_in_order(*args[:5], ent, p, args[5], anyhit=anyhit)
    stats = {}
    culled = deep_in_order(*args[:5], ent, p, args[5], anyhit=anyhit,
                           entry_box=box, stats=stats)
    near = deep_in_order(*args[:5], ent, p, args[5], anyhit=anyhit,
                         entry_box=box, order=nearest_first(
                             *args[2:4], ent, p, box))
    for a, b, c in zip(twin, culled, untested):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert stats["skipped"] > 0  # the cull skipped entries
    hit = untested[1].numpy() >= 0
    np.testing.assert_array_equal(near[1].numpy() >= 0, hit)
    np.testing.assert_allclose(near[0].numpy(), untested[0].numpy(), **TOL)
    if anyhit:
        occ = untested[0].numpy() < -1.0
        assert 0 < occ.sum() < n and (twin[1] == -1).all()
    else:
        assert_tri_ties(sc, o, d, _tris(sc, near[1].numpy()),
                        _tris(sc, untested[1].numpy()), hit)
    if case == "subnormal":
        odd = np.zeros(n, bool)
        odd[0::4] = odd[1::4] = odd[2::8] = True
        assert not hit[odd].any() and hit[~odd].sum() > 50
        np.testing.assert_array_equal(twin[0].numpy()[odd], tmax[odd])
    elif not anyhit:
        assert hit.sum() > 50


def test_deep_padding_lanes_return_at_once(kscenes):
    """Lanes with tmax0 <= 0 (the route's padding lanes hold -BIG) return
    tmax0 and -1 and visit nothing: no record accepts a ray at a t below
    their bound (t >= 0), so a walk of their entries returns the same."""
    _, sc = kscenes
    p = 256
    o, d, tmax = _rays(23, 2 * p, "closest")
    tmax[::2] = -BIG
    tmax[1::4] = 0.0
    off = tmax <= 0
    ent = torch.from_numpy(_deep_lists(sc, np.random.default_rng(3), 2,
                                       root_every=1))
    args = _kernel_args(sc, o, d, tmax)
    rec = sc.leaf_rows.reshape(-1, 16)
    rec = rec[~rec[:, 0].isnan()]
    dd = torch.from_numpy(np.where(d == 0.0, np.float32(1e-20), d)[off])
    t, _, _, _, ok = t_packet.mt_test(rec[None], torch.from_numpy(o[off])[
        :, None], dd[:, None])
    assert not (ok & (t < torch.from_numpy(tmax[off])[:, None])).any()
    live = torch.from_numpy(~off)
    for anyhit in (False, True):
        stats, live_stats = {}, {}
        dst, prim = t_packet.packet_traverse_wide_reference(
            *args, anyhit=anyhit, entries=ent, packet_size=p, stats=stats)
        np.testing.assert_array_equal(dst.numpy()[off], tmax[off])
        assert (prim.numpy()[off] == -1).all()
        want = deep_in_order(*args[:5], ent, p, args[5], anyhit=anyhit)
        assert torch.equal(dst, want[0]) and torch.equal(prim, want[1])
        assert (prim.numpy()[~off] >= 0).sum() > 10 or anyhit
        # the live lanes alone, one packet per lane: the same visits
        t_packet.packet_traverse_wide_reference(
            *(x[live].contiguous() if i in (2, 3, 4) else x
              for i, x in enumerate(args)), anyhit=anyhit,
            entries=ent[torch.arange(2 * p)[live] // p].contiguous(),
            packet_size=1, stats=live_stats)
        for k in ("interior", "leaf", "children", "records"):
            assert stats[k] == live_stats[k], k


# ---- the kernel modes against the JAX kernel


def _entries(sc, seed):
    """Two packets' entry lists: shuffled treelet roots, the root in the
    second, -1 padded to E."""
    rand = np.random.default_rng(seed)
    roots = np.nonzero(sc.wide_troot.numpy())[0].astype(np.int32)
    ent = np.full((2, E), -1, np.int32)
    ent[0, :5] = rand.permutation(roots)[:5]
    ent[1, :3] = np.concatenate([[0], rand.permutation(roots)[:2]])
    return ent


@pytest.mark.parametrize("case", ["closest", "clipped", "inactive"])
def test_deep_kernel_matches_jax(kscenes, case):
    _, sc = kscenes
    n = 2 * P
    o, d, tmax = _rays(11, n, case)
    ent = _entries(sc, 5)
    t_packet.reset_launches()
    got = t_packet.packet_traverse_wide(
        *_kernel_args(sc, o, d, tmax), deep_e=E,
        entries=torch.from_numpy(ent), packet_size=P)
    assert sum(t_packet.launches.values()) == 0  # CPU: the plain version
    want = _jax_kernel(sc, o, d, tmax, deep_e=E, entries=_jax(ent))
    hit = _assert_closest(sc, o, d, tmax, [x.numpy() for x in got],
                          [np.asarray(x) for x in want[:2]])
    assert hit[:P].sum() > 20 and hit[P:].sum() > 20
    if case == "inactive":
        assert not hit[::3].any()


def test_deep_anyhit_matches_jax(kscenes):
    _, sc = kscenes
    n = 2 * P
    o, d, tmax = _rays(12, n, "clipped")
    tmax[::7] = -BIG
    ent = _entries(sc, 6)
    dst, prim = t_packet.packet_traverse_wide(
        *_kernel_args(sc, o, d, tmax), anyhit=True, deep_e=E,
        entries=torch.from_numpy(ent), packet_size=P)
    want = _jax_kernel(sc, o, d, tmax, anyhit=True, deep_e=E,
                       entries=_jax(ent))
    occ = np.asarray(want[0]) < -1.0
    assert 0 < occ.sum() < n
    np.testing.assert_array_equal(dst.numpy() < -1.0, occ)
    np.testing.assert_array_equal(dst.numpy()[~occ], tmax[~occ])
    assert (prim == -1).all()


def _entry_dist(sc, o, d):
    """(N, W) entry distance of each ray into each treelet root's box (its
    parent's child slot), inf where it misses or the node is no root."""
    wp = sc.wide_packed.numpy()
    w = wp.shape[0]
    boxes = np.full((w, 6), np.nan, np.float32)
    codes = wp[:, 6:64:8]
    par, slot = np.nonzero(np.isfinite(wp[:, 0:64:8]) & (codes > 0))
    boxes[codes[par, slot].astype(np.int64)] = wp[:, :64].reshape(w, 8, 8)[
        par, slot, :6]
    dd = np.where(d == 0.0, np.float32(1e-20), d)
    inv = (1.0 / dd)[:, None, :]
    oi = (o * (1.0 / dd))[:, None, :]
    t1 = boxes[None, :, :3] * inv - oi
    t2 = boxes[None, :, 3:] * inv - oi
    tmin = np.minimum(t1, t2).max(axis=2)
    tmx = np.maximum(t1, t2).min(axis=2)
    entry = np.where((tmx >= tmin) & (tmx > 0), tmin, np.inf)
    return np.where(sc.wide_troot.numpy()[None] == 1, entry, np.inf)


@pytest.mark.parametrize("anyhit", [False, True])
def test_top_kernel_matches_jax(kscenes, anyhit):
    _, sc = kscenes
    n = 900
    o, d, tmax = _rays(13, n, "clipped" if anyhit else "inactive")
    k = 5
    troot = sc.wide_troot
    dst, prim, slots, ovf = (x.numpy() for x in t_packet.packet_traverse_wide(
        *_kernel_args(sc, o, d, tmax), anyhit=anyhit, top_k=k, troot=troot))
    want = _jax_kernel(sc, o, d, tmax, anyhit=anyhit, top_k=k,
                       troot=_jax(troot))
    jdst, jprim = np.asarray(want[0]), np.asarray(want[1])
    jslots, jovf = np.asarray(want[5]), np.asarray(want[6])
    if anyhit:
        np.testing.assert_array_equal(dst < -1.0, jdst < -1.0)
        assert (prim == -1).all()
    else:
        _assert_closest(sc, o, d, tmax, (dst, prim), (jdst, jprim))
    roots = sc.wide_troot.numpy()
    assert (roots[slots[slots >= 0]] == 1).all()
    assert (slots >= 0).sum() > 100
    # the roots that can hold the closest hit: entered before the final
    # hit of the whole tree (the one-phase walk's dst)
    final = t_packet.packet_traverse_wide(*_kernel_args(sc, o, d, tmax),
                                          anyhit=anyhit)[0].numpy()
    entry = _entry_dist(sc, o, d)
    both = (ovf == 0) & (jovf == 0)
    checked = 0
    for i in np.nonzero(both)[0]:
        near = {r for r in np.nonzero(entry[i] < final[i])[0]}
        got = set(slots[i][slots[i] >= 0]) & near
        want_i = set(jslots[i][jslots[i] >= 0]) & near
        assert got == want_i == near, i
        checked += bool(near)
    assert checked > 50


# ---- the route against the JAX route and the port's one-phase walk


@pytest.fixture(scope="module")
def route_runs(scenes):
    """The JAX two-phase route (closest hit and occlusion) on one ray set,
    for top_k 2 and 5, run once for the tests below."""
    jsc, _ = scenes
    n = 900
    o, d, tmax = _rays(14, n, "clipped")
    act = np.ones(n, bool)
    act[::5] = False
    runs = {}
    for k in (2, 5):
        rt = JRouting(packet="interpret", two_phase=True, packet_size=P,
                      top_k=k)
        jo, jd, ja = _jax(o), _jax(d), _jax(act)
        hit = j_traverse.traverse(jsc, jo, jd, ja, routing=rt, need_uv=False)
        occ = j_traverse.traverse_anyhit(jsc, jo, jd, ja, _jax(tmax),
                                         routing=rt)
        runs[k] = (np.asarray(hit.dst), np.asarray(hit.prim),
                   np.asarray(hit.kind), np.asarray(occ))
    return (o, d, tmax, act), runs


def _count_calls(monkeypatch):
    """Record the start (root, TOP or DEEP) of every packet-walk call."""
    calls = []
    walk = t_packet.packet_traverse_wide

    def record(*args, **kw):
        calls.append("top" if kw.get("troot") is not None
                     else "deep" if kw.get("entries") is not None else "root")
        return walk(*args, **kw)

    monkeypatch.setattr(t_packet, "packet_traverse_wide", record)
    return calls


@pytest.mark.parametrize("k", [2, 5])
def test_route_closest_matches_jax(scenes, route_runs, monkeypatch, k):
    _, sc = scenes
    (o, d, _, act), runs = route_runs
    jdst, jprim, jkind, _ = runs[k]
    args = (sc, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(act))
    calls = _count_calls(monkeypatch)
    got = t_traverse.traverse(*args, routing=Routing(two_phase=True,
                                                     top_k=k))
    assert calls == ["top", "deep", "deep"]
    one = t_traverse.traverse(*args, routing=Routing(groups=0))
    dst, prim, kind = got.dst.numpy(), got.prim.numpy(), got.kind.numpy()
    hit = jkind == 2
    assert hit.sum() > 100
    np.testing.assert_array_equal(kind, jkind)
    np.testing.assert_allclose(dst, jdst, **TOL)
    tri = _tris(sc, np.where(hit, prim, -1))
    assert_tri_ties(sc, o, d, tri, np.where(hit, jprim, -1), hit)
    # against the one-phase walk: the same minimum
    assert torch.equal(got.dst, one.dst) and torch.equal(got.kind, one.kind)
    assert_tri_ties(sc, o, d, tri, _tris(sc, np.where(hit, one.prim.numpy(),
                                                      -1)), hit)
    if k == 2:  # lanes past their slots re-walk from the root
        tmax = np.full(len(o), BIG, np.float32)
        ovf = t_packet.packet_traverse_wide(*_kernel_args(sc, o, d, tmax),
                                            top_k=k, troot=sc.wide_troot)[3]
        assert ovf.any()


@pytest.mark.parametrize("k", [2, 5])
def test_route_anyhit_matches_jax(scenes, route_runs, k):
    _, sc = scenes
    (o, d, tmax, act), runs = route_runs
    jocc = runs[k][3]
    args = (sc, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(act), torch.from_numpy(tmax))
    occ = t_traverse.traverse_anyhit(*args, routing=Routing(two_phase=True,
                                                            top_k=k))
    assert 0 < jocc.sum() < len(jocc)
    np.testing.assert_array_equal(occ.numpy(), jocc)
    one = t_traverse.traverse_anyhit(*args, routing=Routing())
    assert torch.equal(occ, one)


def test_scene_without_treelets_takes_the_packet_walk(tmp_path,
                                                      monkeypatch):
    sc = soup_scene(trt, str(tmp_path)).compile(device="cpu")
    assert sc.meta["n_treelets"] == 0
    o, d, tmax = (torch.from_numpy(x) for x in _rays(15, 300, "clipped"))
    act = torch.ones(300, dtype=torch.bool)
    calls = _count_calls(monkeypatch)
    rt = Routing(two_phase=True)
    t_traverse.traverse(sc, o, d, act, routing=rt)
    t_traverse.traverse_anyhit(sc, o, d, act, tmax, routing=rt)
    assert calls == ["root", "root"]  # not the group kernel either
    assert t_traverse.prim_space(sc, rt) == "slot"


def test_route_calls_on_a_treelet_scene(scenes, monkeypatch):
    """Two-phase takes occlusion from the group kernel; the cluster and
    narrow routes stay ahead of it."""
    _, sc = scenes
    o, d, tmax = (torch.from_numpy(x) for x in _rays(16, 200, "clipped"))
    act = torch.ones(200, dtype=torch.bool)
    calls = _count_calls(monkeypatch)
    t_traverse.traverse_anyhit(sc, o, d, act, tmax,
                               routing=Routing(two_phase=True))
    assert calls == ["top", "deep", "deep"]
    t_traverse.traverse(sc, o, d, act,
                        routing=Routing(two_phase=True, wide=False))
    assert calls == ["top", "deep", "deep"]  # the narrow walk
    assert t_traverse.prim_space(sc, Routing(two_phase=True)) == "slot"


def test_wrapper_rejects_bad_treelet_inputs(kscenes):
    _, sc = kscenes
    n = 2 * P
    args = _kernel_args(sc, *_rays(17, n, "closest"))
    ent = torch.full((2, E), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="troot"):
        t_packet.packet_traverse_wide(*args, top_k=4)
    with pytest.raises(ValueError, match="packets"):
        t_packet.packet_traverse_wide(*args, deep_e=E, entries=ent,
                                      packet_size=P // 2)
    with pytest.raises(ValueError, match="deep_e"):
        t_packet.packet_traverse_wide(*args, entries=ent, packet_size=P)
    with pytest.raises(ValueError, match="entries per packet"):
        wide = torch.full((2, 40), -1, dtype=torch.int32)
        t_packet.packet_traverse_wide(*args, deep_e=40, entries=wide,
                                      packet_size=P)
    with pytest.raises(TypeError):
        t_packet.packet_traverse_wide(*args, top_k=4,
                                      troot=sc.wide_troot.long())
    with pytest.raises(ValueError, match="not both"):
        t_packet.packet_traverse_wide(*args, top_k=4, troot=sc.wide_troot,
                                      deep_e=E, entries=ent, packet_size=P)
    with pytest.raises(ValueError, match="top_k"):
        Routing(two_phase=True, top_k=0)


# ---- a render


def test_render_matches_group_route(tmp_path, monkeypatch):
    """sponza_proxy cut to 8k triangles, 32x18, spp 2, bounce 3: the
    two-phase image is the group route's."""
    _, tb = sponza_builders(str(tmp_path), monkeypatch, 8000)
    sc = tb.compile(device="cpu")
    assert sc.meta["n_treelets"] > 0
    cfg = trt.RenderConfig(width=32, height=18, samples_per_pixel=2,
                           bounce_limit=3)
    calls = _count_calls(monkeypatch)
    img = trt.render(sc, cfg.replace(routing=Routing(two_phase=True)))
    assert {"top", "deep"} <= set(calls) and "root" not in calls
    ref = trt.render(sc, cfg)
    assert_images_match(img.numpy(), ref.numpy())
    assert float(np.abs(img.numpy() - ref.numpy()).max()) < 1e-6


def test_empty_top_table_takes_the_packet_walk(tmp_path, monkeypatch):
    """A scene whose top level lies beyond the TOP walk's limits holds an
    empty (0,64) TOP table: ``Routing(two_phase=True)`` then takes the
    packet walk, as the JAX route falls back, and raises nowhere.  The
    2000-triangle soup under the sky, 24x24, spp 2, bounce 3: the route
    equals the port's packet route (``dst`` exact, ``prim`` up to exact-t
    ties) and its image the JAX ``render`` with ``two_phase=True``."""
    tmp = str(tmp_path)

    def lit_soup(pkg):
        b = soup_scene(pkg, tmp, n_tris=N_TRIS)
        b.set_environment(pkg.Environment(enabled=True))
        b.set_camera(pkg.Camera(position=(0.0, -0.5, -6.0)))
        return b

    full = lit_soup(trt).compile(device="cpu", max_leaf_tris=4)
    assert full.meta["n_treelets"] > 0 and full.wide_top.shape[0] > 0
    sc = dataclasses.replace(full, wide_top=torch.zeros((0, 64)))
    rt = Routing(two_phase=True)
    o, d, tmax = (torch.from_numpy(x) for x in _rays(18, 600, "clipped"))
    act = torch.ones(600, dtype=torch.bool)
    calls = _count_calls(monkeypatch)
    got = t_traverse.traverse(sc, o, d, act, routing=rt)
    occ = t_traverse.traverse_anyhit(sc, o, d, act, tmax, routing=rt)
    assert calls == ["root", "root"]
    packet_rt = Routing(groups=0, anyhit_group=False)
    want = t_traverse.traverse(sc, o, d, act, routing=packet_rt)
    assert torch.equal(got.dst, want.dst)
    assert torch.equal(got.kind, want.kind)
    hit = want.kind.numpy() == 2
    assert hit.sum() > 100
    assert_tri_ties(sc, o.numpy(), d.numpy(),
                    _tris(sc, np.where(hit, got.prim.numpy(), -1)),
                    _tris(sc, np.where(hit, want.prim.numpy(), -1)), hit)
    assert torch.equal(occ, t_traverse.traverse_anyhit(
        sc, o, d, act, tmax, routing=packet_rt))

    cfg = dict(width=24, height=24, samples_per_pixel=2, bounce_limit=3)
    img = trt.render(sc, trt.RenderConfig(routing=rt, **cfg))
    ref = jrt.render(lit_soup(jrt).compile(max_leaf_tris=4).device_put(),
                     jrt.RenderConfig(routing=JRouting(two_phase=True),
                                      **cfg))
    assert float(img.mean()) > 0.01
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=2e-3)
