"""The forest walk's world-space cull: ``kernels/packet.py::
forest_cull_table`` (each instance's world box, built on the host),
``forest_cull_trees`` (a tree over each chunk's boxes),
``forest_cull_reference`` and ``forest_mask_reference`` (the kernel's
cull and its candidate mask in plain torch, f32, in its order),
``forest_audit`` (its plain version on the CPU) and the scene's cached
``forest_cull``.

The cull may skip an instance only where the kernel's root test (the ray
taken to object space by ``packet.object_ray``, the root's box by
``packet._entry``, below the best t) must fail: every test here holds the
plain cull to that on rays that graze the boxes' edges and corners, from
far origins, with zero and subnormal direction components and with best
t at or below 0, at BIG and above it.  The kernel against both on the
card: ``tests/test_torch_gpu.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import ray_tracer_tpu as jrt
import ray_tracer_tpu_torch as trt
from ray_tracer_tpu_torch import CompiledScene
from ray_tracer_tpu_torch.kernels import packet
from ray_tracer_tpu_torch.utils.transforms import trs_matrix

from torch_parity import (
    BIG,
    grazing_rays,
    room_scene,
    scene_arrays,
    world_corners,
    write_obj,
)

# Hand-made placements of one mesh: rotations, non-uniform scales from
# 1e-3 to 1e3, a mirror and translations of 1e4.
PLACEMENTS = [
    dict(),
    dict(position=(0.5, 0.2, 0.1), rotation_deg=(10, 20, 30),
         scale=(1.1, 0.9, 1.0)),
    dict(position=(1e4, -1e4, 1e4), rotation_deg=(33, -71, 12)),
    dict(position=(-3.0, 2.0, 5.0), scale=(1e-3, 1.0, 1e3)),
    dict(position=(2.0, 0.0, -4.0), rotation_deg=(45, 45, 0),
         scale=(1e3, 1e-3, 1.0)),
    dict(position=(0.0, 7.0, 0.0), rotation_deg=(0, 90, 0),
         scale=(-1.0, 1.0, 1.0)),
    dict(position=(-1e4, 3.0, 2e3), rotation_deg=(-120, 5, 77),
         scale=(2e-3, 5e2, 0.7)),
]


def placed(pkg, tmp, seed=3, n_tris=40):
    """One triangle soup at each of ``PLACEMENTS``."""
    rand = np.random.default_rng(seed)
    tris = (rand.uniform(-1, 1, (n_tris, 1, 3))
            + rand.uniform(-0.3, 0.3, (n_tris, 3, 3)))
    path = write_obj(os.path.join(tmp, "placed.obj"), tris.reshape(-1, 3),
                     [(3 * i + 1, 3 * i + 2, 3 * i + 3)
                      for i in range(n_tris)])
    b = pkg.SceneBuilder()
    b.add_material(pkg.Material())
    for p in PLACEMENTS:
        b.add_obj(path, material=0, **p)
    return b


SCENES = {"room": room_scene, "placed": placed}


@pytest.fixture(scope="module", params=list(SCENES))
def forest(request, tmp_path_factory):
    """(the port's forest scene, the JAX package's, its name)."""
    tmp = str(tmp_path_factory.mktemp("cull"))
    make = SCENES[request.param]
    return (make(trt, tmp).compile(flatten_instances=False, device="cpu"),
            make(jrt, tmp).compile(flatten_instances=False),
            request.param)


def _tables(sc):
    return (sc.obj_inv_transform.numpy(), sc.bvh_packed.numpy(),
            list(sc.meta["obj_roots"]))


def _rows(sc):
    """The scene's per-instance world boxes, (K,8) f32."""
    return torch.tensor(sc.meta["forest_cull"],
                        dtype=torch.float32).reshape(-1, 8)


def _root_test(inv, box, origin, direction, best):
    """The kernel's root test in plain torch: the rays taken to object
    space by ``inv`` (4,4), the box (6,) entered below ``best``."""
    o, d = packet.object_ray(inv, origin, direction)
    rec = 1.0 / torch.where(d == 0.0, 1e-20, d)
    return packet._entry(box.expand(o.shape[0], 6), o, rec) < best


def _culls_only_misses(inv, box, row, o, d, best):
    """Hold the plain cull of one instance to its root test on the rays:
    no lane culled whose root test passes.  Returns (culled, entered)."""
    o, d, best = (torch.from_numpy(np.ascontiguousarray(x))
                  for x in (o, d, best))
    culled = packet.forest_cull_reference(row, o, d, best)
    entered = _root_test(inv, box, o, d, best)
    bad = (culled & entered).nonzero()[:, 0]
    assert bad.numel() == 0, (
        f"{bad.numel()} rays culled though their root test passes, e.g. "
        f"o={o[bad[0]].tolist()} d={d[bad[0]].tolist()} "
        f"best={float(best[bad[0]])}")
    return culled, entered


def test_world_boxes_hold_the_root_boxes(forest):
    """Each row's box holds the float64 images of its root box's corners
    and of random points inside it, under the float64 inverse of the f32
    inverse transform; eta and delta are positive, and on transforms of
    condition number near 1 the box grows by less than 1e-4 of its size."""
    sc, _, _ = forest
    inv, nodes, roots = _tables(sc)
    table = _rows(sc).numpy()
    rand = np.random.default_rng(0)
    assert table.shape == (len(roots), 8)
    for k, root in enumerate(roots):
        lo, hi = table[k, 0:3], table[k, 4:7]
        box = nodes[root, 0:6].astype(np.float64)
        inside = box[0:3] + rand.random((64, 3)) * (box[3:6] - box[0:3])
        m = inv[k].astype(np.float64)
        pts = np.concatenate([
            world_corners(inv[k], nodes[root, 0:6]),
            (inside - m[:3, 3]) @ np.linalg.inv(m[:3, :3]).T])
        assert (lo <= pts).all() and (pts <= hi).all(), k
        assert table[k, 3] > 0 and table[k, 7] > 0
        a = m[:3, :3]
        kappa = (np.abs(np.linalg.inv(a)) @ np.abs(a).sum(1)).max()
        if kappa < 10:
            size = np.ptp(pts, axis=0).max()
            assert ((pts.min(0) - lo).max() < 1e-4 * size + 1e-3 * table[k, 7]
                    + 1e-5 * np.abs(pts).max())


def test_cull_on_grazing_rays(forest):
    """Rays aimed at every instance's world-box corners and edges, each
    component moved by an ulp, from near and far: the plain cull never
    drops an instance whose root test passes, and it does cull."""
    sc, _, _ = forest
    inv, nodes, roots = _tables(sc)
    rows = _rows(sc)
    rand = np.random.default_rng(1)
    total = [0, 0]
    for spread in (4.0, 1e3):
        o, d, best = grazing_rays(inv, nodes, roots, 300, rand, spread)
        for k, root in enumerate(roots):
            culled, entered = _culls_only_misses(
                sc.obj_inv_transform[k], sc.bvh_packed[root, 0:6],
                rows[k], o, d, best)
            total[0] += int(culled.sum())
            total[1] += int(entered.sum())
    assert total[0] > 0 and total[1] > 0


_angle = st.floats(-180.0, 180.0)
_log_scale = st.floats(-3.0, 3.0)
_shift = st.floats(-1e4, 1e4)


@settings(max_examples=60, deadline=None)
@given(angles=st.tuples(_angle, _angle, _angle),
       log_scale=st.tuples(_log_scale, _log_scale, _log_scale),
       mirror=st.integers(0, 7), shift=st.tuples(_shift, _shift, _shift),
       log_size=st.floats(-3.0, 2.0), seed=st.integers(0, 2**31 - 1))
def test_cull_never_drops_an_entered_instance(angles, log_scale, mirror,
                                              shift, log_size, seed):
    """The property, over random placements (rotations, scales from 1e-3
    to 1e3 per axis, mirrors, translations up to 1e4) of a random box:
    ``forest_cull_reference`` of ``forest_cull_table``'s row never culls
    a ray whose root test passes.  The rays graze the box's world edges
    and corners (ulp-jittered), from near and from up to 1e5 box sizes
    away, some with zero or subnormal direction components, with best t
    at or below 0, at BIG, above it and at the corner's distance."""
    rand = np.random.default_rng(seed)
    sign = np.where((mirror >> np.arange(3)) & 1, -1.0, 1.0)
    fwd = trs_matrix(shift, angles, sign * 10.0 ** np.asarray(log_scale))
    inv = np.linalg.inv(fwd.astype(np.float64)).astype(np.float32)
    lo = rand.uniform(-10.0, 10.0, 3)
    size = 10.0 ** log_size * rand.uniform(0.1, 1.0, 3)
    nodes = np.zeros((1, 8), np.float32)
    nodes[0, 0:3], nodes[0, 3:6] = lo, lo + size
    row = torch.from_numpy(packet.forest_cull_table(inv[None], nodes, [0])[0])
    near = grazing_rays(inv[None], nodes, [0], 192, rand, 4.0)
    far = grazing_rays(inv[None], nodes, [0], 64, rand, 1e5)
    o, d, best = (np.concatenate(x) for x in zip(near, far))
    tiny = rand.random(d.shape) < 0.05
    d = np.where(tiny, np.copysign(np.float32(1e-40), d), d)
    _culls_only_misses(torch.from_numpy(inv), torch.from_numpy(nodes[0, 0:6]),
                       row, o, d.astype(np.float32), best)


@pytest.mark.parametrize("placement", ["singular", "nan", "ill"])
def test_cull_table_keeps_what_it_cannot_bound(placement):
    """A singular or non-finite transform, or one beyond the condition
    number the margin covers, gets the row that never culls."""
    inv = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    if placement == "singular":
        inv[1, 2, :3] = 0.0
    elif placement == "nan":
        inv[1, 0, 3] = np.nan
    else:
        inv[1, :3, :3] = trs_matrix((0, 0, 0), (30, 40, 50),
                                    (1e-4, 1.0, 1e4))[:3, :3]
        inv[1, :3, :3] = (trs_matrix((0, 0, 0), (10, 70, 20), (1, 1, 1))
                          [:3, :3] @ inv[1, :3, :3])
    nodes = np.array([[0, 0, 0, 1, 1, 1, 0, 0]], np.float32)
    table = packet.forest_cull_table(inv, nodes, [0, 0])
    assert np.isfinite(table[0]).all()
    np.testing.assert_array_equal(table[1], np.array(packet.CULL_NEVER,
                                                     np.float32))
    o = torch.tensor([[5.0, 5.0, 5.0]] * 2)
    d = torch.tensor([[1.0, 0.0, 0.0]] * 2)
    best = torch.full((2,), 3.0)
    assert packet.forest_cull_reference(torch.from_numpy(table[0]), o, d,
                                        best).all()
    assert not packet.forest_cull_reference(torch.from_numpy(table[1]), o,
                                            d, best).any()


@pytest.mark.parametrize("anyhit", [False, True])
def test_audit_counts_the_plain_walk(forest, anyhit):
    """The audit's plain version (``forest_audit`` on CPU tensors): the
    outputs of ``forest_traverse_reference``, its scans, box and triangle
    tests equal to that walk's ``stats``, no violation, and every root
    pass a world-box pass."""
    sc, _, _ = forest
    inv, nodes, roots = _tables(sc)
    o, d, best = (torch.from_numpy(x) for x in grazing_rays(
        inv, nodes, roots, 120, np.random.default_rng(2)))
    keep = torch.isfinite(best)  # an infinite bound never ends a lane
    o, d, best = o[keep], d[keep], best[keep]
    r_words = sc.forest_roots
    out, counts = packet.forest_audit(
        sc.bvh_packed, sc.bvh_axis, sc.tri_packed, sc.obj_inv_transform,
        *r_words, sc.forest_cull, o, d, best, anyhit=anyhit)
    stats = {}
    want = packet.forest_traverse_reference(
        sc.bvh_packed, sc.bvh_axis, sc.tri_packed, sc.obj_inv_transform,
        roots, o, d, best, anyhit=anyhit, stats=stats)
    for a, b in zip(out if not anyhit else (out,),
                    want if not anyhit else (want,)):
        assert torch.equal(a, b)
    for k in ("scans", "boxes", "tris"):
        assert counts[k] == stats[k], k
    assert counts["violations"] == 0
    assert counts["root_pass"] <= counts["world_pass"] < counts["scans"]
    assert counts["root_pass"] > 0
    assert counts["scans"] <= counts["roots"] <= counts["boxes"]
    assert counts["tree_tests"] > 0


def test_forest_cull_property(forest):
    """``CompiledScene.forest_cull``: the chunk trees of
    ``meta["forest_cull"]``'s rows, an f32 tensor on the scene's device;
    ``.to`` and ``dataclasses.replace`` give scenes that build their own,
    and ``from_numpy`` derives the rows from the JAX package's tables."""
    sc, jsc, _ = forest
    trees = sc.forest_cull
    k = len(sc.meta["obj_roots"])
    assert trees.dtype == torch.float32 and trees.device.type == "cpu"
    assert trees.shape == (-(-k // packet.FOREST_CHUNK) * packet.TREE_ROWS,
                           8)
    assert sc.forest_cull is trees  # built once per scene object
    assert torch.equal(_rows(sc), torch.from_numpy(
        packet.forest_cull_table(*_tables(sc))))
    assert torch.equal(trees, torch.from_numpy(
        packet.forest_cull_trees(_rows(sc))))
    moved = sc.to("cpu")
    assert moved.forest_cull is not trees
    assert torch.equal(moved.forest_cull, trees)
    rows = [list(r) for r in sc.meta["forest_cull"]]
    rows[0][0] -= 1.0
    changed = dataclasses.replace(
        sc, meta={**sc.meta, "forest_cull": tuple(map(tuple, rows))})
    assert torch.equal(changed.forest_cull, torch.from_numpy(
        packet.forest_cull_trees(np.array(rows, np.float32))))
    assert not torch.equal(changed.forest_cull, trees)
    short = dataclasses.replace(
        sc, meta={**sc.meta, "forest_cull": sc.meta["forest_cull"][1:]})
    with pytest.raises(ValueError, match="forest_cull"):
        short.forest_cull
    jarr, jmeta = scene_arrays(jsc)
    from_jax = CompiledScene.from_numpy(jarr, jmeta, device="cpu")
    assert from_jax.meta["forest_cull"] == sc.meta["forest_cull"]


@pytest.mark.parametrize("k", [1, 2, 128, 129, 300])
def test_chunk_trees(k):
    """``forest_cull_trees`` over K rows (random boxes, some that never
    cull): each chunk of 128 has one tree whose leaves are its rows, each
    once, with the word ``TREE_LEAF | e``; each interior node holds its
    children's boxes and their largest eta, its children after it; no
    leaf deeper than the kernel's stack allows."""
    rand = np.random.default_rng(k)
    lo = rand.uniform(-50, 50, (k, 3))
    rows = np.concatenate([lo, rand.uniform(0, 1e-5, (k, 1)),
                           lo + rand.uniform(0.01, 10, (k, 3)),
                           rand.uniform(0, 1e-4, (k, 1))], 1)
    rows[::7] = packet.CULL_NEVER
    rows = rows.astype(np.float32)
    trees = packet.forest_cull_trees(rows)
    assert trees.shape == (-(-k // 128) * packet.TREE_ROWS, 8)
    words = trees[:, 7].view(np.uint32).astype(np.int64)
    for c in range(-(-k // 128)):
        m = min(128, k - 128 * c)
        base = c * packet.TREE_ROWS
        leaves = {}

        def visit(r, depth):
            w = int(words[base + r])
            if w & packet.TREE_LEAF:
                e = w & ~packet.TREE_LEAF
                assert e not in leaves and depth < packet.TREE_STACK
                leaves[e] = r
                np.testing.assert_array_equal(trees[base + r, :7],
                                              rows[128 * c + e, :7])
                return
            assert w > r
            node = trees[base + r]
            for child in (w, w + 1):
                kid = trees[base + child]
                assert (node[0:3] <= kid[0:3]).all()
                assert (node[4:7] >= kid[4:7]).all() and node[3] >= kid[3]
                visit(child, depth + 1)

        visit(0, 0)
        assert sorted(leaves) == list(range(m))


def test_tree_mask_keeps_what_the_flat_cull_keeps(forest):
    """On grazing rays, the candidates of each chunk's tree
    (``forest_mask_reference``) hold every instance the flat cull of its
    own row keeps, so the tree drops no instance whose root test passes;
    each walk tests its root's box, and two boxes a node it enters."""
    sc, _, _ = forest
    inv, nodes, roots = _tables(sc)
    rows = _rows(sc)
    o, d, best = (torch.from_numpy(x) for x in grazing_rays(
        inv, nodes, roots, 60, np.random.default_rng(4)))
    mask, tests = packet.forest_mask_reference(sc.forest_cull, 0, len(roots),
                                               o, d, best)
    keep = ~packet.forest_cull_reference(rows, o, d, best)
    assert (mask | ~keep).all()
    assert (~mask).any() and mask.any()
    walked = best <= BIG
    assert (tests[walked] >= 1).all() and (tests[~walked] == 0).all()
    assert (tests % 2 == 1)[walked].all()


def test_forest_traverse_checks_the_cull(forest):
    """On CPU tensors the wrapper checks ``cull``'s shape, type and values
    against the tables (the chunk trees of their world boxes), as it
    checks the roots' words."""
    sc, _, _ = forest
    roots, words = sc.forest_roots
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    best = torch.full((4,), BIG)
    args = (sc.bvh_packed, sc.bvh_axis, sc.tri_packed, sc.obj_inv_transform,
            roots, words)
    packet.forest_traverse(*args, sc.forest_cull, o, d, best)
    bad = {"shape": sc.forest_cull[:, :7].contiguous(),
           "rows": _rows(sc),
           "dtype": sc.forest_cull.double(),
           "values": sc.forest_cull.clone()}
    bad["values"][0, 4] = bad["values"][0, 0]
    for what, cull in bad.items():
        with pytest.raises((ValueError, TypeError)):
            packet.forest_traverse(*args, cull, o, d, best)
        with pytest.raises((ValueError, TypeError)):
            packet.forest_audit(*args, cull, o, d, best)
