"""Triangle clusters for the cluster traversal route.

Port of ``ray_tracer_tpu/accel/cluster.py`` (numpy, host side); the tables
it builds are the JAX package's, array for array.

Moller-Trumbore's four accept quantities are *bilinear* in per-ray
features and per-triangle coefficients.  With r = o - v0, q = r x d,
c = o x d (per ray) and the triple-product identity e.(v0 x d) =
d.(e x v0):

    t*d0 = r.n          =  o.n - (v0.n)                  (T block)
    d0   = -(d.n)                                        (B block)
    u*d0 = e2.q         =  c.e2 - d.(e2 x v0)            (U block)
    v*d0 = -(e1.q)      = -c.e1 + d.(e1 x v0)            (V block)
    front_only          =  constant per triangle         (FO block)

Each is a dot of the ray feature vector f = [o, d, c, 1] (padded to 16)
with a per-triangle coefficient row.  A *cluster* of up to t_c triangles
stores its rows transposed as one (16, 5*t_c) page, which
``kernels/cluster.py`` contracts against 128 rays at a time.

Clusters are cut from the binary tree as maximal subtrees holding <= t_c
triangles; the builder partitions triangles in place, so every subtree
owns a CONTIGUOUS triangle range and a cluster is just (start, count).
The remaining upper tree is a BVH over clusters; it collapses through
``accel/wide.py`` into the enumeration BVH8 (``cwide_packed``).  The
two-level box tables (``super_page``, ``super_cpage``) serve the
brute-force box enumeration instead.

Zero-padded coefficient columns are inert: B = 0 gives t = 0 * inf =
NaN, and every accept comparison on NaN is false.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bvh import BVHForest
from .wide import WideBVH, collapse

f32 = np.float32
i32 = np.int32

N_BLOCKS = 5  # T | B | U | V | FO


class ClusterCapacityError(ValueError):
    """Scene geometry exceeds what the cluster route can represent (a
    depth-capped SAH/SBVH leaf holding more than t_c references).
    ``SceneBuilder.compile()`` then builds no cluster tables, unless
    clusters were explicitly forced."""


@dataclass
class ClusterTables:
    clus_mt: np.ndarray  # (C, 16, N_BLOCKS*t_c) f32 coefficient pages
    clus_start: np.ndarray  # (C,) i32 global tri range start
    clus_count: np.ndarray  # (C,) i32
    cwide_packed: np.ndarray  # (Wc,128) f32 enum BVH8 (leaf code = cluster)
    t_c: int
    # Box enumeration, two brute-force levels: <= 128 'super' boxes
    # (subtree groups of <= 128 clusters), then per-super pages of their
    # cluster boxes.  Scenes beyond 128 x 128 clusters have none.
    super_page: np.ndarray = None  # (16,6*128) f32 level-1 coefficients
    super_cpage: np.ndarray = None  # (S,16,6*128) f32 per-super clusters
    super_cstart: np.ndarray = None  # (S,) i32 first cluster id (page
    # column c of super s is cluster cstart[s]+c)
    n_supers: int = 0


def cluster_cut(forest: BVHForest, root: int, t_c: int):
    """Maximal subtrees with <= t_c triangles.

    Returns (starts, counts, node_ids); node_ids are the subtree roots
    whose boxes become the cluster AABBs.
    """
    index = forest.index
    count = forest.tri_count
    n = index.shape[0]
    # Bottom-up subtree ranges: initialize leaves, then relax interiors
    # from their children until fixpoint (at most tree-depth sweeps).
    leaf = count > 0
    lo = np.where(leaf, index.astype(np.int64), np.int64(1 << 60))
    hi = np.where(leaf, (index + count).astype(np.int64), np.int64(-1))
    interior = ~leaf
    # leaf rows never read their (dummy) child indices, and a single-node
    # forest has no index 1 at all
    ci = np.where(interior, index, 0)
    cj = np.minimum(ci + 1, n - 1)
    for _ in range(max(int(forest.max_depth_seen), 1) + 2):
        lo_new = np.where(interior, np.minimum(lo[ci], lo[cj]), lo)
        hi_new = np.where(interior, np.maximum(hi[ci], hi[cj]), hi)
        if np.array_equal(lo_new, lo) and np.array_equal(hi_new, hi):
            break
        lo, hi = lo_new, hi_new
    else:
        # a forest whose max_depth_seen under-reports its depth would give
        # silently wrong cluster triangle ranges
        raise RuntimeError(
            "cluster_cut: subtree-range relaxation did not converge in "
            f"max_depth_seen+2 = {int(forest.max_depth_seen) + 2} sweeps; "
            "the forest's max_depth_seen stat is inconsistent with its "
            "topology"
        )

    starts, counts, nodes = [], [], []
    stack = [int(root)]
    while stack:
        nd = stack.pop()
        size = hi[nd] - lo[nd]
        if size <= t_c or count[nd] > 0:
            starts.append(int(lo[nd]))
            counts.append(int(size))
            nodes.append(nd)
        else:
            c = int(index[nd])
            stack += [c + 1, c]
    order = np.argsort(starts, kind="stable")
    return (
        np.asarray(starts, i32)[order],
        np.asarray(counts, i32)[order],
        np.asarray(nodes, i32)[order],
    )


def _mt_pages(tri_packed: np.ndarray, starts, counts, t_c: int,
              anchors: np.ndarray = None):
    """Transposed MT coefficient pages, one (16, 5*t_c) page per cluster.

    ``tri_packed`` rows: v0|e1|e2|n|front_only|obj|pad (scene/types.py).

    ``anchors`` (C,3): per-cluster local origin (the cluster AABB
    center).  Coefficients are built against v0' = v0 - anchor and the
    kernel shifts ray origins by the same anchor, so the factorization's
    cancellation terms stay at cluster-local magnitudes whatever the
    world position.  The anchor rides in the page at rows 10:13 of column
    0, which multiply zero feature rows.
    """
    if t_c & (t_c - 1) or t_c < 8:
        raise ValueError(
            f"cluster_t_c must be a power of two >= 8 (got {t_c}), the "
            "JAX package's page format"
        )
    C = starts.shape[0]
    if int(counts.max(initial=0)) > t_c:
        raise ClusterCapacityError(
            f"cluster holds {int(counts.max())} tris > t_c={t_c}"
        )
    pages = np.zeros((C, 16, N_BLOCKS * t_c), f32)
    if anchors is None:
        anchors = np.zeros((C, 3), np.float64)
    v0_all = tri_packed[:, 0:3].astype(np.float64)
    e1_all = tri_packed[:, 3:6].astype(np.float64)
    e2_all = tri_packed[:, 6:9].astype(np.float64)
    nrm_all = tri_packed[:, 9:12].astype(np.float64)
    fo_all = tri_packed[:, 12]
    for ci in range(C):
        s, cnt = int(starts[ci]), int(counts[ci])
        v0 = v0_all[s : s + cnt] - anchors[ci]
        e1 = e1_all[s : s + cnt]
        e2 = e2_all[s : s + cnt]
        nrm = nrm_all[s : s + cnt]
        # T block: o' rows = n; const row = -(v0'.n)
        pages[ci, 0:3, 0 * t_c : 0 * t_c + cnt] = nrm.T
        pages[ci, 9, 0 * t_c : 0 * t_c + cnt] = -np.einsum(
            "ij,ij->i", v0, nrm
        )
        # B block: d rows = -n
        pages[ci, 3:6, 1 * t_c : 1 * t_c + cnt] = -nrm.T
        # U block: d rows = -(e2 x v0'); c' rows = e2
        pages[ci, 3:6, 2 * t_c : 2 * t_c + cnt] = -np.cross(e2, v0).T
        pages[ci, 6:9, 2 * t_c : 2 * t_c + cnt] = e2.T
        # V block: d rows = (e1 x v0'); c' rows = -e1
        pages[ci, 3:6, 3 * t_c : 3 * t_c + cnt] = np.cross(e1, v0).T
        pages[ci, 6:9, 3 * t_c : 3 * t_c + cnt] = -e1.T
        # FO block: const row = front_only
        pages[ci, 9, 4 * t_c : 4 * t_c + cnt] = fo_all[s : s + cnt]
        # anchor stash (multiplies zero feature rows -> inert)
        pages[ci, 10:13, 0] = anchors[ci]
    return pages


def _pack_cwide(wide: WideBVH) -> np.ndarray:
    """(Wc,128) row-packed enum BVH8; leaf slot codes carry cluster ids in
    the traversal kernels' leaf payload encoding -(slot*16 + cnt) - 1 with
    slot = cluster id."""
    n_wide = wide.n_wide
    packed = np.zeros((n_wide, 128), f32)
    packed[:, :64] = wide.boxes.reshape(n_wide, 64)
    slot_meta = wide.meta[:-1].reshape(n_wide, 8, 4)
    codes = np.where(
        slot_meta[:, :, 1] > 0,
        -(slot_meta[:, :, 0] * 16 + 1) - 1,  # leaf: payload slot=cluster id
        slot_meta[:, :, 0],
    ).astype(f32)
    packed[:, 6:64:8] = codes
    packed[:, 7] = wide.axis.astype(f32)
    return packed


def _box_page(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """(B<=128,3)x2 -> (16, 6*128) slab-test coefficient page.

    Blocks [t1x|t2x|t1y|t2y|t1z|t2z], one column per box, the bound on the
    block's axis row (multiplied by that component of 1/d).  Padding
    columns carry NaN, so every comparison fails."""
    B = bmin.shape[0]
    assert B <= 128, B
    page = np.zeros((16, 6 * 128), f32)
    for blk in range(6):
        page[:, blk * 128 + B : (blk + 1) * 128] = np.nan
        ax = blk // 2
        src = bmin if blk % 2 == 0 else bmax
        row = np.zeros((16, B), f32)
        row[ax, :] = src[:, ax]
        page[:, blk * 128 : blk * 128 + B] = row
    return page


def build_super_tables(upper: BVHForest, root: int, cl_nodes: np.ndarray,
                       t_s: int = 128):
    """Two-level box-enumeration tables over the cluster set.

    ``upper`` is the cluster tree (leaves = clusters, 'tri ranges' are
    cluster-id ranges), so ``cluster_cut(upper, root, t_s)`` yields
    contiguous CLUSTER ranges of <= t_s: the supers.  Returns
    (super_page, super_cpage, super_cstart, n_supers), or None when the
    scene exceeds the 128 x 128 two-level capacity.
    """
    cs, cc, snodes = cluster_cut(upper, root, t_s)
    S = cs.shape[0]
    if S > 128:
        return None
    super_page = _box_page(upper.node_min[snodes], upper.node_max[snodes])
    cpages = np.zeros((S, 16, 6 * 128), f32)
    for si in range(S):
        ids = np.arange(cs[si], cs[si] + cc[si], dtype=i32)
        nd = cl_nodes[ids]
        cpages[si] = _box_page(upper.node_min[nd], upper.node_max[nd])
    return super_page, cpages, cs.astype(i32), S


def build_cluster_tables(
    forest: BVHForest, root: int, tri_packed: np.ndarray, t_c: int = 128
) -> ClusterTables:
    starts, counts, nodes = cluster_cut(forest, root, t_c)
    # cluster-local origins: AABB centers of the subtree roots, rounded to
    # f32 FIRST (the kernel reads the anchor from the f32 page stash, so
    # the coefficients must be built against the same value)
    anchors = (
        0.5 * (
            forest.node_min[nodes].astype(np.float64)
            + forest.node_max[nodes].astype(np.float64)
        )
    ).astype(np.float32).astype(np.float64)

    # Upper tree: cluster roots become leaves (index = cluster id, count =
    # 1) so the BVH8 collapse treats each cluster as one primitive.  The
    # node arrays are copied: the fine tree stays in use.
    upper = BVHForest(
        node_min=forest.node_min,
        node_max=forest.node_max,
        index=forest.index.copy(),
        tri_count=forest.tri_count.copy(),
        axis=forest.axis,
        hit_link=forest.hit_link,
        miss_link=forest.miss_link,
        roots=list(forest.roots),
        max_leaf_tris=forest.max_leaf_tris,
        max_depth_seen=forest.max_depth_seen,
    )
    for ci, nd in enumerate(nodes):
        upper.index[nd] = ci
        upper.tri_count[nd] = 1
    wide = collapse(upper, root)

    sup = build_super_tables(upper, root, nodes)
    if sup is None:
        super_page = np.full((16, 6 * 128), np.nan, f32)
        super_cpage = np.full((1, 16, 6 * 128), np.nan, f32)
        super_cstart = np.zeros(1, i32)
        n_supers = 0
    else:
        super_page, super_cpage, super_cstart, n_supers = sup

    return ClusterTables(
        clus_mt=_mt_pages(tri_packed, starts, counts, t_c, anchors),
        clus_start=starts,
        clus_count=counts,
        cwide_packed=_pack_cwide(wide),
        t_c=t_c,
        super_page=super_page,
        super_cpage=super_cpage,
        super_cstart=super_cstart,
        n_supers=n_supers,
    )
