"""Scene description and compiled device-side scene tensors.

Host-side description objects mirror the reference's scene model
(``src/vk_engine.h:49-132``): spheres, materials, mesh instances with TRS
transforms, and a per-``usemtl``-group BVH forest.  ``CompiledScene`` is the
flat SoA table set uploaded to the device as torch tensors — the
replacement for the reference's nine storage-buffer bindings
(``shaders/raytrace.comp:120-148``).  The field layout is the JAX
package's (``ray_tracer_tpu/scene/types.py``), except the rope streams,
which hold only the tree's boxes (:func:`rope_box_rows`).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


# --------------------------------------------------------------------------
# Host-side description
# --------------------------------------------------------------------------


@dataclass
class Material:
    """Mirrors reference ``RayMaterial`` (``src/vk_engine.h:69-79``)."""

    albedo: tuple = (1.0, 1.0, 1.0)
    emission_color: tuple = (0.0, 0.0, 0.0)
    emission_strength: float = 0.0
    reflectance: float = 0.0
    ior: float = -1.0  # -1 sentinel: not dielectric (vk_engine.h:74)
    albedo_tex: int = -1
    metalness_tex: int = -1
    alpha_tex: int = -1
    bump_tex: int = -1
    name: str = ""


@dataclass
class SphereDesc:
    """Mirrors reference ``Sphere`` (``src/vk_engine.h:49-53``)."""

    position: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0
    material: int = 0


@dataclass
class InstanceDesc:
    """One render object: a transform + material + BVH root.

    Mirrors reference ``RenderObject`` (``src/vk_engine.h:117-123``); one is
    emitted per ``usemtl`` group of a mesh (``src/vk_engine.cpp:960-1006``).
    """

    transform: np.ndarray  # (4,4) float32
    bvh_root: int
    material: int
    smooth_shade: bool = False
    sampler: int = 0  # 0 = nearest, 1 = bilinear
    name: str = ""


@dataclass
class RectLight:
    """Analytic NEE area light (replaces the hardcoded quad at
    ``shaders/raytrace.comp:368-403``).

    The rectangle is ``corner + u*su + v*sv`` for ``su, sv in [0,1)``;
    ``normal`` is the emitting face direction used for the PDF cosine.
    """

    corner: tuple
    edge_u: tuple
    edge_v: tuple
    normal: tuple
    material: int

    @property
    def area(self) -> float:
        return float(
            np.linalg.norm(np.cross(np.asarray(self.edge_u), np.asarray(self.edge_v)))
        )


@dataclass
class Environment:
    """Mirrors reference ``EnvironmentData`` (``src/vk_engine.h:153-158``)."""

    horizon_color: tuple = (0.986, 1.0, 0.902)
    sun_focus: float = 1000.0
    zenith_color: tuple = (0.265, 0.595, 0.887)
    sun_intensity: float = 10.0
    ground_color: tuple = (0.431, 0.431, 0.431)
    light_dir: tuple = (0.5144958, 0.2057983, -0.7717437)  # normalize(2,.8,-3)
    enabled: bool = False


@dataclass
class Camera:
    """Mirrors reference ``CameraInfo`` (``src/vk_engine.h:145-151``) plus the
    euler-angle state (``vk_engine.h:325``) used to build the rotation."""

    position: tuple = (0.0, -0.5, -3.5)
    angles_deg: tuple = (4.0, 0.0, 0.0)
    fov: float = 50.0
    near_plane: float = 0.1


# --------------------------------------------------------------------------
# Compiled device scene
# --------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when it is None.

    The port runs on the card unless the caller asks for the CPU: with no
    device given and no CUDA device present this raises instead of
    silently running on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to compile the scene for the "
            "CPU (the plain torch versions of the kernels)"
        )
    return torch.device("cuda")


def page_counts(arrays: dict, meta: dict) -> dict:
    """The cluster tables' page counts from the range starts: a cluster's
    triangles run to the next cluster's start (the last to the end of
    ``tri_packed``), a super's clusters to the next super's first cluster
    (the last to ``n_clusters``); the level-1 page holds ``n_supers``
    boxes.  Placeholder tables count 0."""
    n_c = int(meta.get("n_clusters", 0))
    n_s = int(meta.get("n_supers", 0))

    def runs(starts, end, n):
        if not n:
            return np.zeros(1, np.int32)
        return np.diff(np.asarray(starts, np.int64), append=end).astype(
            np.int32)

    return dict(
        clus_count=runs(arrays["clus_start"],
                        np.asarray(arrays["tri_packed"]).shape[0], n_c),
        super_page_count=np.array([n_s], np.int32),
        super_cpage_count=runs(arrays["super_cstart"], n_c, n_s),
    )


def narrow_root_meta(arrays: dict) -> dict:
    """The narrow walk's roots, read once on the host: ``bvh_root``, the
    binary BVH's root node (the first object's, as the narrow route walks
    the flattened tree), and ``bvh_root_word``, its word for the kernel
    (``kernels/packet.py::narrow_root_word``, -1 where the table lies
    beyond the word's limits); ``obj_roots`` and ``obj_root_words``, every
    instance's root and its word, which the forest walk starts from; and
    ``forest_cull``, those instances' world boxes for the forest walk's
    cull (:func:`forest_cull_meta`)."""
    from ..kernels.packet import narrow_root_words

    roots = [int(r) for r in np.asarray(arrays["obj_bvh_root"]).reshape(-1)]
    words = narrow_root_words(arrays["bvh_packed"], arrays["bvh_axis"],
                              roots or [0])
    return dict(bvh_root=roots[0] if roots else 0, bvh_root_word=words[0],
                obj_roots=tuple(roots),
                obj_root_words=tuple(words[:len(roots)]),
                forest_cull=forest_cull_meta(arrays, roots))


def forest_cull_meta(arrays: dict, roots) -> tuple:
    """The forest walk's world boxes, read once on the host: one row of 8
    floats per instance root of ``roots``
    (``kernels/packet.py::forest_cull_table`` of ``obj_inv_transform`` and
    the roots' rows of ``bvh_packed``), whose chunk trees
    ``CompiledScene.forest_cull`` puts on the scene's device."""
    from ..kernels.packet import forest_cull_table

    table = forest_cull_table(arrays["obj_inv_transform"],
                              arrays["bvh_packed"], roots)
    return tuple(tuple(row) for row in table.tolist())


ROPE_FIELDS = 16  # floats per row of the JAX package's rope streams
ROPE_PAGE = 128  # rows per page of the JAX package's layout
ROPE_BOX_FIELDS = 8  # floats per BOX row of this package's rope streams
ROPE_DEAD = 1 << 24  # the miss row that ends a walk, f32-exact
# A leaf's word: count << ROPE_FIRST_BITS | first.  count 1..ROPE_MAX_COUNT
# and first below 2^ROPE_FIRST_BITS keep the word's bits a finite float's.
ROPE_FIRST_BITS = 24
ROPE_MAX_COUNT = 126


def rope_leaf_words(first, count, n_tris: int) -> np.ndarray:
    """The rope streams' leaf words, (B,) int32: ``count << 24 | first``
    where ``count > 0`` (a leaf of triangles first .. first + count - 1),
    0 elsewhere (an interior node).  Raises ``ValueError`` where a leaf
    lies beyond the word's limits or past the ``n_tris`` triangles."""
    first = np.asarray(first, np.int64)
    count = np.asarray(count, np.int64)
    leaf = count > 0
    f, c = first[leaf], count[leaf]
    if leaf.any() and (int(c.max()) > ROPE_MAX_COUNT
                       or int(f.min()) < 0
                       or int(f.max()) >= 1 << ROPE_FIRST_BITS
                       or int((f + c).max()) > n_tris):
        raise ValueError(
            f"a rope-walk leaf lies beyond the leaf word's limits: at most "
            f"{ROPE_MAX_COUNT} triangles from a first triangle below "
            f"2^{ROPE_FIRST_BITS}, within the scene's {n_tris}")
    return np.where(leaf, count << ROPE_FIRST_BITS | first, 0).astype(
        np.int32)


def rope_box_rows(streams: np.ndarray, n_rows: int, n_tris: int):
    """The JAX package's rope streams as this package's: ``(box_streams,
    n_box)``, (8, n_box, 8) f32 and the BOX rows per octant.

    ``streams`` are the JAX package's (8, n_pages, 16*128) page-major
    streams, or the same rows row-major, (8, R_pad, 16), of which the
    first ``n_rows`` per octant are real (BOX rows: 0:3 bmin | 3:6 bmax |
    6 hit row | 7 miss row | 15 type 0; TRI rows: ... 12 next row | 14
    global triangle id | 15 type 1).  The TRI rows go; each BOX row keeps
    its box, its miss row renumbered among the BOX rows (``ROPE_DEAD``
    stays), and a leaf word (:func:`rope_leaf_words`): ``first`` from its
    first TRI row's float 14, ``count`` from the run of TRI rows after
    it.  Raises ``ValueError`` unless every BOX row's hit row is the next
    row, every miss row a BOX row or ``ROPE_DEAD``, and each leaf's TRI
    rows consecutive triangles chained to the leaf's miss row.
    """
    s = np.asarray(streams)
    if s.shape[-1] == ROPE_FIELDS * ROPE_PAGE:
        s = rope_rows_layout(s)
    out = []
    for o in range(s.shape[0]):
        r = s[o, :n_rows]
        box = np.nonzero(r[:, 15] <= 0.5)[0]
        new_id = np.full(n_rows + 1, -1, np.int64)
        new_id[box] = np.arange(box.size)
        if not np.array_equal(r[box, 6], (box + 1).astype(np.float32)):
            raise ValueError(f"octant {o}: a BOX row's hit row is not the "
                             "next row")
        miss = r[box, 7].astype(np.int64)
        dead = miss >= ROPE_DEAD
        renum = new_id[np.clip(miss, 0, n_rows)]
        if (~dead & ((miss < 0) | (renum < 0))).any():
            raise ValueError(f"octant {o}: a miss row is not a BOX row")
        count = np.diff(np.append(box, n_rows)) - 1
        leaf = count > 0
        first = np.zeros(box.size, np.int64)
        first[leaf] = r[box[leaf] + 1, 14].astype(np.int64)
        # the TRI rows of each leaf: consecutive ids, chained in order,
        # the last one to the leaf's miss row
        tri = np.nonzero(r[:, 15] > 0.5)[0]
        owner = np.searchsorted(box, tri) - 1
        k = tri - box[owner] - 1
        last = k == count[owner] - 1
        nxt = np.where(last, r[box[owner], 7], tri + 1)
        if (owner < 0).any() or not (
                np.array_equal(r[tri, 14].astype(np.int64),
                               first[owner] + k)
                and np.array_equal(r[tri, 12], nxt.astype(np.float32))):
            raise ValueError(f"octant {o}: a leaf's TRI rows are not its "
                             "consecutive triangles")
        rows = np.zeros((box.size, ROPE_BOX_FIELDS), np.float32)
        rows[:, 0:6] = r[box, 0:6]
        rows[:, 6] = np.where(dead, ROPE_DEAD, renum)
        rows.view(np.int32)[:, 7] = rope_leaf_words(first, count, n_tris)
        out.append(rows)
    if len({x.shape[0] for x in out}) != 1:
        raise ValueError("the octants' streams hold different trees")
    return np.ascontiguousarray(np.stack(out)), out[0].shape[0]


def rope_rows_layout(streams: np.ndarray) -> np.ndarray:
    """The JAX package's page-major, field-major rope streams (8, n_pages,
    16*128) as row-major (8, n_pages*128, 16) rows: field f of row r of
    page p sits at column f*128 + r there."""
    s = np.asarray(streams)
    n_oct, n_pages = s.shape[:2]
    return np.ascontiguousarray(
        s.reshape(n_oct, n_pages, ROPE_FIELDS, ROPE_PAGE)
        .transpose(0, 1, 3, 2)
        .reshape(n_oct, n_pages * ROPE_PAGE, ROPE_FIELDS)
    )


def rope_placeholder() -> np.ndarray:
    """The one-row ``rope_streams`` of a scene compiled without them."""
    return np.zeros((1, 1, ROPE_BOX_FIELDS), np.float32)


@dataclass
class CompiledScene:
    """Flat SoA tensors plus static ``meta``.

    ``SceneBuilder.compile()`` builds the fields as numpy arrays and hands
    them to :meth:`from_numpy`, which puts them on a device as torch
    tensors; :meth:`to` copies a scene to another device.  Integer ids
    stored in float rows are f32 *values*, never
    bitcasts, except ``bvh_packed`` columns 6-7 (index/count bitcast, as in
    the reference package) and ``rope_streams`` column 7 (the leaf word).
    """

    # Spheres (padded to a static count; radius 0 rows are inert).
    sphere_pos: Any  # (S,3) f32
    sphere_radius: Any  # (S,) f32
    sphere_mat: Any  # (S,) i32

    # Materials.
    mat_albedo: Any  # (M,3) f32
    mat_emission: Any  # (M,3) f32
    mat_emission_strength: Any  # (M,) f32
    mat_reflectance: Any  # (M,) f32
    mat_ior: Any  # (M,) f32
    mat_albedo_tex: Any  # (M,) i32
    mat_metalness_tex: Any  # (M,) i32
    mat_alpha_tex: Any  # (M,) i32
    mat_bump_tex: Any  # (M,) i32

    # Triangle geometry (BVH-reordered, global across all meshes).
    tri_v0: Any  # (T,3) f32
    tri_e1: Any  # (T,3) f32  v1 - v0
    tri_e2: Any  # (T,3) f32  v2 - v0
    tri_n: Any  # (T,3) f32   cross(e1, e2)
    tri_front_only: Any  # (T,) bool
    tri_obj: Any  # (T,) i32: owning instance (flattened scenes)
    tri_vn: Any  # (T,3,3) f32 vertex normals
    tri_uv: Any  # (T,3,2) f32 vertex uvs
    tri_shade: Any  # (T,16) f32: vn0|vn1|vn2 | uv0|uv1|uv2 | degenerate-uv
    # Fat shading rows, layout: 0-8 vn | 9-14 uv | 15 degen | 16-18
    # albedo | 19-21 emission*strength | 22 reflectance | 23 ior | 24
    # albedo_tex | 25 sampler | 26 material id | 27 instance id | 28 global
    # tri id | 29 metalness_tex | 30 alpha_tex | 31 bump_tex | 32-43 the
    # triangle's v0|e1|e2|n record.
    shade_tri: Any  # (T,48) f32, indexed by global tri id
    shade_slot: Any  # (L*8,48) f32, indexed by padded leaf slot (kernel ids)

    # Instances.
    obj_transform: Any  # (O,4,4) f32
    obj_inv_transform: Any  # (O,4,4) f32
    obj_bvh_root: Any  # (O,) i32
    obj_mat: Any  # (O,) i32
    obj_smooth: Any  # (O,) bool
    obj_sampler: Any  # (O,) i32

    # Binary BVH forest (SoA) and octant-threaded links.
    bvh_min: Any  # (B,3) f32
    bvh_max: Any  # (B,3) f32
    bvh_index: Any  # (B,) i32
    bvh_tri_count: Any  # (B,) i32: 0 => interior
    bvh_axis: Any  # (B,) i32
    bvh_hit_link: Any  # (8,B) i32
    bvh_miss_link: Any  # (8,B) i32
    bvh_packed: Any  # (B,8) f32: min3 | max3 | index (bitcast) | count (bitcast)
    links_packed: Any  # (8*B,2) i32
    tri_packed: Any  # (T,16) f32: v0|e1|e2|n | front_only | obj (bitcast) | pad2
    # BVH8, one 128-float row per wide node: per child c, floats 8c..8c+5 =
    # min3|max3, float 8c+6 = traversal code as an f32 VALUE (>=0 wide id;
    # <0 leaf with payload -(row*16 + cnt) - 1); float 7 = child-sort axis.
    # Empty child slots carry NaN boxes and code 0.
    wide_packed: Any  # (W,128) f32
    # One 128-float row per leaf slot: 8 records of v0|e1|e2|n|front_only|
    # obj|pad2; NaN records are padding.
    leaf_rows: Any  # (L,128) f32
    leaf_map: Any  # (L*8,) i32: padded slot -> global triangle id
    # Two-phase treelet traversal: 1 on each treelet root, a wide node whose
    # subtree holds at most meta["treelet_size"] wide nodes under a parent
    # whose subtree holds more (meta["n_treelets"] of them).
    wide_troot: Any  # (W,) i32
    # The TOP walk's table (builder.py::top_table): the top level's rows
    # (the nodes reached from the root without entering a treelet root),
    # 64 floats each, a top-level child's code its row here, a treelet
    # root's T + its node id; (0,64) where the scene lies beyond the TOP
    # walk's limits.
    wide_top: Any  # (T,64) f32

    # Cluster route (accel/cluster.py): transposed Moller-Trumbore
    # coefficient pages per <= t_c-triangle cluster, the clusters' global
    # triangle range starts, the enumeration BVH8 over cluster AABBs (leaf
    # codes carry cluster ids), and the two-level box-enumeration pages
    # with the real triangles or boxes of each page (the kernels loop over
    # those alone).  meta: n_clusters, cluster_t_c, n_supers (0 = tables
    # not built; the arrays are then one-row placeholders, counts 0).
    clus_mt: Any  # (C,16,5*t_c) f32
    clus_start: Any  # (C,) i32
    clus_count: Any  # (C,) i32 triangles per cluster
    cwide_packed: Any  # (Wc,128) f32
    super_page: Any  # (16,6*128) f32
    super_page_count: Any  # (1,) i32 boxes on super_page: n_supers
    super_cpage: Any  # (S,16,6*128) f32
    super_cpage_count: Any  # (S,) i32 cluster boxes per super page
    super_cstart: Any  # (S,) i32 first cluster id per super

    # Rope-walk route (kernels/lanewalk.py): per direction octant, the
    # binary tree in that octant's preorder, one 8-float BOX row per node
    # (box | miss row as an f32 VALUE | leaf word, i32 bits: count << 24 |
    # first, the leaf's tri_packed rows; 0 on interior nodes).  meta:
    # rope_rows, the BOX rows per octant, one per binary node (0 = not
    # built; the array is then a one-row placeholder).
    rope_streams: Any  # (8,R,8) f32

    # NEE lights.
    light_corner: Any  # (L,3) f32
    light_edge_u: Any  # (L,3) f32
    light_edge_v: Any  # (L,3) f32
    light_normal: Any  # (L,3) f32
    light_area: Any  # (L,) f32
    light_mat: Any  # (L,) i32

    # Environment (packed like the push constants, raytrace.comp:92-97).
    env_horizon: Any  # (4,) f32: rgb + sun focus
    env_zenith: Any  # (4,) f32: rgb + sun intensity
    env_ground: Any  # (3,) f32
    env_light_dir: Any  # (4,) f32: xyz + enabled

    # Textures: padded stack (K,H,W,3) uint8 sRGB + per-texture (h,w).
    tex_data: Any  # (K,Hmax,Wmax,3) u8
    tex_size: Any  # (K,2) i32

    meta: dict = field(default_factory=dict)

    @classmethod
    def array_fields(cls) -> tuple:
        return tuple(f.name for f in dataclasses.fields(cls) if f.name != "meta")

    @classmethod
    def from_numpy(cls, arrays: dict, meta: dict,
                   device=None) -> "CompiledScene":
        """Scene from numpy arrays keyed by field name, as tensors on
        ``device`` (default: the CUDA device; see :func:`resolve_device`).

        ``arrays`` may be the JAX package's compiled scene fields: its
        rope streams (BOX and TRI rows, 16 floats each) are converted by
        :func:`rope_box_rows`, which sets ``meta["rope_rows"]`` to the BOX
        rows, and the page counts, narrow-walk roots (with the forest
        walk's world boxes) and TOP table it lacks are derived by
        :func:`page_counts`, :func:`narrow_root_meta` and
        ``builder.py::top_table``.
        """
        dev = resolve_device(device)
        arrays = {**page_counts(arrays, meta), **arrays}
        if "wide_top" not in arrays:
            from .builder import top_table_or_empty

            arrays["wide_top"] = top_table_or_empty(arrays["wide_packed"],
                                                    arrays["wide_troot"])
        if "obj_root_words" not in meta:
            meta = {**meta, **narrow_root_meta(arrays)}
        rope = np.asarray(arrays["rope_streams"])
        if not meta.get("rope_rows", 0):
            arrays["rope_streams"] = rope_placeholder()
        elif rope.shape[-1] != ROPE_BOX_FIELDS:
            arrays["rope_streams"], n_box = rope_box_rows(
                rope, meta["rope_rows"],
                np.asarray(arrays["tri_packed"]).shape[0])
            meta = {**meta, "rope_rows": n_box}
        return cls(
            meta=dict(meta),
            **{
                f: torch.from_numpy(np.array(arrays[f])).to(dev)
                for f in cls.array_fields()
            },
        )

    def to(self, device) -> "CompiledScene":
        """Copy of the scene with every array as a tensor on ``device``."""
        return CompiledScene(
            meta=dict(self.meta),
            **{
                f: torch.as_tensor(getattr(self, f)).to(device)
                for f in self.array_fields()
            },
        )

    @property
    def device(self) -> torch.device:
        return torch.as_tensor(self.wide_packed).device

    @functools.cached_property
    def forest_roots(self) -> tuple:
        """``(roots, words)``: (K,) i32 tensors on the scene's device, every
        instance's root node and the bits of its narrow-walk word, from
        ``meta["obj_roots"]`` and ``["obj_root_words"]`` (the forest
        walk's, ``kernels/packet.py::forest_traverse``).  Built on the host
        once per scene object, so a traversal reads nothing back; raises
        where a word is -1 (a tree beyond the word's limits) or a root is
        no node of ``bvh_packed``."""
        roots = [int(r) for r in self.meta["obj_roots"]]
        words = [int(w) for w in self.meta["obj_root_words"]]
        n_nodes = self.bvh_packed.shape[0]
        if len(words) != len(roots) or min(words, default=0) < 0:
            raise ValueError(
                "the forest's trees lie beyond the narrow walk's node word "
                "(kernels/packet.py::narrow_root_words)")
        if any(not 0 <= r < n_nodes for r in roots):
            raise ValueError(f"an instance root is no node of the "
                             f"{n_nodes}-node BVH: {roots}")
        bits = np.array(words, np.int64).astype(np.uint32).view(np.int32)
        return (torch.tensor(roots, dtype=torch.int32, device=self.device),
                torch.from_numpy(bits).to(self.device))

    @functools.cached_property
    def forest_cull(self) -> torch.Tensor:
        """The forest walk's cull on the scene's device: the chunk trees
        (``kernels/packet.py::forest_cull_trees``, (ceil(K/128) * 255, 8)
        f32) of every instance's world box, the rows of
        ``meta["forest_cull"]`` (``forest_cull_table``), which
        :meth:`from_numpy` builds from the host arrays.  Built on the host
        once per scene object, so a traversal reads nothing back; raises
        where the rows are not one per instance root."""
        from ..kernels.packet import forest_cull_trees

        rows = self.meta["forest_cull"]
        if len(rows) != len(self.meta["obj_roots"]):
            raise ValueError(
                f"meta['forest_cull'] holds {len(rows)} rows for "
                f"{len(self.meta['obj_roots'])} instances: rebuild it with "
                "scene.types.forest_cull_meta")
        trees = forest_cull_trees(np.array(rows, np.float32).reshape(-1, 8))
        return torch.from_numpy(trees).to(self.device)

    @functools.cached_property
    def forest_box(self):
        """The bin key's box on a forest (``integrator/shading.py::
        bin_box``): ``(minimum, extent)``, (3,) f32 tensors on the scene's
        device, the union of the instances' world boxes (the finite rows
        of ``meta["forest_cull"]``), the extent clamped to 1e-6 as a
        flattened scene's is.  Built on the host once per scene object;
        None where no instance's box is finite."""
        rows = np.array(self.meta["forest_cull"], np.float32).reshape(-1, 8)
        lo, hi = rows[:, 0:3], rows[:, 4:7]
        finite = np.isfinite(lo).all(1) & np.isfinite(hi).all(1)
        if not finite.any():
            return None
        mn = torch.from_numpy(lo[finite].min(0))
        extent = torch.clamp(torch.from_numpy(hi[finite].max(0)) - mn,
                             min=1e-6)
        return mn.to(self.device), extent.to(self.device)

    @property
    def n_spheres(self) -> int:
        return self.meta.get("n_spheres", 0)

    @property
    def n_objects(self) -> int:
        return self.meta.get("n_objects", 0)

    @property
    def n_lights(self) -> int:
        return self.meta.get("n_lights", 0)
