"""SceneBuilder: the host-side scene compiler.

Replaces the reference's ``prepare_storage_buffers``/``read_obj``/``read_mtl``
pipeline (``src/vk_engine.cpp:638-1167``): meshes, materials, spheres, lights
and textures are flattened into the SoA arrays of :class:`CompiledScene`,
with one BVH per ``usemtl`` group (reference quirk Q11: a per-object BVH
*forest*, not a global BVH) and precomputed inverse transforms (fixing
reference quirk Q5, ``shaders/raytrace.comp:292-293``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..accel.bvh import build_forest
from ..kernels.bvh8 import TOP_CODE_LIMIT, TOP_STACK
from ..utils.transforms import trs_matrix
from . import mtlio, objio, textures
from .types import (
    Camera,
    CompiledScene,
    Environment,
    InstanceDesc,
    Material,
    RectLight,
    SphereDesc,
    narrow_root_meta,
    resolve_device,
    rope_placeholder,
)

TREELET_SIZE = 64  # most wide nodes in a treelet of two-phase traversal


def treelet_roots(wide_packed: np.ndarray) -> np.ndarray:
    """The (W,) i32 treelet-root flags of a BVH8: 1 on each wide node whose
    subtree holds at most ``TREELET_SIZE`` wide nodes and whose parent's
    subtree holds more.

    The JAX builder's reverse sweep, vectorized: a node's subtree size is
    the number of nodes it is an ancestor-or-self of, counted by walking
    every node up its parent chain one level per step."""
    n_wide = wide_packed.shape[0]
    codes = wide_packed[:, 6:64:8]
    empty = ~np.isfinite(wide_packed[:, 0:64:8])
    child = np.where(
        empty | (codes < 0) | ~np.isfinite(codes), -1,
        np.nan_to_num(codes, nan=-1.0),
    ).astype(np.int64)
    has = child >= 0
    parent = np.full(n_wide, -1, np.int64)
    parent[child[has]] = np.nonzero(has)[0]
    sizes = np.zeros(n_wide, np.int64)
    up = np.arange(n_wide)
    while up.size:
        sizes += np.bincount(up, minlength=n_wide)
        up = parent[up]
        up = up[up >= 0]
    small = sizes <= TREELET_SIZE
    troot = np.zeros(n_wide, np.int32)
    roots = has & ~small[:, None] & small[np.maximum(child, 0)]
    troot[child[roots]] = 1
    return troot


def top_table(wide_packed: np.ndarray, troot: np.ndarray) -> np.ndarray:
    """The TOP table of two-phase traversal, (T,64) f32: the rows of the
    top level, the wide nodes reached from the root without entering a
    treelet root (``troot``), the root first and the others in node order.

    Each row is the node's first 64 floats (8 child boxes, codes and the
    sort axis; the 128-float row's padding goes), its children's boxes
    copied bit for bit and their codes rewritten as f32 VALUES: a top-level
    child to its row in the table (below T), a treelet root to T + its node
    id, a leaf's (negative) code and an empty slot's 0 unchanged.  The TOP
    walk (``kernels/bvh8.py::top_walk_reference``, ``top_walk_kernel``)
    then tells a treelet root by its code alone.  Raises ``ValueError``
    where T + W reaches 2^24 (a code would not be exact in f32) or the top
    level has more levels than the walk's stack holds
    (``kernels/bvh8.py::TOP_STACK``)."""
    n_wide = wide_packed.shape[0]
    codes = wide_packed[:, 6:64:8]
    child = np.where(codes > 0, codes, 0).astype(np.int64)
    inner = (codes > 0) & (troot[child] == 0)  # top-level children
    depth = np.full(n_wide, -1, np.int64)
    depth[0] = 0
    level = np.zeros(1, np.int64)
    levels = 0
    while level.size:
        levels += 1
        if levels > min(n_wide, TOP_STACK):
            raise ValueError(
                f"the top level of two-phase traversal holds more than "
                f"{TOP_STACK} levels: the TOP walk's stack holds "
                f"{TOP_STACK} (kernels/bvh8.py TOP_STACK)")
        level = child[level][inner[level]]
        depth[level] = levels
    top_ids = np.nonzero(depth >= 0)[0]
    n_top = top_ids.size
    if n_top + n_wide >= TOP_CODE_LIMIT:
        raise ValueError(f"the TOP table's codes reach T + W = "
                         f"{n_top + n_wide}: at 2^24 or more they are not "
                         "exact in f32")
    row = np.full(n_wide, -1, np.int64)
    row[top_ids] = np.arange(n_top)
    table = np.ascontiguousarray(wide_packed[top_ids, :64], np.float32)
    c = codes[top_ids]
    ch = child[top_ids]
    new = np.where(inner[top_ids], row[ch], c)
    new = np.where((c > 0) & ~inner[top_ids], n_top + ch, new)
    table[:, 6:64:8] = new.astype(np.float32)
    return table


def top_table_or_empty(wide_packed, troot) -> np.ndarray:
    """:func:`top_table`, or a (0,64) table where the scene lies beyond
    its limits: the TOP walk's wrapper raises on it at use (as the narrow
    walk's root word of -1 does), and the scene's other routes run."""
    try:
        return top_table(np.asarray(wide_packed), np.asarray(troot))
    except ValueError:
        return np.zeros((0, 64), np.float32)


@dataclass
class _MeshGroupRef:
    """A parsed+cached usemtl group, pre-BVH."""

    positions: np.ndarray  # (T,3,3)
    normals: np.ndarray
    uvs: np.ndarray
    front_only: bool
    smooth: bool
    material_key: Optional[str]  # resolved mtl material key, or None


class SceneBuilder:
    def __init__(self) -> None:
        self.materials: List[Material] = []
        self.spheres: List[SphereDesc] = []
        self.lights: List[RectLight] = []
        self.instances: List[Tuple[int, InstanceDesc]] = []  # (group id, desc)
        self.environment = Environment()
        self.camera = Camera()
        self._groups: List[_MeshGroupRef] = []
        self._mesh_cache: Dict[str, List[int]] = {}  # obj path -> group ids
        self._mtl_materials: Dict[str, int] = {}  # "mtlpath/name" -> mat idx
        self._texture_paths: List[str] = []
        # add_obj call records, so save_scene can round-trip mesh instances
        # (InstanceDesc itself keeps only the baked 4x4 transform)
        self.obj_calls: List[Dict] = []

    # -- materials / primitives -------------------------------------------
    def add_material(self, mat: Material) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_texture(self, path: str) -> int:
        """Register an image and return its texture slot (for
        ``Material(albedo_tex=...)``) — the API form of the reference's
        interactive texture assignment (its shipped MTLs often omit the
        map_Kd the gallery renders clearly used, e.g. dread_alb.png)."""
        self._texture_paths.append(os.path.abspath(path))
        return len(self._texture_paths) - 1

    def add_sphere(self, position, radius: float, material: int) -> int:
        self.spheres.append(SphereDesc(tuple(position), float(radius), int(material)))
        return len(self.spheres) - 1

    def add_rect_light(
        self, corner, edge_u, edge_v, normal, material: int
    ) -> int:
        self.lights.append(
            RectLight(tuple(corner), tuple(edge_u), tuple(edge_v), tuple(normal), material)
        )
        return len(self.lights) - 1

    # -- meshes -------------------------------------------------------------
    def add_obj(
        self,
        path: str,
        material: int = 0,
        position=(0.0, 0.0, 0.0),
        rotation_deg=(0.0, 0.0, 0.0),
        scale=(1.0, 1.0, 1.0),
        front_only: bool = False,
        sampler: int = 0,
        name: str = "",
    ) -> None:
        """Load (or reuse, reference ``vk_engine.cpp:802-815``) an OBJ and add
        one instance per usemtl group with the given TRS transform."""
        path = os.path.abspath(path)
        if np.isscalar(scale):
            scale = (scale, scale, scale)
        self.obj_calls.append(
            dict(
                path=path,
                material=int(material),
                position=tuple(position),
                rotation_deg=tuple(rotation_deg),
                scale=tuple(scale),
                front_only=bool(front_only),
                sampler=int(sampler),
                name=name,
            )
        )
        if path not in self._mesh_cache:
            mesh = objio.parse_obj(path)
            if mesh.mtl_path and os.path.exists(mesh.mtl_path):
                self._ingest_mtl(mesh.mtl_path)
            group_ids = []
            for g in mesh.groups:
                key = None
                if g.material is not None and mesh.mtl_path:
                    key = mesh.mtl_path + "/" + g.material
                self._groups.append(
                    _MeshGroupRef(
                        positions=g.positions,
                        normals=g.normals,
                        uvs=g.uvs,
                        front_only=front_only,
                        smooth=g.smooth,
                        material_key=key,
                    )
                )
                group_ids.append(len(self._groups) - 1)
            self._mesh_cache[path] = group_ids

        transform = trs_matrix(position, rotation_deg, scale)
        for gid in self._mesh_cache[path]:
            grp = self._groups[gid]
            mat = (
                self._mtl_materials[grp.material_key]
                if grp.material_key in self._mtl_materials
                else int(material)
            )
            self.instances.append(
                (
                    gid,
                    InstanceDesc(
                        transform=transform,
                        bvh_root=-1,  # filled at compile
                        material=mat,
                        smooth_shade=grp.smooth,
                        sampler=int(sampler),
                        name=name or os.path.basename(path),
                    ),
                )
            )

    def _ingest_mtl(self, mtl_path: str) -> None:
        lib = mtlio.parse_mtl(mtl_path)
        tex_base = len(self._texture_paths)
        self._texture_paths.extend(lib.texture_paths)
        for mname, mat in lib.materials.items():
            key = mtl_path + "/" + mname
            if key in self._mtl_materials:
                continue
            for attr in ("albedo_tex", "metalness_tex", "alpha_tex", "bump_tex"):
                v = getattr(mat, attr)
                if v >= 0:
                    setattr(mat, attr, v + tex_base)
            self._mtl_materials[key] = self.add_material(mat)

    # -- environment / camera ----------------------------------------------
    def set_environment(self, env: Environment) -> None:
        self.environment = env

    def set_camera(self, cam: Camera) -> None:
        self.camera = cam

    # -- compile -------------------------------------------------------------
    def compile(
        self,
        max_leaf_tris: int = None,
        flatten_instances: bool = True,
        merge_wide_leaves: bool = None,
        spatial_splits: bool = None,
        cluster_t_c: int = None,
        clusters: bool = None,
        rope_streams: bool = False,
        device=None,
    ) -> CompiledScene:
        """Flatten to device tensors, on ``device`` (default: the CUDA
        device; with none present this raises, so CPU runs pass
        ``device="cpu"``).

        ``flatten_instances=True`` (default) bakes every instance's triangles
        into *world space* and builds ONE global BVH: a single stackless walk
        replaces the reference's per-object BVH forest loop (quirk Q11,
        ``raytrace.comp:289-350``) and all per-ray transforms.  Radiometry is
        unchanged — world-space Moller-Trumbore yields the same parametric t,
        and normals/materials are baked per triangle.  Set False to keep the
        reference's forest layout (tris stored once per mesh, transforms at
        traversal time) when instancing-heavy scenes make duplication too
        costly.

        ``spatial_splits``: SBVH spatial splits in the flattened scene's
        tree; None (default) builds them unless ``RT_SBVH=0``, as the JAX
        builder does.

        ``merge_wide_leaves``: None (auto) packs sibling leaves of 8-record
        scenes into shared single rows; True packs them into 16-record
        two-row slots, which only the packet walk reads (the traversal then
        routes there); False keeps one row per leaf.

        ``clusters`` / ``cluster_t_c``: build the cluster route's tables
        (``accel/cluster.py``) with clusters of at most ``cluster_t_c``
        triangles (default 128).  By default none are built; an explicit
        ``cluster_t_c`` opts in.  A scene the tables cannot represent
        (:class:`~ray_tracer_tpu_torch.accel.cluster.ClusterCapacityError`)
        gets none, unless ``clusters=True`` forced them: then it raises.

        ``rope_streams``: build the rope-walk route's per-octant BOX-row
        streams (``kernels/lanewalk.py``; flattened triangle scenes only).
        Off by default: 8 streams of one 32 B row per node (25 MB for
        ``sponza_proxy()``) that only ``Routing(lanewalk="force")`` reads.
        The JAX package builds its own (BOX and TRI rows) unless
        ``RT_ROPE_BUILD=0``.

        The treelet-root table ``wide_troot`` of two-phase traversal is
        always built (:func:`treelet_roots`).
        """
        from . import validate as _validate

        dev = resolve_device(device)
        _validate.validate(self)  # loud, actionable errors (VK_CHECK-style)

        f32 = np.float32
        i32 = np.int32
        clusters_forced = clusters is True
        if clusters is None:
            clusters = cluster_t_c is not None
        if cluster_t_c is None:
            cluster_t_c = 128
        if max_leaf_tris is None:
            # Fatter leaves on big scenes shrink the node table at trivial
            # dense-test cost.
            n_total = sum(
                self._groups[gid].positions.shape[0]
                for gid, _ in self.instances
            )
            max_leaf_tris = 8 if n_total > 120_000 else 4

        # ---- triangles
        if self._groups and flatten_instances:
            pos_l, nrm_l, uv_l, fo_l, obj_l = [], [], [], [], []
            for k, (gid, inst) in enumerate(self.instances):
                g = self._groups[gid]
                m = inst.transform
                p = g.positions @ m[:3, :3].T + m[:3, 3]
                # reference normal transform is M (not inverse-transpose),
                # applied after interpolation; baking M per-vertex is
                # identical by linearity (quirk in _gather_hit_attrs).
                nrm = g.normals @ m[:3, :3].T
                uv = g.uvs
                if np.linalg.det(m[:3, :3]) < 0:
                    # mirror transform: swap winding so front-face tests
                    # match the reference's object-space result
                    p = p[:, [0, 2, 1]]
                    nrm = nrm[:, [0, 2, 1]]
                    uv = uv[:, [0, 2, 1]]
                pos_l.append(p.astype(f32))
                nrm_l.append(nrm.astype(f32))
                uv_l.append(uv)
                fo_l.append(np.full(p.shape[0], g.front_only, bool))
                obj_l.append(np.full(p.shape[0], k, i32))
            positions = np.concatenate(pos_l)
            normals = np.concatenate(nrm_l)
            uvs = np.concatenate(uv_l)
            front_only = np.concatenate(fo_l)
            tri_obj = np.concatenate(obj_l)
            # SBVH by default on the flattened production path: spatial
            # splits shrink node overlap and so the traversal's visits.
            if spatial_splits is None:
                spatial_splits = os.environ.get("RT_SBVH", "1") != "0"
            forest, perm = build_forest(
                positions, [(0, positions.shape[0])], max_leaf_tris,
                spatial=spatial_splits,
            )
            positions = positions[perm]
            normals = normals[perm]
            uvs = uvs[perm]
            front_only = front_only[perm]
            tri_obj = tri_obj[perm]
        elif self._groups:
            positions = np.concatenate([g.positions for g in self._groups])
            normals = np.concatenate([g.normals for g in self._groups])
            uvs = np.concatenate([g.uvs for g in self._groups])
            front_only = np.concatenate(
                [
                    np.full(g.positions.shape[0], g.front_only, bool)
                    for g in self._groups
                ]
            )
            offsets = np.cumsum([0] + [g.positions.shape[0] for g in self._groups])
            group_ranges = [
                (int(offsets[i]), int(offsets[i + 1] - offsets[i]))
                for i in range(len(self._groups))
            ]
            forest, perm = build_forest(positions, group_ranges, max_leaf_tris)
            positions = positions[perm]
            normals = normals[perm]
            uvs = uvs[perm]
            front_only = front_only[perm]
            tri_obj = np.zeros(positions.shape[0], i32)
        else:
            positions = np.zeros((1, 3, 3), f32)
            normals = np.zeros((1, 3, 3), f32)
            uvs = np.zeros((1, 3, 2), f32)
            front_only = np.zeros(1, bool)
            tri_obj = np.zeros(1, i32)
            forest, _ = build_forest(
                positions, [(0, 1)], max_leaf_tris
            )  # degenerate 1-node tree keeps shapes non-empty
        flattened = bool(self._groups) and flatten_instances

        tri_v0 = positions[:, 0]
        tri_e1 = positions[:, 1] - positions[:, 0]  # v1v0, raytrace.comp:229
        tri_e2 = positions[:, 2] - positions[:, 0]
        tri_n = np.cross(tri_e1, tri_e2).astype(f32)

        # ---- instances
        n_obj = len(self.instances)
        obj_transform = np.tile(np.eye(4, dtype=f32), (max(n_obj, 1), 1, 1))
        obj_root = np.zeros(max(n_obj, 1), i32)
        obj_mat = np.zeros(max(n_obj, 1), i32)
        obj_smooth = np.zeros(max(n_obj, 1), bool)
        obj_sampler = np.zeros(max(n_obj, 1), i32)
        for k, (gid, inst) in enumerate(self.instances):
            obj_transform[k] = inst.transform
            obj_root[k] = (
                forest.roots[0 if flattened else gid] if self._groups else 0
            )
            obj_mat[k] = inst.material
            obj_smooth[k] = inst.smooth_shade
            obj_sampler[k] = inst.sampler
        obj_inv = np.linalg.inv(obj_transform).astype(f32)
        if flattened:
            # triangles are world-space; attribute interpolation and normal
            # transforms must see identity matrices
            obj_transform = np.tile(np.eye(4, dtype=f32), (max(n_obj, 1), 1, 1))
            obj_inv = obj_transform.copy()

        # ---- materials
        mats = self.materials or [Material()]
        m = len(mats)

        def mf(attr, shape=()):
            return np.asarray([getattr(x, attr) for x in mats], f32).reshape(
                (m,) + shape
            )

        def mi(attr):
            return np.asarray([getattr(x, attr) for x in mats], i32)

        # ---- spheres
        n_sph = len(self.spheres)
        sph_pos = np.zeros((max(n_sph, 1), 3), f32)
        sph_rad = np.zeros(max(n_sph, 1), f32)
        sph_mat = np.zeros(max(n_sph, 1), i32)
        for k, s in enumerate(self.spheres):
            sph_pos[k] = s.position
            sph_rad[k] = s.radius
            sph_mat[k] = s.material

        # ---- lights
        n_li = len(self.lights)
        li_corner = np.zeros((max(n_li, 1), 3), f32)
        li_u = np.zeros((max(n_li, 1), 3), f32)
        li_v = np.zeros((max(n_li, 1), 3), f32)
        li_n = np.tile(np.array([0, -1, 0], f32), (max(n_li, 1), 1))
        li_area = np.ones(max(n_li, 1), f32)
        li_mat = np.zeros(max(n_li, 1), i32)
        for k, l in enumerate(self.lights):
            li_corner[k] = l.corner
            li_u[k] = l.edge_u
            li_v[k] = l.edge_v
            li_n[k] = l.normal
            li_area[k] = l.area
            li_mat[k] = l.material

        # ---- environment
        env = self.environment
        env_horizon = np.asarray(list(env.horizon_color) + [env.sun_focus], f32)
        env_zenith = np.asarray(list(env.zenith_color) + [env.sun_intensity], f32)
        env_ground = np.asarray(env.ground_color, f32)
        env_light_dir = np.asarray(
            list(env.light_dir) + [1.0 if env.enabled else 0.0], f32
        )

        tex_data, tex_size = textures.stack_textures(self._texture_paths)

        # ---- packed hot-path mirrors (one gather row per record)
        n_nodes = forest.index.shape[0]
        bvh_packed = np.zeros((n_nodes, 8), f32)
        bvh_packed[:, 0:3] = forest.node_min
        bvh_packed[:, 3:6] = forest.node_max
        bvh_packed[:, 6] = forest.index.view(f32)
        bvh_packed[:, 7] = forest.tri_count.view(f32)
        links_packed = np.stack(
            [forest.hit_link.reshape(-1), forest.miss_link.reshape(-1)], axis=1
        ).astype(i32)
        n_tris = positions.shape[0]
        tri_packed = np.zeros((n_tris, 16), f32)
        tri_packed[:, 0:3] = positions[:, 0]
        tri_packed[:, 3:6] = positions[:, 1] - positions[:, 0]
        tri_packed[:, 6:9] = positions[:, 2] - positions[:, 0]
        tri_packed[:, 9:12] = np.cross(
            tri_packed[:, 3:6], tri_packed[:, 6:9]
        )
        tri_packed[:, 12] = front_only.astype(f32)
        tri_packed[:, 13] = tri_obj.astype(i32).view(f32)

        # Packed shade row: ONE hot-path gather per hit instead of separate
        # tri_vn + tri_uv gathers; the degenerate-uv flag
        # (raytrace.comp:254-256) is per-triangle and precomputed.
        tri_shade = np.zeros((n_tris, 16), f32)
        tri_shade[:, 0:9] = normals.reshape(n_tris, 9)
        tri_shade[:, 9:15] = uvs.reshape(n_tris, 6)
        degen = (
            np.all(uvs[:, 0] == uvs[:, 1], axis=-1)
            | np.all(uvs[:, 1] == uvs[:, 2], axis=-1)
            | np.all(uvs[:, 2] == uvs[:, 0], axis=-1)
        )
        tri_shade[:, 15] = degen.astype(f32)

        # Fat shading row: EVERYTHING a bounce's shading stage needs in ONE
        # row gather (the material and instance tables folded in).
        # Layout: 0-8 vn | 9-14 uv | 15 degen | 16-18 albedo |
        # 19-21 emission*strength | 22 reflectance | 23 ior |
        # 24 albedo_tex | 25 sampler | 26 material id | 27 instance id |
        # 28 global tri id | 29 metalness_tex | 30 alpha_tex | 31 pad |
        # 32-43 the triangle geometry record (v0, e1, e2, n_geo — the
        # same values the kernel's leaf records hold), so the shading
        # stage can RE-DERIVE u/v/facing for the winning record from this
        # one gather and the traversal kernel never has to produce them
        # | 44-47 pad.
        # Ints are held as f32 VALUES (exact below 2^24).
        mat_albedo_arr = mf("albedo", (3,))
        mat_emis_arr = mf("emission_color", (3,)) * mf("emission_strength")[:, None]
        tmat = obj_mat[tri_obj] if n_tris else np.zeros(1, i32)
        shade_tri = np.zeros((max(n_tris, 1), 48), f32)
        shade_tri[:, 0:16] = tri_shade[:, 0:16] if n_tris else 0.0
        shade_tri[:, 16:19] = mat_albedo_arr[tmat]
        shade_tri[:, 19:22] = mat_emis_arr[tmat]
        shade_tri[:, 22] = mf("reflectance")[tmat]
        shade_tri[:, 23] = mf("ior")[tmat]
        shade_tri[:, 24] = mi("albedo_tex")[tmat].astype(f32)
        shade_tri[:, 25] = obj_sampler[tri_obj].astype(f32) if n_tris else 0.0
        shade_tri[:, 26] = tmat.astype(f32)
        shade_tri[:, 27] = tri_obj.astype(f32) if n_tris else 0.0
        shade_tri[:, 28] = np.arange(max(n_tris, 1), dtype=f32)
        shade_tri[:, 29] = mi("metalness_tex")[tmat].astype(f32)
        shade_tri[:, 30] = mi("alpha_tex")[tmat].astype(f32)
        shade_tri[:, 31] = mi("bump_tex")[tmat].astype(f32)
        if n_tris:
            shade_tri[:, 32:44] = tri_packed[:, 0:12]

        # BVH8 for the traversal kernel (single-tree scenes only)
        if flattened:
            from ..accel.wide import collapse

            wide_bvh = collapse(forest, forest.roots[0])
            wide_meta = wide_bvh.meta
            n_wide = wide_bvh.n_wide
            # Merged-leaf mode: sibling leaf children of a wide node are
            # greedily packed (in sorted-slot order, so groups stay
            # spatially adjacent) into shared rows whose box is the union
            # of the parts.  Dense-test ids stay slot*8+k, also in the
            # 16-record TWO-row variant (``True``), whose records k >= 8
            # sit in row slot+1 at k-8.
            if merge_wide_leaves is None:
                # Auto: single-row sibling merge on 8-record scenes — packs
                # partial sibling leaves into full shared rows, cutting
                # leaf VISITS at zero per-visit cost (same 8-record test,
                # same one-row load).  4-record scenes keep the reference
                # package's unmerged layout.
                merge_wide_leaves = "8" if max_leaf_tris > 4 else False
            rec_cap = 16 if merge_wide_leaves is True else 8
            wide_leaf_recs = rec_cap if merge_wide_leaves else (
                4 if max_leaf_tris <= 4 else 8
            )
            leaf_rows_list = []
            leaf_map_list = []
            if merge_wide_leaves:
                boxes8 = wide_bvh.boxes.reshape(n_wide, 8, 8)
                slot_meta = wide_meta[:-1].reshape(n_wide, 8, 4)
                new_boxes = np.full((n_wide, 8, 8), np.nan, f32)
                new_codes = np.zeros((n_wide, 8), f32)
                for w in range(n_wide):
                    children = []  # (box(8,), code f32)
                    group = []  # (start, cnt, box) accumulated leaves
                    gcnt = 0

                    def flush():
                        nonlocal gcnt
                        if not group:
                            return
                        # slot is the FIRST ROW index (the kernel decodes
                        # (-code-1)//16 and loads rows_per_slot rows at it;
                        # leaf_map[slot*8+k] stays aligned in both layouts)
                        slot = len(leaf_rows_list)
                        block = np.full((rec_cap, 16), np.nan, f32)
                        ids = np.zeros(rec_cap, i32)
                        box = group[0][2].copy()
                        off = 0
                        for st, c, bx in group:
                            block[off : off + c] = tri_packed[st : st + c]
                            ids[off : off + c] = np.arange(
                                st, st + c, dtype=i32
                            )
                            box[0:3] = np.minimum(box[0:3], bx[0:3])
                            box[3:6] = np.maximum(box[3:6], bx[3:6])
                            off += c
                        for r in range(rec_cap // 8):
                            leaf_rows_list.append(
                                block[8 * r : 8 * r + 8].reshape(128)
                            )
                        leaf_map_list.append(ids)
                        # payload cnt: the records packed into the slot.
                        # The walks (csrc/bvh8_walk.cu) test only that
                        # many; capped at 15 to keep the slot field
                        # unambiguous, so on a two-row slot they read 15
                        # as 15 or 16
                        children.append(
                            (box, f32(-(slot * 16 + min(off, 15)) - 1))
                        )
                        group.clear()
                        gcnt = 0

                    for c in range(8):
                        box = boxes8[w, c]
                        if not np.isfinite(box[0]):
                            continue  # empty slot
                        cnt = int(slot_meta[w, c, 1])
                        if cnt > 0:
                            if gcnt + cnt > rec_cap:
                                flush()
                            group.append(
                                (int(slot_meta[w, c, 0]), cnt, box)
                            )
                            gcnt += cnt
                        else:
                            children.append(
                                (box, f32(slot_meta[w, c, 0]))
                            )
                    flush()
                    # restore ascending order along the node's sort axis
                    ax = int(wide_bvh.axis[w])
                    children.sort(
                        key=lambda t: float(t[0][ax] + t[0][3 + ax])
                    )
                    for c, (bx, code) in enumerate(children):
                        new_boxes[w, c] = bx
                        new_codes[w, c] = code
                wide_packed = np.zeros((n_wide, 128), f32)
                wide_packed[:, :64] = new_boxes.reshape(n_wide, 64)
                wide_packed[:, 6:64:8] = new_codes
                wide_packed[:, 7] = wide_bvh.axis.astype(f32)
            else:
                # Leaf-slot layout: one 128-float (8-tri) row per leaf so
                # the kernel reads/DMAs aligned full rows.  Padding slots
                # carry NaN v0 (every intersection test fails on NaN).
                for row in range(wide_meta.shape[0] - 1):
                    cnt = int(wide_meta[row, 1])
                    if cnt > 0:
                        start = int(wide_meta[row, 0])
                        slot = len(leaf_rows_list)
                        block = np.full((8, 16), np.nan, f32)
                        block[:cnt] = tri_packed[start : start + cnt]
                        leaf_rows_list.append(block.reshape(128))
                        ids = np.zeros(8, i32)
                        ids[:cnt] = np.arange(start, start + cnt, dtype=i32)
                        leaf_map_list.append(ids)
                        wide_meta[row, 3] = slot
                # One (W,128) row per wide node (512 B, read as float4s by
                # the kernel): per child c lanes 8c..8c+5 = min/max, lane 8c+6 =
                # traversal code held as an f32 VALUE (>=0 wide id; <0
                # leaf with payload -(slot*16 + cnt) - 1), lane 7 =
                # child-sort axis.  Empty slots keep NaN boxes (never hit).
                wide_packed = np.zeros((n_wide, 128), f32)
                wide_packed[:, :64] = wide_bvh.boxes.reshape(n_wide, 64)
                slot_meta = wide_meta[:-1].reshape(n_wide, 8, 4)
                codes = np.where(
                    slot_meta[:, :, 1] > 0,
                    -(slot_meta[:, :, 3] * 16 + slot_meta[:, :, 1]) - 1,
                    slot_meta[:, :, 0],
                ).astype(f32)
                wide_packed[:, 6:64:8] = codes
                wide_packed[:, 7] = wide_bvh.axis.astype(f32)
            leaf_rows = (
                np.stack(leaf_rows_list)
                if leaf_rows_list
                else np.full((1, 128), np.nan, f32)
            )
            leaf_map = (
                np.concatenate(leaf_map_list)
                if leaf_map_list
                else np.zeros(8, i32)
            )
            wide_troot = treelet_roots(wide_packed)
            ct = None
            if clusters:
                from ..accel.cluster import (
                    ClusterCapacityError,
                    build_cluster_tables,
                )

                try:
                    ct = build_cluster_tables(
                        forest, forest.roots[0], tri_packed, t_c=cluster_t_c
                    )
                except ClusterCapacityError:
                    if clusters_forced:
                        raise
        else:
            wide_packed = np.full((1, 128), np.nan, f32)
            wide_packed[:, 6:64:8] = 0.0
            wide_packed[:, 7] = 0.0
            leaf_rows = np.full((1, 128), np.nan, f32)
            leaf_map = np.zeros(8, i32)
            wide_leaf_recs = 4 if max_leaf_tris <= 4 else 8
            wide_troot = np.zeros(1, i32)
            ct = None
        if ct is not None:
            cluster_arrays = dict(
                clus_mt=ct.clus_mt, clus_start=ct.clus_start,
                clus_count=ct.clus_count, cwide_packed=ct.cwide_packed,
                super_page=ct.super_page,
                super_page_count=np.array([ct.n_supers], i32),
                super_cpage=ct.super_cpage,
                super_cpage_count=ct.super_cpage_count,
                super_cstart=ct.super_cstart,
            )
            n_clusters, n_supers = int(ct.clus_start.shape[0]), ct.n_supers
        else:  # one-row placeholders, as the JAX package's
            cwide = np.full((1, 128), np.nan, f32)
            cwide[:, 6:64:8] = 0.0
            cwide[:, 7] = 0.0
            cluster_arrays = dict(
                clus_mt=np.zeros((1, 16, 5 * cluster_t_c), f32),
                clus_start=np.zeros(1, i32), clus_count=np.zeros(1, i32),
                cwide_packed=cwide,
                super_page=np.full((16, 6 * 128), np.nan, f32),
                super_page_count=np.zeros(1, i32),
                super_cpage=np.full((1, 16, 6 * 128), np.nan, f32),
                super_cpage_count=np.zeros(1, i32),
                super_cstart=np.zeros(1, i32),
            )
            n_clusters, n_supers = 0, 0

        rope_rows = 0
        rope = rope_placeholder()
        if rope_streams and flattened and n_tris:
            from ..kernels.lanewalk import build_rope_streams

            rope, rope_rows = build_rope_streams(
                forest.node_min, forest.node_max, forest.index,
                forest.tri_count, forest.hit_link, forest.miss_link,
                tri_packed.shape[0],
            )

        # Slot-space mirror of the fat shading rows: indexed directly by the
        # wide packet kernel's padded leaf-slot ids (slot*8 + k), removing
        # the per-lane leaf_map indirection gather from the hot path.
        shade_slot = shade_tri[leaf_map]

        return CompiledScene.from_numpy(dict(
            sphere_pos=sph_pos,
            sphere_radius=sph_rad,
            sphere_mat=sph_mat,
            mat_albedo=mf("albedo", (3,)),
            mat_emission=mf("emission_color", (3,)),
            mat_emission_strength=mf("emission_strength"),
            mat_reflectance=mf("reflectance"),
            mat_ior=mf("ior"),
            mat_albedo_tex=mi("albedo_tex"),
            mat_metalness_tex=mi("metalness_tex"),
            mat_alpha_tex=mi("alpha_tex"),
            mat_bump_tex=mi("bump_tex"),
            tri_v0=tri_v0.astype(f32),
            tri_e1=tri_e1.astype(f32),
            tri_e2=tri_e2.astype(f32),
            tri_n=tri_n,
            tri_front_only=front_only,
            tri_obj=tri_obj,
            tri_vn=normals.astype(f32),
            tri_uv=uvs.astype(f32),
            tri_shade=tri_shade,
            shade_tri=shade_tri,
            shade_slot=shade_slot,
            obj_transform=obj_transform,
            obj_inv_transform=obj_inv,
            obj_bvh_root=obj_root,
            obj_mat=obj_mat,
            obj_smooth=obj_smooth,
            obj_sampler=obj_sampler,
            bvh_min=forest.node_min,
            bvh_max=forest.node_max,
            bvh_index=forest.index,
            bvh_tri_count=forest.tri_count,
            bvh_axis=forest.axis.astype(np.int32),
            bvh_hit_link=forest.hit_link,
            bvh_miss_link=forest.miss_link,
            bvh_packed=bvh_packed,
            links_packed=links_packed,
            tri_packed=tri_packed,
            wide_packed=wide_packed,
            leaf_rows=leaf_rows,
            leaf_map=leaf_map,
            wide_troot=wide_troot,
            wide_top=top_table_or_empty(wide_packed, wide_troot),
            **cluster_arrays,
            rope_streams=rope,
            light_corner=li_corner,
            light_edge_u=li_u,
            light_edge_v=li_v,
            light_normal=li_n,
            light_area=li_area,
            light_mat=li_mat,
            env_horizon=env_horizon,
            env_zenith=env_zenith,
            env_ground=env_ground,
            env_light_dir=env_light_dir,
            tex_data=tex_data,
            tex_size=tex_size,
        ), meta={
                "n_spheres": n_sph,
                "n_objects": n_obj,
                "n_lights": n_li,
                "n_materials": m,
                "n_textures": len(self._texture_paths),
                "n_metalness_maps": int(sum(m.metalness_tex >= 0 for m in mats)),
                "n_alpha_maps": int(sum(m.alpha_tex >= 0 for m in mats)),
                "n_bump_maps": int(sum(m.bump_tex >= 0 for m in mats)),
                "n_tris": int(positions.shape[0]) if self._groups else 0,
                "max_leaf_tris": forest.max_leaf_tris,
                "wide_leaf_recs": wide_leaf_recs,
                "flattened": flattened,
                "n_clusters": n_clusters,
                "cluster_t_c": cluster_t_c,
                "n_supers": n_supers,
                "rope_rows": int(rope_rows),
                "treelet_size": TREELET_SIZE,
                "n_treelets": int(wide_troot.sum()) if flattened else 0,
                "bvh_max_depth": forest.max_depth_seen,
                **narrow_root_meta(dict(obj_bvh_root=obj_root,
                                        bvh_packed=bvh_packed,
                                        bvh_axis=forest.axis,
                                        obj_inv_transform=obj_inv)),
                "camera": (
                    tuple(self.camera.position),
                    tuple(self.camera.angles_deg),
                    float(self.camera.fov),
                    float(self.camera.near_plane),
                ),
            }, device=dev)
