"""Scene description and compiled device-side scene tensors.

Host-side description objects mirror the reference's scene model
(``src/vk_engine.h:49-132``): spheres, materials, mesh instances with TRS
transforms, and a per-``usemtl``-group BVH forest.  ``CompiledScene`` is the
flat SoA table set uploaded to the device as torch tensors — the
replacement for the reference's nine storage-buffer bindings
(``shaders/raytrace.comp:120-148``).  The field layout is the JAX
package's (``ray_tracer_tpu/scene/types.py``), with the rope streams in a
row-major layout (:func:`rope_rows_layout`).
"""

from __future__ import annotations

import dataclasses
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


ROPE_FIELDS = 16  # floats per rope-stream row
ROPE_PAGE = 128  # rows per page of the JAX package's layout


def rope_rows_layout(streams: np.ndarray) -> np.ndarray:
    """The JAX package's page-major, field-major rope streams (8, n_pages,
    16*128) as this package's row-major (8, n_pages*128, 16) rows: field f
    of row r of page p sits at column f*128 + r there."""
    s = np.asarray(streams)
    n_oct, n_pages = s.shape[:2]
    return np.ascontiguousarray(
        s.reshape(n_oct, n_pages, ROPE_FIELDS, ROPE_PAGE)
        .transpose(0, 1, 3, 2)
        .reshape(n_oct, n_pages * ROPE_PAGE, ROPE_FIELDS)
    )


def rope_placeholder() -> np.ndarray:
    """The one-row ``rope_streams`` of a scene compiled without them."""
    return np.zeros((1, 1, ROPE_FIELDS), np.float32)


@dataclass
class CompiledScene:
    """Flat SoA tensors plus static ``meta``.

    ``SceneBuilder.compile()`` builds the fields as numpy arrays and hands
    them to :meth:`from_numpy`, which puts them on a device as torch
    tensors; :meth:`to` copies a scene to another device.  Integer ids
    stored in float rows are f32 *values*, never
    bitcasts, except ``bvh_packed`` columns 6-7 (index/count bitcast, as in
    the reference package).
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
    # binary tree in that octant's preorder as 16-float rows (interior ->
    # one BOX row, leaf -> a BOX row and its TRI rows), padded to a
    # multiple of 128 rows.  meta: rope_rows, the rows per octant (0 = not
    # built; the array is then a one-row placeholder).
    rope_streams: Any  # (8,R_pad,16) f32

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

        ``arrays`` may be the JAX package's compiled scene fields: rope
        streams in the JAX layout (16*128 columns) are converted by
        :func:`rope_rows_layout`, and the page counts it lacks are
        derived by :func:`page_counts`.
        """
        dev = resolve_device(device)
        arrays = {**page_counts(arrays, meta), **arrays}
        rope = np.asarray(arrays["rope_streams"])
        if not meta.get("rope_rows", 0):
            arrays["rope_streams"] = rope_placeholder()
        elif rope.shape[-1] == ROPE_FIELDS * ROPE_PAGE:
            arrays["rope_streams"] = rope_rows_layout(rope)
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

    @property
    def n_spheres(self) -> int:
        return self.meta.get("n_spheres", 0)

    @property
    def n_objects(self) -> int:
        return self.meta.get("n_objects", 0)

    @property
    def n_lights(self) -> int:
        return self.meta.get("n_lights", 0)
