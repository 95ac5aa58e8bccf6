"""A generated scene as plain data: meshes, their instances, materials, rect
lights, the sky and the camera.

The benchmark hands one :class:`SceneSpec` to both sides: the program under
test builds it through its own scene builder (``rt_bench/port_scene.py``),
and the plain reference (``rt_bench/reference/``) flattens it itself.  This
module imports neither.

Meshes travel as OBJ text with six decimals, the format the generators
have always written; :meth:`Mesh.positions` reads the numbers back the way
an OBJ loader does (Python's ``float`` of the text, narrowed to float32).

:func:`usemtl_groups` lays a generated scene out as an OBJ file of it
loads: every instance's triangles written in world space, one mesh for
each group of parts under one material (an OBJ's ``usemtl`` group), each
placed once with no transform.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Mesh:
    verts: List[Tuple[float, float, float]]  # or an (n,3) array
    faces: List[Tuple[int, int, int]]  # 1-based, as in OBJ; or (m,3)

    def _coords(self) -> str:
        v = np.asarray(self.verts, np.float64).ravel().tolist()
        return ("%.6f " * len(v)) % tuple(v)

    def obj_text(self) -> str:
        f = np.asarray(self.faces, np.int64).ravel().tolist()
        words = self._coords().split()
        return (("v %s %s %s\n" * (len(words) // 3)) % tuple(words)
                + ("f %d %d %d\n" * (len(f) // 3)) % tuple(f))

    def positions(self) -> np.ndarray:
        """(T,3,3) float32 corner positions, parsed back from the text."""
        v = np.fromiter(map(float, self._coords().split()), np.float64)
        v = v.reshape(-1, 3).astype(np.float32)
        return v[np.asarray(self.faces, np.int64) - 1]

    @property
    def n_tris(self) -> int:
        return len(self.faces)


@dataclass
class Instance:
    mesh: str
    material: int
    position: Tuple[float, float, float]
    rotation_deg: Tuple[float, float, float]
    scale: Tuple[float, float, float]
    front_only: bool = False
    name: str = ""
    group: str = ""  # the usemtl group the part belongs to


@dataclass
class SceneSpec:
    materials: List[dict]  # albedo, emission_color, emission_strength,
    # reflectance, ior, name
    meshes: Dict[str, Mesh]
    instances: List[Instance]
    rect_lights: List[dict]  # corner, edge_u, edge_v, normal, material
    environment: dict  # horizon_color, sun_focus, zenith_color,
    # sun_intensity, ground_color, light_dir, enabled
    camera: dict  # position, angles_deg, fov, near_plane
    meta: dict = field(default_factory=dict)

    @property
    def n_tris(self) -> int:
        return sum(self.meshes[i.mesh].n_tris for i in self.instances)


# The defaults of the scene types the generators leave unset (the
# reference renderer's ``RayMaterial``, ``EnvironmentData`` and
# ``CameraInfo``).
MATERIAL_DEFAULTS = dict(albedo=(1.0, 1.0, 1.0), emission_color=(0.0, 0.0, 0.0),
                         emission_strength=0.0, reflectance=0.0, ior=-1.0,
                         name="")
ENVIRONMENT_DEFAULTS = dict(
    horizon_color=(0.986, 1.0, 0.902), sun_focus=1000.0,
    zenith_color=(0.265, 0.595, 0.887), sun_intensity=10.0,
    ground_color=(0.431, 0.431, 0.431),
    light_dir=(0.5144958, 0.2057983, -0.7717437), enabled=False)
CAMERA_DEFAULTS = dict(position=(0.0, -0.5, -3.5), angles_deg=(4.0, 0.0, 0.0),
                       fov=50.0, near_plane=0.1)


def material(**kw) -> dict:
    return {**MATERIAL_DEFAULTS, **kw}


def rot_x(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def rot_y(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def rot_z(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


def trs_matrix(position, rotation_deg, scale) -> np.ndarray:
    """4x4 float32 ``T * Rx * Ry * Rz * S`` (the reference renderer's
    instance transform), angles in degrees."""
    rx, ry, rz = np.radians(np.asarray(rotation_deg, dtype=np.float64))
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (rot_x(rx) @ rot_y(ry) @ rot_z(rz)) * np.asarray(
        scale, dtype=np.float32)[None, :]
    m[:3, 3] = np.asarray(position, dtype=np.float32)
    return m


def usemtl_groups(spec: SceneSpec) -> SceneSpec:
    """The scene as an OBJ of it loads: for each ``Instance.group``, in the
    order the groups first appear, one mesh of its parts' triangles in
    world space (the vertices through the part's transform, a mirrored
    part's faces rewound) and one instance of it with no transform.  The
    parts of a group share its material and ``front_only``."""
    order, parts = [], {}
    for inst in spec.instances:
        if inst.group not in parts:
            order.append(inst.group)
            parts[inst.group] = []
        parts[inst.group].append(inst)
    meshes, instances = {}, []
    for g in order:
        verts, faces, base = [], [], 0
        for inst in parts[g]:
            mesh = spec.meshes[inst.mesh]
            m = trs_matrix(inst.position, inst.rotation_deg, inst.scale)
            v = np.asarray(mesh.verts, np.float64)
            verts.append(v @ m[:3, :3].T.astype(np.float64)
                         + m[:3, 3].astype(np.float64))
            f = np.asarray(mesh.faces, np.int64)
            if np.linalg.det(m[:3, :3]) < 0:
                f = f[:, [0, 2, 1]]
            faces.append(f + base)
            base += v.shape[0]
        first = parts[g][0]
        if any((i.material, i.front_only) != (first.material,
                                              first.front_only)
               for i in parts[g]):
            raise ValueError(f"group {g!r} mixes materials or faces")
        meshes[g] = Mesh(np.concatenate(verts), np.concatenate(faces))
        instances.append(Instance(g, first.material, (0.0, 0.0, 0.0),
                                  (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                  front_only=first.front_only, name=g,
                                  group=g))
    return SceneSpec(materials=spec.materials, meshes=meshes,
                     instances=instances, rect_lights=spec.rect_lights,
                     environment=spec.environment, camera=spec.camera,
                     meta=spec.meta)
