"""The plain reference's own scene tables, worked out from a
:class:`~rt_bench.scenes.spec.SceneSpec`.

Every instance's triangles are taken to world space (the reference
renderer's ``translate * rotX * rotY * rotZ * scale`` transform), with the
normals the OBJ loader falls back to where a mesh has none (the geometric
face normal) carried by the same matrix: the reference renderer transforms
normals by ``M`` and not by its inverse transpose, and the scenes it renders
are defined with that quirk.  The triangles are then grouped into clusters
of at most :data:`CLUSTER` by median splits, each with a box widened a
little, and the clusters into runs of :data:`SUPER` consecutive ones, for
:mod:`rt_bench.reference.trace`.  Nothing here reads the
program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..scenes.spec import SceneSpec, trs_matrix

CLUSTER = 64  # triangles per cluster at most
SUPER = 32  # clusters per run, consecutive in the split order


def camera_rotation(angles_deg) -> np.ndarray:
    """The camera's rotation ``rotY * rotX * rotZ``, each built from the
    columns the reference renderer writes out."""
    tx, ty, tz = np.radians(np.asarray(angles_deg, dtype=np.float64))
    cx, sx = np.cos(tx), np.sin(tx)
    cy, sy = np.cos(ty), np.sin(ty)
    cz, sz = np.cos(tz), np.sin(tz)
    rx = np.array([[1, 0, 0], [0, cx, sx], [0, -sx, cx]], dtype=np.float32)
    ry = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]], dtype=np.float32)
    rz = np.array([[cz, sz, 0], [-sz, cz, 0], [0, 0, 1]], dtype=np.float32)
    return (ry @ rx @ rz).astype(np.float32)


def face_normals(p: np.ndarray) -> np.ndarray:
    """(T,3,3) corners -> (T,3,3) per-corner unit face normals: the float32
    cross product of the edges, divided by its float64 length."""
    g = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]).astype(np.float32)
    ln = np.sqrt((g.astype(np.float64) ** 2).sum(-1, keepdims=True))
    n = np.where(ln > 0, g / np.where(ln > 0, ln, 1.0), g).astype(np.float32)
    return np.repeat(n[:, None, :], 3, axis=1)


@dataclass
class RefScene:
    """World-space triangle tables and the scene constants, as torch
    tensors on one device, in one float dtype."""

    v0: torch.Tensor  # (T,3)
    e1: torch.Tensor
    e2: torch.Tensor
    n_geo: torch.Tensor  # cross(e1, e2)
    vn: torch.Tensor  # (T,3,3) vertex normals
    front_only: torch.Tensor  # (T,) bool
    albedo: torch.Tensor  # (T,3)
    emission: torch.Tensor  # (T,3) colour * strength
    cl_tri: torch.Tensor  # (C, CLUSTER) triangle ids, -1 padding
    cl_min: torch.Tensor  # (C,3)
    cl_max: torch.Tensor
    su_cl: torch.Tensor  # (S, SUPER) cluster ids, -1 padding
    su_min: torch.Tensor  # (S,3)
    su_max: torch.Tensor
    light: dict  # corner, edge_u, edge_v, normal (3,) tensors; area,
    # emission (1,3)
    env: dict
    dtype: torch.dtype


def world_triangles(spec: SceneSpec):
    """(positions (T,3,3), vertex normals (T,3,3), material (T,), front_only
    (T,)) in world space, float32, in instance order."""
    pos, nrm, mat, fo = [], [], [], []
    for inst in spec.instances:
        mesh = spec.meshes[inst.mesh]
        p_obj = mesh.positions()
        m = trs_matrix(inst.position, inst.rotation_deg, inst.scale)
        p = p_obj @ m[:3, :3].T + m[:3, 3]
        n = face_normals(p_obj) @ m[:3, :3].T
        if np.linalg.det(m[:3, :3]) < 0:  # a mirror keeps its winding
            p, n = p[:, [0, 2, 1]], n[:, [0, 2, 1]]
        pos.append(p.astype(np.float32))
        nrm.append(n.astype(np.float32))
        mat.append(np.full(p.shape[0], inst.material, np.int64))
        fo.append(np.full(p.shape[0], inst.front_only, bool))
    return (np.concatenate(pos), np.concatenate(nrm), np.concatenate(mat),
            np.concatenate(fo))


def clusters(positions: np.ndarray, size: int = CLUSTER):
    """Median splits of the triangles' centroids along the widest axis of
    each group until no group holds more than ``size`` -> (C, size)
    triangle ids padded with -1."""
    cen = positions.mean(axis=1).astype(np.float64)
    t = cen.shape[0]
    order = np.arange(t)
    bounds = [0, t]  # group k is order[bounds[k]:bounds[k + 1]]
    while True:
        b = np.asarray(bounds)
        sizes = np.diff(b)
        if sizes.max() <= size:
            break
        seg = np.repeat(np.arange(sizes.size), sizes)
        c = cen[order]
        lo = np.minimum.reduceat(c, b[:-1], axis=0)
        hi = np.maximum.reduceat(c, b[:-1], axis=0)
        axis = np.argmax(hi - lo, axis=1)
        key = c[np.arange(t), axis[seg]]
        order = order[np.lexsort((key, seg))]
        new = [0]
        for k in range(sizes.size):
            if sizes[k] > size:
                new.append(b[k] + sizes[k] // 2)
            new.append(b[k + 1])
        bounds = new
    b = np.asarray(bounds)
    table = np.full((b.size - 1, size), -1, np.int64)
    for k in range(b.size - 1):
        table[k, :b[k + 1] - b[k]] = order[b[k]:b[k + 1]]
    return table


def build(spec: SceneSpec, device, dtype=torch.float32) -> RefScene:
    for inst in spec.instances:
        m = spec.materials[inst.material]
        if m["reflectance"] != 0.0 or m["ior"] != -1.0:
            raise NotImplementedError(
                "the reference shades diffuse and emissive triangles only")
    if len(spec.rect_lights) != 1:
        raise NotImplementedError("the reference samples one rect light")
    pos, nrm, mat, fo = world_triangles(spec)
    v0 = pos[:, 0]
    e1 = pos[:, 1] - pos[:, 0]
    e2 = pos[:, 2] - pos[:, 0]
    n_geo = np.cross(e1, e2).astype(np.float32)
    table = clusters(pos)
    safe = np.where(table >= 0, table, table[:, :1])
    corners = pos[safe].reshape(table.shape[0], -1, 3)
    lo = corners.min(axis=1).astype(np.float64)
    hi = corners.max(axis=1).astype(np.float64)
    pad = 1e-4 * (hi - lo).max(axis=1, keepdims=True) + 1e-4
    lo, hi = lo - pad, hi + pad
    n_cl = table.shape[0]
    n_su = -(-n_cl // SUPER)
    su = np.full(n_su * SUPER, -1, np.int64)
    su[:n_cl] = np.arange(n_cl)
    su = su.reshape(n_su, SUPER)
    su_safe = np.where(su >= 0, su, su[:, :1])
    albedo = np.asarray([m["albedo"] for m in spec.materials], np.float32)
    emis = np.asarray([m["emission_color"] for m in spec.materials],
                      np.float32) * np.asarray(
        [m["emission_strength"] for m in spec.materials], np.float32)[:, None]
    li = spec.rect_lights[0]
    lm = spec.materials[li["material"]]
    area = float(np.linalg.norm(np.cross(np.asarray(li["edge_u"]),
                                         np.asarray(li["edge_v"]))))
    t = lambda x, dt=dtype: torch.as_tensor(
        np.asarray(x, np.float32), device=device).to(dt)
    env = spec.environment
    return RefScene(
        v0=t(v0), e1=t(e1), e2=t(e2), n_geo=t(n_geo), vn=t(nrm),
        front_only=torch.as_tensor(fo, device=device),
        albedo=t(albedo[mat]), emission=t(emis[mat]),
        cl_tri=torch.as_tensor(table, device=device),
        cl_min=t(lo.astype(np.float32)), cl_max=t(hi.astype(np.float32)),
        su_cl=torch.as_tensor(su, device=device),
        su_min=t(lo[su_safe].min(axis=1).astype(np.float32)),
        su_max=t(hi[su_safe].max(axis=1).astype(np.float32)),
        light=dict(corner=t(li["corner"]), edge_u=t(li["edge_u"]),
                   edge_v=t(li["edge_v"]), normal=t(li["normal"]),
                   area=t(area),
                   emission=t(np.asarray(lm["emission_color"], np.float32)
                              * np.float32(lm["emission_strength"]))[None]),
        env=dict(horizon=t(env["horizon_color"]),
                 sun_focus=t(env["sun_focus"]),
                 zenith=t(env["zenith_color"]),
                 sun_intensity=t(env["sun_intensity"]),
                 ground=t(env["ground_color"]),
                 light_dir=t(env["light_dir"]),
                 enabled=bool(env["enabled"])),
        dtype=dtype,
    )
