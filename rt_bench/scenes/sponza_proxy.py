"""The Sponza proxy: a frozen copy of the generator of the program's
``sponza_proxy`` preset, as a :class:`~rt_bench.scenes.spec.SceneSpec`.

A generated two-story atrium patterned on the Crytek Sponza layout
(McGuire Computer Graphics Archive): a rectangular courtyard ringed by two
tiers of colonnades, beams over each row, wavy curtains hanging in the
arcade, foliage clutter, a tessellated floor, an emissive skylight quad
with its rect light, and the sky through the open roof.  The random draws
are the preset's, in the preset's order, so the same arguments give the
same triangles, materials, lights and camera (``rt_bench/tests`` holds
the two against each other).

Every part also names its ``usemtl`` group, the way an OBJ file of such a
building groups its faces by material: a tier's row of columns under one
colour, a tier's beams, the curtains of one colour, the foliage, the
floor and the skylight (20 groups).  ``objects="usemtl_groups"`` returns
the scene laid out by them (:func:`~rt_bench.scenes.spec.usemtl_groups`).
"""

from __future__ import annotations

import numpy as np

from .spec import (CAMERA_DEFAULTS, ENVIRONMENT_DEFAULTS, Instance, Mesh,
                   SceneSpec, material, usemtl_groups)

WHITE, RED, GREEN, LIGHT, MIRROR, DIELECTRIC = range(6)

# The reference renderer's default material slots.
MATERIALS = [
    material(name="white"),
    material(albedo=(1.0, 0.0, 0.0), name="red"),
    material(albedo=(0.0, 1.0, 0.0), name="green"),
    material(albedo=(0.0, 0.0, 0.0), emission_color=(1.0, 1.0, 1.0),
             emission_strength=2.4, name="light"),
    material(reflectance=1.0, name="mirror"),
    material(ior=2.0, name="dielectric"),
]

# The unit skylight quad; its geometric normal is (0,-1,0).
SKYLIGHT_VERTS = [
    (-1.0 / 3.0, 0.0, -1.0 / 3.0),
    (1.0 / 3.0, 0.0, -1.0 / 3.0),
    (1.0 / 3.0, 0.0, 1.0 / 3.0),
    (-1.0 / 3.0, 0.0, 1.0 / 3.0),
]
SKYLIGHT_FACES = [(1, 2, 3), (1, 3, 4)]


def _column(n_seg=44) -> Mesh:
    """Fluted lathed column: base, shaft and capital profile."""
    verts, faces = [], []
    prof = [(0.34, 0.0), (0.3, 0.05), (0.26, 0.12), (0.22, 0.2),
            (0.2, 0.3), (0.195, 0.5), (0.19, 0.9), (0.19, 1.3),
            (0.195, 1.55), (0.21, 1.7), (0.24, 1.8), (0.28, 1.88),
            (0.31, 1.95), (0.34, 2.0)]
    n_prof = len(prof)
    for i in range(n_seg):
        a = 2 * np.pi * i / n_seg
        flute = 1.0 + 0.05 * np.cos(10.0 * a)
        for r, y in prof:
            rr = r * (flute if 0.25 < y < 1.6 else 1.0)
            verts.append((rr * np.cos(a), -y, rr * np.sin(a)))
    for i in range(n_seg):
        for j in range(n_prof - 1):
            a = i * n_prof + j
            c = ((i + 1) % n_seg) * n_prof + j
            faces.append((a + 1, c + 1, a + 2))
            faces.append((c + 1, c + 2, a + 2))
    return Mesh(verts, faces)


def _curtain(nx=24, ny=36) -> Mesh:
    """Rippled hanging sheet: thin, doubly curved, large leaves."""
    verts, faces = [], []
    for j in range(ny + 1):
        for i in range(nx + 1):
            u, v = i / nx, j / ny
            x = (u - 0.5) * 1.6
            y = -v * 2.2
            z = 0.22 * np.sin(u * 6.0) * (0.3 + 0.7 * v) \
                + 0.08 * np.sin(v * 9.0)
            verts.append((x, y, z))
    for j in range(ny):
        for i in range(nx):
            a = j * (nx + 1) + i + 1
            bq = a + 1
            c = a + nx + 1
            d = c + 1
            faces.append((a, bq, d))
            faces.append((a, d, c))
    return Mesh(verts, faces)


def _beam(n_seg=32) -> Mesh:
    """Lintel over a colonnade row, tessellated along its length."""
    verts, faces = [], []
    ys = (0.0, -0.22)
    zs = (-0.14, 0.14)
    for i in range(n_seg + 1):
        x = -0.5 + i / n_seg
        for y in ys:
            for z in zs:
                verts.append((x, y, z))
    side_pairs = [(0, 1), (1, 3), (3, 2), (2, 0)]
    corner = {0: (0, 0), 1: (0, 1), 3: (1, 1), 2: (1, 0)}
    for i in range(n_seg):
        a0 = i * 4
        b0 = (i + 1) * 4
        for c0, c1 in side_pairs:
            y0, z0 = corner[c0]
            y1, z1 = corner[c1]
            p = a0 + 2 * y0 + z0 + 1
            q = a0 + 2 * y1 + z1 + 1
            r = b0 + 2 * y1 + z1 + 1
            s = b0 + 2 * y0 + z0 + 1
            faces.append((p, q, r))
            faces.append((p, r, s))
    return Mesh(verts, faces)


def _floor(nx=24, nz=48) -> Mesh:
    verts, faces = [], []
    for j in range(nz + 1):
        for i in range(nx + 1):
            verts.append(((i / nx - 0.5) * 2.0, 0.0, (j / nz - 0.5) * 2.0))
    for j in range(nz):
        for i in range(nx):
            a = j * (nx + 1) + i + 1
            bq = a + 1
            c = a + nx + 1
            d = c + 1
            faces.append((a, bq, d))
            faces.append((a, d, c))
    return Mesh(verts, faces)


def _foliage(rng, n=480) -> Mesh:
    """Irregular triangle soup in a ball (potted-plant analogue)."""
    verts, faces = [], []
    for k in range(n):
        c = rng.normal(0, 0.28, 3)
        c[1] = -abs(c[1]) * 0.9
        for _ in range(3):
            p = c + rng.normal(0, 0.09, 3)
            verts.append(tuple(p))
        faces.append((3 * k + 1, 3 * k + 2, 3 * k + 3))
    return Mesh(verts, faces)


def generate(n_tris_target: int = 260_000, seed: int = 7,
             objects: str = "instances") -> SceneSpec:
    """The preset's scene: its parts as instances of shared meshes
    (``objects="instances"``) or as world-space ``usemtl`` groups
    (``objects="usemtl_groups"``)."""
    rng = np.random.default_rng(seed)
    meshes = {"column": _column(), "curtain": _curtain(), "beam": _beam(),
              "foliage": _foliage(rng)}
    col_tris = meshes["column"].n_tris
    cur_tris = meshes["curtain"].n_tris
    fol_tris = meshes["foliage"].n_tris
    inst = []

    # courtyard: a 2:1 rectangle; two rows x two tiers x two sides of nz
    # columns each, nz from the column triangle budget
    nz = max(3, int(n_tris_target * 0.58) // col_tris // 8)
    L, W = nz * 1.35, 6.0
    k = 0
    for tier in range(2):
        ty = -2.05 * tier
        for row, xoff in ((0, W), (1, W - 1.6)):
            for sx in (-1.0, 1.0):
                for iz in range(nz):
                    z = -L + (2 * L) * (iz + 0.5) / nz + rng.uniform(-0.1, 0.1)
                    x = sx * (xoff + rng.uniform(-0.06, 0.06))
                    mat = int(rng.integers(0, 3))
                    rot = (0.0, float(rng.uniform(0, 360)), 0.0)
                    scale = (float(rng.uniform(0.8, 1.05)),
                             float(rng.uniform(0.95, 1.05)),
                             float(rng.uniform(0.8, 1.05)))
                    inst.append(Instance(
                        "column", mat, (x, ty, z), rot, scale, name=f"col{k}",
                        group=f"column_t{tier}_r{row}_"
                              f"{MATERIALS[mat]['name']}"))
                    k += 1

    for tier in range(2):
        ty = -2.0 - 2.05 * tier
        for xoff in (W, W - 1.6):
            for sx in (-1.0, 1.0):
                inst.append(Instance(
                    "beam", WHITE, (sx * xoff, ty, 0.0), (0.0, 90.0, 0.0),
                    (2.0 * L + 1.0, 1.0, 1.0),
                    name=f"beam{tier}{sx}{xoff:.0f}", group=f"beam_t{tier}"))

    n_cur = max(2, int(n_tris_target * 0.24) // cur_tris)
    for i in range(n_cur):
        sx = -1.0 if i % 2 else 1.0
        z = -L + (2 * L) * ((i // 2) + 0.5) / max(1, n_cur // 2)
        mat = int(rng.integers(0, 3))
        pos = (sx * (W - 0.8), -3.9, z + rng.uniform(-0.2, 0.2))
        rot = (0.0, 90.0 + float(rng.uniform(-10, 10)), 0.0)
        scale = (float(rng.uniform(0.9, 1.3)), float(rng.uniform(0.9, 1.1)),
                 1.0)
        inst.append(Instance("curtain", mat, pos, rot, scale,
                             name=f"curtain{i}",
                             group=f"curtain_{MATERIALS[mat]['name']}"))

    n_fol = max(2, int(n_tris_target * 0.22) // fol_tris)
    for i in range(n_fol):
        sx = -1.0 if i % 2 else 1.0
        z = -L + (2 * L) * ((i // 2) + 0.5) / max(1, n_fol // 2)
        pos = (sx * (W - 2.6) * rng.uniform(0.2, 1.0), -0.4,
               z + rng.uniform(-0.5, 0.5))
        rot = (0.0, float(rng.uniform(0, 360)), 0.0)
        s = float(rng.uniform(0.7, 1.2))
        inst.append(Instance("foliage", GREEN, pos, rot, (s, s, s),
                             name=f"foliage{i}", group="foliage"))

    meshes["floor"] = _floor()
    inst.append(Instance("floor", WHITE, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                         (W + 2.0, 1.0, L + 2.0), front_only=True,
                         name="floor", group="floor"))
    meshes["skylight"] = Mesh(SKYLIGHT_VERTS, SKYLIGHT_FACES)
    inst.append(Instance("skylight", LIGHT, (0.0, -4.6, 0.0),
                         (0.0, 0.0, 0.0), (W - 2.0, 1.0, L), name="skylight",
                         group="skylight"))
    lights = [dict(corner=(-(W - 2.0) / 3.0, -4.6, -L / 3.0),
                   edge_u=(2.0 * (W - 2.0) / 3.0, 0.0, 0.0),
                   edge_v=(0.0, 0.0, 2.0 * L / 3.0),
                   normal=(0.0, -1.0, 0.0), material=LIGHT)]
    env = {**ENVIRONMENT_DEFAULTS, "enabled": True}
    cam = {**CAMERA_DEFAULTS, "position": (3.8, -1.7, -L * 0.85),
           "angles_deg": (2.0, -14.0, 0.0)}
    # the courtyard's layout, which the traffic's camera paths read
    meta = dict(half_length=L, half_width=W, inner_row_x=W - 1.6,
                eye_height=-1.7)
    spec = SceneSpec(materials=list(MATERIALS), meshes=meshes,
                     instances=inst, rect_lights=lights, environment=env,
                     camera=cam, meta=meta)
    if objects == "usemtl_groups":
        return usemtl_groups(spec)
    if objects != "instances":
        raise ValueError(f"objects={objects!r}")
    return spec
