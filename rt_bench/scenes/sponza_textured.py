"""The textured Sponza: the flat cell's atrium with UVs and a generated set
of maps, as :class:`TexturedSpec`.

The geometry is :func:`~rt_bench.scenes.sponza_proxy.generate` with
``objects="usemtl_groups"``, unchanged: the same triangles in the same 20
groups.  Each group but the emissive skylight gets a material of its own
(white, ``Kd 1 1 1``) with these maps, all ``map_size`` x ``map_size``
sRGB bytes made from ``seed``:

- an albedo map: smooth multi-octave value noise, tileable, with a
  texel's own grain, tinted by the group's colour (white, red or green);
- a bump height map for every group but the foliage: value noise of the
  finer octaves, gray;
- for the foliage, an alpha mask: leaf-shaped regions on a clear ground
  until about half the texels are opaque, gray (0 or 255).

A triangle's UVs are per corner, box-projected from world space along the
face's dominant axis and divided by :data:`PERIOD`.  They travel as the
OBJ's ``vt`` lines with six decimals (:attr:`TexturedSpec.uv_text`), and
:attr:`TexturedSpec.uvs` holds the numbers read back from that text as an
OBJ loader reads them (Python's ``float``, narrowed to float32), as
``Mesh.positions`` does for the corners.  This module imports neither the
program nor its reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import sponza_proxy
from .spec import Instance, SceneSpec, material

# World units a map repeats over.  The preset camera stands 0.6 from the
# inner colonnade; its nearest columns are about 2 to 2.5 away, where a
# pixel of the 1080-line, 50 degree frame covers 2 * tan(25 deg) / 1080 *
# 2.3 = 0.0020, and a texel of a 1024 map PERIOD / 1024 = 0.0020.
PERIOD = 2.0
# lattice cells a map side, coarse first; a map takes those of at least 4
# texels a cell (all seven at 1024)
OCTAVES = (4, 8, 16, 32, 64, 128, 256)
ALBEDO_FALLOFF = 0.85  # each octave's amplitude over the one before
ALBEDO_RANGE = (0.35, 1.0)  # linear brightness, before the group's tint
ALBEDO_GRAIN = 0.1  # a texel's own grain: brightness times 1 +- this
BUMP_OCTAVES = 4  # the bump map takes the finest four a map takes
BUMP_FALLOFF = 1.0
BUMP_HEIGHT = 1.0  # the linear height's range (bump_scale 1: the slope)
ALPHA_OPAQUE = 0.5  # the share of opaque texels the leaves fill
LEAF_LENGTH = (1 / 16, 1 / 8)  # a leaf's length, as a share of the map
LEAF_WIDTH = 0.3  # a leaf's width over its length


@dataclass
class TexturedSpec:
    """A generated textured scene: ``base``, the usemtl groups with one
    material a textured group (``base.materials``, white, the maps in
    ``slots``), the maps, and the groups' UVs."""

    base: SceneSpec
    maps: List[np.ndarray]  # (S,S,3) uint8 sRGB, a texture slot each
    map_names: List[str]  # a file stem a slot
    slots: Dict[str, dict]  # group -> {"albedo": k, "bump": k, "alpha": k}
    uv_text: Dict[str, str]  # group -> "vt u v\n" a corner, face by face
    uvs: Dict[str, np.ndarray]  # group -> (T,3,2) float32

    @property
    def camera(self) -> dict:
        return self.base.camera

    @property
    def meta(self) -> dict:
        return self.base.meta


def srgb_bytes(linear: np.ndarray) -> np.ndarray:
    """Linear values in [0, 1] -> sRGB bytes (the standard curve, in
    float32)."""
    x = np.clip(linear, 0.0, 1.0).astype(np.float32)
    s = np.where(x <= 0.0031308, x * np.float32(12.92),
                 np.float32(1.055) * x ** np.float32(1 / 2.4)
                 - np.float32(0.055))
    return np.round(s * np.float32(255.0)).astype(np.uint8)


def octaves(size: int) -> tuple:
    """The octaves of :data:`OCTAVES` a map of ``size`` texels a side
    takes."""
    return tuple(f for f in OCTAVES if 4 * f <= size) or OCTAVES[:1]


def value_noise(rng, size: int, octaves, falloff: float) -> np.ndarray:
    """(size, size) float32 tileable value noise in [0, 1]: for each octave
    of ``f`` lattice cells a side, random lattice values smoothstep-
    interpolated (``A @ lattice @ A.T``, ``A`` the (size, f) weights of the
    cells' corners at the texel centres), weighted by ``falloff`` to the
    power of the octave's index, summed and scaled to [0, 1]."""
    out = np.zeros((size, size), np.float32)
    for k, f in enumerate(octaves):
        lattice = rng.random((f, f)).astype(np.float32)
        x = (np.arange(size) + 0.5) * f / size
        i0 = np.floor(x).astype(np.int64)
        t = x - i0
        t = t * t * (3.0 - 2.0 * t)
        a = np.zeros((size, f), np.float32)
        a[np.arange(size), i0 % f] += 1.0 - t
        a[np.arange(size), (i0 + 1) % f] += t
        out += np.float32(falloff ** k) * (a @ lattice @ a.T)
    lo, hi = out.min(), out.max()
    return (out - lo) / (hi - lo) if hi > lo else np.full_like(out, 0.5)


def albedo_map(rng, size: int, tint) -> np.ndarray:
    n = value_noise(rng, size, octaves(size), ALBEDO_FALLOFF)
    lo, hi = ALBEDO_RANGE
    grain = 1.0 + ALBEDO_GRAIN * (2.0 * rng.random((size, size)) - 1.0)
    lin = ((lo + (hi - lo) * n) * grain)[..., None] * np.asarray(tint)
    return srgb_bytes(lin)


def bump_map(rng, size: int) -> np.ndarray:
    h = srgb_bytes(BUMP_HEIGHT * value_noise(
        rng, size, octaves(size)[-BUMP_OCTAVES:], BUMP_FALLOFF))
    return np.repeat(h[..., None], 3, axis=2)


def alpha_map(rng, size: int) -> np.ndarray:
    """Leaves stamped at random places, angles and lengths (wrapping at the
    edges) until :data:`ALPHA_OPAQUE` of the texels are opaque: a leaf is
    ``|b| < width * (1 - a^2)`` in its own frame, ``a`` along it in
    [-1, 1], ``b`` across it in lengths."""
    opaque = np.zeros((size, size), bool)
    need = ALPHA_OPAQUE * size * size
    while opaque.sum() < need:
        half = 0.5 * size * rng.uniform(*LEAF_LENGTH)
        cy, cx = rng.uniform(0, size, 2)
        ang = rng.uniform(0, np.pi)
        r = int(np.ceil(half)) + 1
        oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
        py = oy + np.floor(cy) + 0.5 - cy
        px = ox + np.floor(cx) + 0.5 - cx
        a = (px * np.cos(ang) + py * np.sin(ang)) / half
        b = (-px * np.sin(ang) + py * np.cos(ang)) / half
        inside = (np.abs(a) < 1.0) & (np.abs(b) < LEAF_WIDTH * (1.0 - a * a))
        iy = (oy + int(np.floor(cy))) % size
        ix = (ox + int(np.floor(cx))) % size
        opaque[iy[inside], ix[inside]] = True
    return np.repeat(np.where(opaque, 255, 0).astype(np.uint8)[..., None],
                     3, axis=2)


def corner_uvs(p: np.ndarray) -> np.ndarray:
    """(T,3,3) corners -> (T,3,2) float64 UVs: each face projected along
    the dominant axis of its normal, over :data:`PERIOD`."""
    p = p.astype(np.float64)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    axis = np.argmax(np.abs(n), axis=1)
    # the two other axes, in the order (x: z, y), (y: x, z), (z: x, y)
    pick = np.asarray([[2, 1], [0, 2], [0, 1]])[axis]  # (T,2)
    uv = np.take_along_axis(p, pick[:, None, :].repeat(3, axis=1), axis=2)
    return uv / PERIOD


def uv_text(uv: np.ndarray):
    """(T,3,2) UVs -> (the OBJ's ``vt`` lines, a corner a line; the
    (T,3,2) float32 values those lines read back as)."""
    flat = uv.ravel().tolist()
    text = ("vt %.6f %.6f\n" * (len(flat) // 2)) % tuple(flat)
    words = text.split()
    del words[::3]  # the "vt" of each line
    back = np.fromiter(map(float, words), np.float64, len(flat))
    return text, back.astype(np.float32).reshape(uv.shape)


def generate(n_tris_target: int = 260_000, seed: int = 7,
             objects: str = "usemtl_groups",
             map_size: int = 1024) -> TexturedSpec:
    """The flat cell's scene (``sponza_proxy.generate`` with these
    arguments) with a material and maps for each group but the skylight
    (the group whose material emits), and UVs for every group."""
    if objects != "usemtl_groups":
        raise ValueError("the textured scene is laid out in usemtl groups")
    geo = sponza_proxy.generate(n_tris_target=n_tris_target, seed=seed,
                                objects=objects)
    materials = list(geo.materials)
    instances, maps, names, slots, texts, uvs = [], [], [], {}, {}, {}

    def add(name, image):
        maps.append(image)
        names.append(name)
        return len(maps) - 1

    for k, inst in enumerate(geo.instances):
        g = inst.group
        text, back = uv_text(corner_uvs(geo.meshes[inst.mesh].positions()))
        texts[g], uvs[g] = text, back
        mat = geo.materials[inst.material]
        if mat["emission_strength"] > 0.0:
            instances.append(inst)
            continue
        rng = np.random.default_rng([seed % 2**63, 0x5EC7, k])
        slot = {"albedo": add(f"{g}_albedo",
                              albedo_map(rng, map_size, mat["albedo"])),
                "bump": -1, "alpha": -1}
        if g == "foliage":
            slot["alpha"] = add(f"{g}_alpha", alpha_map(rng, map_size))
        else:
            slot["bump"] = add(f"{g}_bump", bump_map(rng, map_size))
        slots[g] = slot
        materials.append(material(name=g))
        instances.append(Instance(
            inst.mesh, len(materials) - 1, inst.position, inst.rotation_deg,
            inst.scale, front_only=inst.front_only, name=inst.name, group=g))
    base = SceneSpec(materials=materials, meshes=geo.meshes,
                     instances=instances, rect_lights=geo.rect_lights,
                     environment=geo.environment, camera=geo.camera,
                     meta=geo.meta)
    return TexturedSpec(base=base, maps=maps, map_names=names, slots=slots,
                        uv_text=texts, uvs=uvs)
