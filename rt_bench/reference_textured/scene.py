"""The textured reference's scene tables, from a
:class:`~rt_bench.scenes.sponza_textured.TexturedSpec`: the default
reference's tables of ``spec.base`` (``rt_bench/reference/scene.py``:
world-space triangles, clusters, materials, the light and the sky), and
beside them each triangle's corner UVs and maps and the maps' texels.

The maps are taken from the spec's arrays, never from the files the
program decodes, so a fault in the program's decode shows.  The UVs are
the spec's, the numbers the OBJ's ``vt`` lines read back as.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..reference import scene as plain
from ..reference.scene import RefScene

NO_MAP = -1


@dataclass
class TexturedRefScene(RefScene):
    uv: torch.Tensor = None  # (T,3,2) corner UVs, in the geometry's dtype
    uv_flat: torch.Tensor = None  # (T,) two corners share a UV
    albedo_map: torch.Tensor = None  # (T,) i64 map of each triangle, or -1
    bump_map: torch.Tensor = None
    alpha_map: torch.Tensor = None
    texels: torch.Tensor = None  # (K,H,W,3) uint8 sRGB
    tex_size: torch.Tensor = None  # (K,2) i64: each map's height, width


def build(spec, device, dtype=torch.float32) -> TexturedRefScene:
    base = spec.base
    rs = plain.build(base, device, dtype)
    uv = np.concatenate([spec.uvs[i.group] for i in base.instances])
    which = {k: np.concatenate([
        np.full(base.meshes[i.mesh].n_tris,
                spec.slots.get(i.group, {}).get(k, NO_MAP), np.int64)
        for i in base.instances]) for k in ("albedo", "bump", "alpha")}
    flat = (np.all(uv[:, 0] == uv[:, 1], axis=-1)
            | np.all(uv[:, 1] == uv[:, 2], axis=-1)
            | np.all(uv[:, 2] == uv[:, 0], axis=-1))
    texels = np.stack(spec.maps)
    sizes = np.asarray([m.shape[:2] for m in spec.maps], np.int64)
    on = lambda x: torch.as_tensor(x, device=device)
    return TexturedRefScene(
        **vars(rs), uv=on(uv.astype(np.float32)).to(dtype), uv_flat=on(flat),
        albedo_map=on(which["albedo"]), bump_map=on(which["bump"]),
        alpha_map=on(which["alpha"]), texels=on(texels), tex_size=on(sizes))
