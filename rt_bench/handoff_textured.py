"""Hand a :class:`~rt_bench.scenes.sponza_textured.TexturedSpec` to the
program as a user's files: OBJ, MTL and PNG maps written into the run's
work directory, loaded by ``SceneBuilder.add_obj`` (the textured sponza's
hand-off, ``rt_bench/configs/sponza_textured.json``).

The usemtl groups go into OBJ files in their order, one file for each run
of consecutive groups that share what ``add_obj`` sets for a whole file:
front-only faces (the floor) and, for a group with no maps (the emissive
skylight), its material, which ``add_obj`` gives the file's groups that
its MTL does not name.  A textured file names its MTL (``mtllib``): one
``newmtl`` a group, ``Kd 1 1 1``, ``map_Kd`` and ``map_bump`` or
``map_d``.  Every corner has its own ``vt`` line; faces are ``f v/vt``.
No ``vn`` lines: the program takes each face's geometric normal, as for
the flat cell's files.  The maps are written as PNGs by the program's
own encoder (``integrator/film.py::encode_png_uint8``), bump and alpha
maps gray replicated to RGB; the program decodes them when the scene is
compiled.  Every file is added with ``sampler=1`` (bilinear), as the
program's textured presets are.  The rect light, the sky and the camera
are handed over as ``port_scene`` does.
"""

from __future__ import annotations

import os
from itertools import groupby

import numpy as np

from .scenes.sponza_textured import TexturedSpec

ZLIB_LEVEL = 1  # the maps' PNG deflate level: noise barely compresses


def builder_of(spec: TexturedSpec, workdir: str):
    return build(spec, workdir)


def build(spec: TexturedSpec, workdir: str, sampler: int = 1,
          maps=("map_Kd", "map_bump", "map_d")):
    """The program's ``SceneBuilder`` of ``spec``, its files written into
    ``workdir``; ``sampler`` and ``maps`` (the MTL statements written) as
    a user's files would set them, for checks of what the files decide."""
    from ray_tracer_tpu_torch.integrator.film import encode_png_uint8
    from ray_tracer_tpu_torch.scene.builder import SceneBuilder
    from ray_tracer_tpu_torch.scene.types import Camera, Environment, Material

    base = spec.base
    b = SceneBuilder()
    for m in base.materials:
        b.add_material(Material(**m))
    for name, image in zip(spec.map_names, spec.maps):
        with open(os.path.join(workdir, f"{name}.png"), "wb") as f:
            f.write(encode_png_uint8(image, ZLIB_LEVEL))
    key = lambda inst: (inst.front_only, inst.group in spec.slots,
                        None if inst.group in spec.slots else inst.material)
    for k, (_, run) in enumerate(groupby(base.instances, key)):
        run = list(run)
        stem = os.path.join(workdir, f"sponza_{k}")
        textured = run[0].group in spec.slots
        if textured:
            with open(stem + ".mtl", "w") as f:
                f.write(mtl_text(spec, run, maps))
        with open(stem + ".obj", "w") as f:
            f.write(obj_text(spec, run, os.path.basename(stem) + ".mtl"
                             if textured else None))
        b.add_obj(stem + ".obj", material=run[0].material,
                  front_only=run[0].front_only, sampler=sampler,
                  name=os.path.basename(stem))
    for li in base.rect_lights:
        b.add_rect_light(**li)
    b.set_environment(Environment(**base.environment))
    b.set_camera(Camera(**base.camera))
    return b


def mtl_text(spec: TexturedSpec, run, maps) -> str:
    """One ``newmtl`` for each group of ``run``: white, with the group's
    maps among ``maps``."""
    out = []
    for inst in run:
        slot = spec.slots[inst.group]
        out += [f"newmtl {inst.group}", "Kd 1 1 1"]
        for statement, which in (("map_Kd", "albedo"), ("map_bump", "bump"),
                                  ("map_d", "alpha")):
            if slot[which] >= 0 and statement in maps:
                out.append(f"{statement} {spec.map_names[slot[which]]}.png")
    return "\n".join(out) + "\n"


def obj_text(spec: TexturedSpec, run, mtllib) -> str:
    """The groups of ``run`` as one OBJ: every group's vertices and corner
    UVs first, then each group's ``usemtl`` and faces."""
    head = [f"mtllib {mtllib}\n"] if mtllib else []
    verts, uvs, faces = [], [], []
    nv = nt = 0
    for inst in run:
        mesh = spec.base.meshes[inst.mesh]
        words = mesh._coords().split()
        verts.append(("v %s %s %s\n" * (len(words) // 3)) % tuple(words))
        uvs.append(spec.uv_text[inst.group])
        f = np.asarray(mesh.faces, np.int64) + nv
        t = np.arange(1, 3 * f.shape[0] + 1).reshape(-1, 3) + nt
        fv = np.stack([f, t], axis=2).ravel().tolist()
        faces.append(f"usemtl {inst.group}\n"
                     + ("f %d/%d %d/%d %d/%d\n" * f.shape[0]) % tuple(fv))
        nv += len(words) // 3
        nt += 3 * f.shape[0]
    return "".join(head + verts + uvs + faces)
