"""A configuration's own scene hand-off, for the tests of the harness's
work directory: the default hand-off's scene and one textured quad, which
it writes into ``workdir`` as an OBJ with ``vt`` lines, a ``.mtl`` whose
material takes its albedo from a PNG (``map_Kd``), and that PNG.  The
program decodes the PNG only when it compiles the scene."""

import os

import numpy as np

from rt_bench import port_scene

TEX_SHAPE = (6, 10)  # the map's rows and columns
FILES = ("albedo.png", "quad.mtl", "quad.obj")

QUAD_OBJ = """mtllib quad.mtl
v -0.5 0 -0.5
v 0.5 0 -0.5
v 0.5 0 0.5
v -0.5 0 0.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl painted
f 1/1 2/2 3/3
f 1/1 3/3 4/4
"""
QUAD_MTL = """newmtl painted
Kd 1 1 1
map_Kd albedo.png
"""


def builder_of(spec, workdir):
    from ray_tracer_tpu_torch.integrator.film import encode_png_uint8

    b = port_scene.builder_of(spec, workdir)
    texels = np.arange(np.prod(TEX_SHAPE) * 3) % 256
    with open(os.path.join(workdir, "albedo.png"), "wb") as f:
        f.write(encode_png_uint8(texels.reshape(*TEX_SHAPE, 3)))
    for name, text in (("quad.mtl", QUAD_MTL), ("quad.obj", QUAD_OBJ)):
        with open(os.path.join(workdir, name), "w") as f:
            f.write(text)
    b.add_obj(os.path.join(workdir, "quad.obj"))
    return b
