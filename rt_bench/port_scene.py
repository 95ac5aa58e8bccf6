"""Hand a :class:`~rt_bench.scenes.spec.SceneSpec` to the program under test
through its own scene builder: the default hand-off of a configuration
(``rt_bench/harness.py``).

Each mesh is written once as an OBJ file into a temporary directory of its
own (inside ``workdir``, else under ``TMPDIR``), added once per instance
with ``SceneBuilder.add_obj``, and the directory is removed once the
builder has parsed the files: the builder reads no file of it later.  The
directory is its own, and not ``workdir`` itself, so that the removal of
the OBJ text (some tens of MB at the full size) stays inside the
harness's ``build`` span, which thus times the same work as it did before
the harness owned a work directory.  Tests that build a scene outside a
run give no ``workdir``.
"""

from __future__ import annotations

import os
import tempfile

from .scenes.spec import SceneSpec


def builder_of(spec: SceneSpec, workdir: str = None):
    from ray_tracer_tpu_torch.scene.builder import SceneBuilder
    from ray_tracer_tpu_torch.scene.types import Camera, Environment, Material

    b = SceneBuilder()
    for m in spec.materials:
        b.add_material(Material(**m))
    with tempfile.TemporaryDirectory(prefix="rt_bench_", dir=workdir) as tmp:
        paths = {}
        for name, mesh in spec.meshes.items():
            paths[name] = os.path.join(tmp, f"{name}.obj")
            with open(paths[name], "w") as f:
                f.write(mesh.obj_text())
        for i in spec.instances:
            b.add_obj(paths[i.mesh], material=i.material, position=i.position,
                      rotation_deg=i.rotation_deg, scale=i.scale,
                      front_only=i.front_only, name=i.name)
    for li in spec.rect_lights:
        b.add_rect_light(**li)
    b.set_environment(Environment(**spec.environment))
    b.set_camera(Camera(**spec.camera))
    return b
