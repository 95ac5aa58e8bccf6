"""Hand a :class:`~rt_bench.scenes.spec.SceneSpec` to the program under test
through its own scene builder.

Each mesh is written once as an OBJ file into a temporary directory (under
``TMPDIR``), added once per instance with ``SceneBuilder.add_obj``, and the
directory is removed once the builder has parsed the files.
"""

from __future__ import annotations

import os
import tempfile

from .scenes.spec import SceneSpec


def builder_of(spec: SceneSpec):
    from ray_tracer_tpu_torch.scene.builder import SceneBuilder
    from ray_tracer_tpu_torch.scene.types import Camera, Environment, Material

    b = SceneBuilder()
    for m in spec.materials:
        b.add_material(Material(**m))
    with tempfile.TemporaryDirectory(prefix="rt_bench_") as tmp:
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
