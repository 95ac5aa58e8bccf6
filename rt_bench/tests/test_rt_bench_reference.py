"""The plain reference agrees with the program on a small scene on the
CPU, flattened and instanced, pixel by pixel."""

import pytest
import torch

from rt_bench.port_scene import builder_of
from rt_bench.reference import compare, integrator, scene as ref_scene
from rt_bench.scenes import sponza_proxy


@pytest.mark.parametrize("objects", ["instances", "usemtl_groups"])
@pytest.mark.parametrize("flatten", [True, False])
def test_reference_agrees_with_the_program(flatten, objects):
    import ray_tracer_tpu_torch as trt

    spec = sponza_proxy.generate(n_tris_target=8000, objects=objects)
    sc = builder_of(spec).compile(device="cpu", flatten_instances=flatten)
    w, h, frames, seed = 20, 12, 3, 2**31 + 77
    cfg = trt.RenderConfig(width=w, height=h, samples_per_pixel=2,
                           bounce_limit=8, seed=seed)
    r = trt.ProgressiveRenderer(sc, cfg)
    for _ in range(frames):
        r.step()
    rs = ref_scene.build(spec, "cpu")
    want = integrator.render_pixels(
        rs, dict(width=w, height=h, spp=2, bounce_limit=8, seed=seed,
                 rr_start_bounce=5, rr_clamp=0.95),
        spec.camera, torch.arange(w * h), frames)
    got = r.accum.reshape(-1, 3)
    assert compare.numbers(got, want)["rel_l1"] < 1e-6
    # most pixels agree to the last bit
    assert (got == want).all(dim=1).float().mean() > 0.7


def test_occlusion_and_closest_hit_on_a_quad():
    from rt_bench.reference import trace
    from rt_bench.scenes.spec import (ENVIRONMENT_DEFAULTS, Instance, Mesh,
                                      SceneSpec, material)

    quad = Mesh([(-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1)],
                [(1, 2, 3), (1, 3, 4)])
    spec = SceneSpec(
        materials=[material()], meshes={"q": quad},
        instances=[Instance("q", 0, (0, 0, 0), (0, 0, 0), (1, 1, 1)),
                   Instance("q", 0, (0, -2, 0), (0, 0, 0), (1, 1, 1))],
        rect_lights=[dict(corner=(0, -3, 0), edge_u=(1, 0, 0),
                          edge_v=(0, 0, 1), normal=(0, 1, 0), material=0)],
        environment=dict(ENVIRONMENT_DEFAULTS), camera={})
    rs = ref_scene.build(spec, "cpu")
    o = torch.tensor([[0.2, -5.0, 0.1], [0.2, -1.0, 0.1], [3.0, -1.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    t, tri = trace.closest(rs, o, d, torch.ones(3, dtype=torch.bool))
    assert torch.allclose(t[:2], torch.tensor([3.0, 1.0]))
    assert tri[0] >= 2 and 0 <= tri[1] < 2 and tri[2] == -1
    occ = trace.occluded(rs, o, d, torch.ones(3, dtype=torch.bool),
                         torch.tensor([2.9, 1.5, 9.0]))
    assert occ.tolist() == [False, True, False]
