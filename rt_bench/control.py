"""Readings for the limits of ``correct``, at a cell's own size, many seeds
in one process:

    python3 rt_bench/control.py --workload sponza_flat.progressive1080 \\
        --seeds 1,2,3 --frames 500 [--program]

For each seed, at the pixels a run with ``--frames`` steps compares, two
controls, each the plain reference in the program's place one precision
below the configuration's float32, against the float32 reference (the
smaller of their ``rel_l1`` is the upper reading):
- ``bf16``: all of it in bfloat16;
- ``bf16_colour``: the geometry in float32, the colour (shading, the
  path's throughput and radiance, roulette, the film blend) in bfloat16;
and with ``--program`` the program itself, ``--frames`` steps of the
cell's renderer (the camera of the mix's last view) against the reference
(the lower reading).  One JSON line a seed.  Needs the card, as a run
does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rt_bench import harness, traffic as traffic_mod  # noqa: E402
from rt_bench.reference import compare  # noqa: E402


CONTROLS = {"bf16": (torch.bfloat16, None),
            "bf16_colour": (torch.float32, torch.bfloat16)}


def control_numbers(spec, config, mix, seed, cam, pix, n_frames, dev,
                    want=None) -> dict:
    """Each control's ``rel_l1`` against the float32 reference, both the
    configuration's own reference (:func:`harness.parts`)."""
    if want is None:
        want = harness.check(spec, config, mix, seed, cam, pix, n_frames, dev)
    ref = harness.parts(config).reference
    cfg = dict(width=mix["width"], height=mix["height"], spp=mix["spp"],
               bounce_limit=mix["bounce_limit"], seed=seed, **config["render"])
    out = {}
    for name, (geometry, colour) in CONTROLS.items():
        rs = ref.scene.build(spec, dev, geometry)
        low = ref.integrator.render_pixels(rs, cfg, cam, torch.as_tensor(
            pix, device=dev), n_frames, colour).float().cpu()
        out[name] = compare.numbers(low, want)["rel_l1"]
    return out


def program_image(spec, config, mix, seed, cam, pix, n_frames, dev, scene):
    import ray_tracer_tpu_torch as trt

    cfg = trt.RenderConfig(width=mix["width"], height=mix["height"],
                           samples_per_pixel=mix["spp"],
                           bounce_limit=mix["bounce_limit"], seed=seed,
                           **config["render"])
    r = trt.ProgressiveRenderer(scene, cfg, trt.Camera(**cam))
    for _ in range(n_frames):
        r.step()
    got = r.accum.reshape(-1, 3)[torch.as_tensor(pix, device=dev)]
    return got.float().cpu()


def where_it_differs(got, want) -> dict:
    """How the program's difference from the reference is spread over the
    pixels: how many differ at all, how many by more than 1e-4 of their
    value, and the largest pixel's share of the summed difference."""
    diff = (got.double() - want.double()).abs().sum(dim=1)
    total = float(diff.sum())
    return dict(differ=int((diff > 0).sum()),
                differ_1e4=int((diff > 1e-4 * want.double().abs().sum(dim=1))
                               .sum()),
                top_share=float(diff.max()) / total if total > 0 else 0.0)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--program", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("rt_bench control: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = harness.load_json(root, "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_json(root, "rt_bench", "configs",
                               f"{cell['config']}.json")
    mix = traffic_mod.load(root, cell["traffic"])
    dev = torch.device("cuda")
    spec = harness.generate(config)
    scene = None
    if args.program:
        scene = harness.build_scene(
            harness.parts(config).handoff, config, spec, dev,
            harness.Spans(time.perf_counter()))
    for seed in (int(s) for s in args.seeds.split(",")):
        move_every, views = traffic_mod.camera_plan(mix, spec.meta,
                                                    spec.camera, seed)
        cam = views[-1] if move_every else spec.camera
        pix = harness.sample_pixels(seed, mix["width"], mix["height"],
                                    args.frames, mix["spp"])
        t = time.perf_counter()
        want = harness.check(spec, config, mix, seed, cam, pix, args.frames,
                             dev)
        out = dict(workload=args.workload, seed=seed, frames=args.frames,
                   pixels=int(pix.size), reference_s=time.perf_counter() - t)
        if scene is not None:
            got = program_image(spec, config, mix, seed, cam, pix,
                                args.frames, dev, scene)
            out["program"] = compare.numbers(got, want)
            out["program_pixels"] = where_it_differs(got, want)
        t = time.perf_counter()
        out["control"] = control_numbers(spec, config, mix, seed, cam, pix,
                                         args.frames, dev, want)
        out["control_s"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
