"""Command-line interface (port of the JAX package's ``cli.py``).

    python -m ray_tracer_tpu_torch.cli render scene.json -o out.png --spp 64
    python -m ray_tracer_tpu_torch.cli render --preset sponza_proxy -o out.png
    python -m ray_tracer_tpu_torch.cli info --preset sphere_diffuse --cpu
    python -m ray_tracer_tpu_torch.cli bench --preset sponza_proxy --spp 2
    python -m ray_tracer_tpu_torch.cli view --preset sphere_diffuse --cpu

``render --progressive N`` runs N progressive frames, with
``--checkpoint state.npz`` saving the state after them and resuming from
it when the file exists; ``--orbit N`` renders N frames sweeping the
camera's yaw by +/-15 degrees; ``--sharded`` splits the frame's pixels
over the ranks of a ``torch.distributed`` world, one CUDA device each
(``parallel/mesh.py``; rank 0 writes the image)::

    torchrun --nproc-per-node 4 -m ray_tracer_tpu_torch.cli render \
        --sharded --preset sponza_proxy -o out.png

Without ``torchrun`` it runs as a world of one (with ``--cpu``: gloo on
the CPU).  Every subcommand prints one JSON report line (``info``: the
compiled scene's statistics) with the JAX CLI's keys.

Everything runs on the CUDA device unless ``--cpu`` is given; without a
card and without ``--cpu`` the scene compile raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _build_scene(args):
    from .scene import presets, schema

    if args.scene:
        return schema.load_scene(args.scene)
    preset = args.preset or "cornell"
    named = {
        "cornell": presets.default_scene,
        "cornell_spheres": presets.cornell_spheres,
        "sphere_diffuse": presets.sphere_diffuse,
        "sponza_proxy": presets.sponza_proxy,
    }
    if preset in named:
        return named[preset]()
    return presets.mesh_scene(preset)  # a mesh name inside the assets dir


def _add_common(p):
    p.add_argument("scene", nargs="?", help="scene JSON path")
    p.add_argument("--preset", help="built-in scene: cornell, "
                   "cornell_spheres, sphere_diffuse, sponza_proxy, or "
                   "<mesh.obj>")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ray_tracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    _add_common(pr)
    pr.add_argument("-o", "--output", default="out.png")
    pr.add_argument("--progressive", type=int, default=0, metavar="FRAMES",
                    help="progressive frames (spp each) instead of one pass")
    pr.add_argument("--checkpoint",
                    help="progressive state file to save/resume")
    pr.add_argument("--sharded", action="store_true",
                    help="shard the pixels over the ranks of the torchrun "
                         "world, one device each (alone: a world of one)")
    pr.add_argument("--orbit", type=int, default=0, metavar="FRAMES",
                    help="render FRAMES frames sweeping camera yaw +/-15deg")

    pi = sub.add_parser("info", help="print compiled scene statistics")
    _add_common(pi)

    pb = sub.add_parser("bench", help="time a render, print a report")
    _add_common(pb)
    pb.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the timed render "
                         "to DIR/trace.json; it carries the wavefront "
                         "loop's host ranges 'rt.first_wave lanes=N', "
                         "'rt.live_read', 'rt.round lanes=W live=L' and "
                         "the mark 'rt.rays samples=S sem=A traced=B'")

    pv = sub.add_parser("view", help="live progressive viewer (HTTP)")
    _add_common(pv)
    pv.add_argument("--port", type=int, default=8787)
    pv.add_argument("--host", default="127.0.0.1",
                    help="bind address (default loopback; 0.0.0.0 exposes "
                         "the viewer and its camera endpoint to the network)")
    return ap


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _profiler(out_dir):
    """A torch.profiler context writing ``out_dir/trace.json`` on exit."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def run():
        os.makedirs(out_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))

    return run()


def _config(args):
    from . import RenderConfig

    return RenderConfig(
        width=args.width,
        height=args.height,
        samples_per_pixel=args.spp,
        bounce_limit=args.bounces,
        seed=args.seed,
    )


def _report(args, cfg, scene, img, t0, compile_s, spp):
    """Write the image, print the render report line."""
    from .integrator import film

    _sync(scene.device)
    dt = time.perf_counter() - t0
    film.write_png(args.output, img)
    print(json.dumps({
        "output": args.output,
        "resolution": f"{cfg.width}x{cfg.height}",
        "spp": spp,
        "wall_s": round(dt, 3),
        "scene_compile_s": round(compile_s, 3),
        "tris": scene.meta.get("n_tris", 0),
        "bvh_nodes": int(scene.bvh_index.shape[0]),
    }))


def _render_sharded(args) -> int:
    """``render --sharded``: join the torchrun world (or form a world of
    one), render the frame on a (world, 1) mesh; rank 0 writes it."""
    import torch.distributed as dist

    from .parallel import mesh as pmesh

    _, world, device = pmesh.init_from_env(cpu=args.cpu)
    try:
        cfg = _config(args)
        t0 = time.perf_counter()
        scene = _build_scene(args).compile(device=device)
        compile_s = time.perf_counter() - t0
        img = pmesh.render_frame_sharded(scene, cfg,
                                         pmesh.make_mesh(n_data=world))
        if dist.get_rank() == 0:
            _report(args, cfg, scene, img, t0, compile_s,
                    cfg.samples_per_pixel)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if getattr(args, "sharded", False):
        return _render_sharded(args)

    from . import ProgressiveRenderer, render_frame
    from .integrator import film

    device = "cpu" if args.cpu else None
    cfg = _config(args)
    t0 = time.perf_counter()
    builder = _build_scene(args)
    scene = builder.compile(device=device)
    compile_s = time.perf_counter() - t0
    dev = scene.device

    if args.cmd == "info":
        meta = dict(scene.meta)
        meta["scene_compile_s"] = round(compile_s, 3)
        meta["bvh_nodes"] = int(scene.bvh_index.shape[0])
        print(json.dumps(meta, default=str, indent=2))
        return 0

    if args.cmd == "view":
        from . import viewer

        # the builder (not the compiled scene) enables the live editors
        viewer.serve(builder, cfg, port=args.port, host=args.host,
                     device=dev)
        return 0

    if args.cmd == "bench":
        render_frame(scene, cfg)  # warm-up: kernel builds, allocator
        prof = (_profiler(args.profile) if args.profile
                else contextlib.nullcontext())
        with prof:
            _sync(dev)
            t1 = time.perf_counter()
            render_frame(scene, cfg)
            _sync(dev)
            dt = time.perf_counter() - t1
        n_primary = cfg.n_pixels * cfg.samples_per_pixel
        print(json.dumps({
            "wall_s": round(dt, 4),
            "primary_rays": n_primary,
            "primary_mrays_per_s": round(n_primary / dt / 1e6, 3),
            "spp": cfg.samples_per_pixel,
            "resolution": f"{cfg.width}x{cfg.height}",
            "device": _device_name(dev),
        }))
        return 0

    # render
    if args.orbit > 0:
        from .api import scene_camera
        from .scene.types import Camera

        base = scene_camera(scene)
        stem, ext = os.path.splitext(args.output)
        times = []
        for i in range(args.orbit):
            yaw = -15.0 + 30.0 * i / max(args.orbit - 1, 1)
            cam = Camera(
                position=base.position,
                angles_deg=(base.angles_deg[0], base.angles_deg[1] + yaw,
                            base.angles_deg[2]),
                fov=base.fov,
                near_plane=base.near_plane,
            )
            t1 = time.perf_counter()
            img = render_frame(scene, cfg, cam, frame=i)
            film.write_png(f"{stem}_{i:03d}{ext}", img)
            times.append(time.perf_counter() - t1)
        print(json.dumps({
            "output": f"{stem}_*{ext}",
            "frames": args.orbit,
            "mean_frame_s": round(sum(times) / len(times), 4),
            "first_frame_s": round(times[0], 4),
        }))
        return 0
    if args.progressive > 0:
        pr_ = ProgressiveRenderer(scene, cfg)
        if args.checkpoint and os.path.exists(args.checkpoint):
            pr_.load_state(args.checkpoint)
            print(f"resumed at frame {pr_.frame}", file=sys.stderr)
        for _ in range(args.progressive):
            img = pr_.step()
        if args.checkpoint:
            pr_.save_state(args.checkpoint)
    else:
        img = render_frame(scene, cfg)
    _report(args, cfg, scene, img, t0, compile_s,
            cfg.samples_per_pixel * max(1, args.progressive))
    return 0


if __name__ == "__main__":
    sys.exit(main())
