"""Entry points of the multi-device path: a one-sample compile-and-run
check (:func:`entry`) and the multi-process dry run
(:func:`dryrun_multichip`), the port's counterparts of the JAX package's
``__graft_entry__.py``.

Both render an asset-free scene with triangles and a rect light
(:func:`demo_scene`: ``sponza_proxy`` cut to its smallest size), on the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..api import _camera_arrays, scene_camera
from ..config import RenderConfig, Routing
from ..integrator import wavefront
from ..scene import presets
from . import mesh as pmesh


def demo_scene(device=None):
    """``sponza_proxy`` at its smallest (three columns a row, about 30k
    triangles; no asset file) compiled on ``device`` (default: the CUDA
    device)."""
    return presets.sponza_proxy(n_tris_target=8000).compile(device=device)


def entry(device=None):
    """``(fn, example_args)``: ``fn`` path-traces one sample of each pixel
    of a 64x64 batch of :func:`demo_scene` through the static scan,
    ``fn(*example_args)`` -> (4096, 3)."""
    cfg = RenderConfig(width=64, height=64, samples_per_pixel=1,
                       bounce_limit=4)
    scene = demo_scene(device)
    rot, pos, fov, aspect, near = _camera_arrays(scene_camera(scene), cfg,
                                                 scene.device)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=scene.device)

    def fn(scene, rot, pos, fov, aspect, near, ids, frame, sample):
        rays = wavefront.raygen(rot, pos, fov, aspect, near, ids, cfg.width,
                                cfg.height)
        return wavefront.trace(scene, rays, ids, frame, sample, cfg)

    return fn, (scene, rot, pos, fov, aspect, near, ids, 0, 0)


def images_match(img, ref, atol=2e-3, max_diverged=0.01) -> bool:
    """Pixels within ``atol`` except at most a ``max_diverged`` fraction,
    and within ``atol`` on average: two routes differ only where an
    exact-t tie picks another triangle and a path takes the other side."""
    diff = np.abs(np.asarray(img) - np.asarray(ref)).max(axis=-1)
    return bool((diff > atol).mean() <= max_diverged
                and diff.mean() <= atol)


def spawn(fn, n: int, args=(), timeout: float = 600.0) -> None:
    """Run ``fn(rank, n, *args)`` in ``n`` fresh processes and wait for all
    of them, at most ``timeout`` seconds in all; on expiry every process
    still running is killed.  Raises ``RuntimeError`` where a process
    failed or did not finish."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, n, *args)) for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if late:
        raise RuntimeError(f"ranks {late} of {n} did not finish within "
                           f"{timeout} s (killed)")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks failed (rank, exit code): {bad}")


def init_rank(rank: int, world: int, store: str, cpu: bool):
    """Join a ``world``-rank group through the file store ``store``: gloo
    on the CPU, else NCCL on CUDA device ``rank``; one torch thread on the
    CPU.  -> the rank's device."""
    if cpu:
        torch.set_num_threads(1)
        device = torch.device("cpu")
        kw = {}
    else:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        kw = dict(device_id=device)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world, **kw)
    return device


def _dryrun_rank(rank, n, store, cpu, out):
    device = init_rank(rank, n, store, cpu)
    try:
        summary = _dryrun(n, device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(summary, f)


def _dryrun(n, device):
    spp = 8
    cfg = RenderConfig(width=64, height=40, samples_per_pixel=spp,
                       bounce_limit=2)
    scene = demo_scene(device)
    shapes = [(n, 1)]
    if n % 2 == 0:
        shapes.append((n // 2, 2))
    if spp % n == 0 and n > 1:
        shapes.append((1, n))
    imgs = {}
    for n_data, n_sample in shapes:
        m = pmesh.make_mesh(n_data=n_data, n_sample=n_sample)
        img = pmesh.render_frame_sharded(scene, cfg, m).cpu().numpy()
        if img.shape != (cfg.height, cfg.width, 3) or \
                not np.isfinite(img).all():
            raise AssertionError(f"mesh {(n_data, n_sample)}: bad image "
                                 f"{img.shape}")
        imgs[(n_data, n_sample)] = img
    base = imgs[shapes[0]]
    for k, img in imgs.items():
        np.testing.assert_allclose(img, base, atol=1e-5,
                                   err_msg=f"mesh {k} diverges from "
                                           f"{shapes[0]}")
    # route pass: the group kernel (closest hit and occlusion) against the
    # narrow walk, on the (n, 1) mesh
    cfg_g = RenderConfig(width=32, height=24, samples_per_pixel=2,
                         bounce_limit=2)
    cfg_n = cfg_g.replace(routing=Routing(wide=False))
    m = pmesh.make_mesh(n_data=n, n_sample=1)
    img_g = pmesh.render_frame_sharded(scene, cfg_g, m).cpu().numpy()
    img_n = pmesh.render_frame_sharded(scene, cfg_n, m).cpu().numpy()
    if not (np.isfinite(img_g).all() and images_match(img_g, img_n)):
        raise AssertionError("the sharded group route diverges from the "
                             "narrow route")
    return dict(meshes=list(imgs), mean=float(base.mean()),
                route_mean_diff=float(np.abs(img_g - img_n).mean()))


def dryrun_multichip(n_devices: int, cpu: bool = False,
                     timeout: float = 600.0) -> dict:
    """Spawn ``n_devices`` ranks (NCCL, one CUDA device each; gloo on the
    CPU under ``cpu``) and render :func:`demo_scene` at 64x40, spp 8,
    bounce 2 on the meshes (n, 1), (n/2, 2) where n is even and (1, n)
    where n divides 8: the images must agree at atol 1e-5.  Then the
    group route against the narrow route on the (n, 1) mesh, under the
    image tolerance of :func:`images_match`.  -> rank 0's summary."""
    with tempfile.TemporaryDirectory(prefix="rt_dryrun_") as tmp:
        out = os.path.join(tmp, "summary")
        spawn(_dryrun_rank, n_devices,
              (os.path.join(tmp, "store"), cpu, out), timeout)
        with open(out) as f:
            summary = json.load(f)
    print(f"dryrun_multichip ok: meshes {summary['meshes']}, mean "
          f"{summary['mean']:.6f}, shard-count invariant; group route "
          f"against the narrow route: mean |diff| "
          f"{summary['route_mean_diff']:.2e}")
    return summary
