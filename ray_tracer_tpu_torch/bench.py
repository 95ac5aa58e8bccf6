"""The bench: Mrays/s of the benchmark frame on one CUDA device.

    python -m ray_tracer_tpu_torch.bench
    RT_TWO_PHASE=1 python -m ray_tracer_tpu_torch.bench
    RT_BENCH_CPU=1 RT_BENCH_WIDTH=32 RT_BENCH_HEIGHT=18 \\
        RT_BENCH_SCENE=sponza_proxy:20000 python -m ray_tracer_tpu_torch.bench

The counterpart of the JAX package's ``bench.py``: the same knobs, scenes,
tiling and ray counts, and its JSON line as the last line of stdout.

Knobs, with the JAX bench's names and defaults:

* ``RT_BENCH_WIDTH`` 1920, ``RT_BENCH_HEIGHT`` 1080, ``RT_BENCH_SPP`` 2;
* ``RT_BENCH_SCENE`` ``sponza_proxy``: also ``sponza_proxy:N`` (the
  proxy at a target of N triangles), ``cornell`` (the default Cornell
  scene) or the name of a mesh in the assets directory, set in the
  Cornell box; the asset-backed scenes read ``$RT_ASSETS`` and raise
  ``FileNotFoundError`` naming a missing file;
* ``RT_BENCH_TILE_LOG2`` 21: pixels per tile, ``2**21`` holding a
  1920x1080 frame in one;
* ``RT_BENCH_CPU``: when set, run on the CPU through the kernels' plain
  versions (rehearsals and tests; the line then says ``"device": "cpu"``
  and ``"gate": "cpu"``).

The route comes from the ``RT_*`` routing variables
(``config.Routing.from_env``; unset ones leave the defaults), and the
scene is compiled with the tables that route reads: rope streams for
``RT_LANEWALK=force``, cluster tables for ``RT_CLUSTER=on``.

On the card a gate runs before any timing: the scene and route rendered
at 64x36, spp 2, bounce limit 8, on the card and on the CPU, must agree
(:func:`images_agree`).  Then frame 0 warms up (kernel builds, the
allocator) and frame 1 is timed three times, each on the host clock
between two synchronisations; ``value`` is the semantic rays over the
median time.  The three runs must agree (:data:`REPEAT_RTOL`), and the
line says whether they agree bit for bit.

Exit codes: 0 with the line printed; 1 when the gate fails or the run
raises (a kernel fault included), with no line; 2 without a CUDA device
and without ``RT_BENCH_CPU``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .api import _camera_arrays, render, scene_camera
from .config import RenderConfig, Routing
from .integrator import wavefront
from .kernels import cluster, group, lanewalk, packet, shade
from .scene import presets

KERNEL_MODULES = (group, packet, cluster, lanewalk, shade)  # launch counters
GATE_SIZE = (64, 36)  # the card-vs-CPU render: spp 2, bounce limit 8
TIMED = 3  # timed runs of frame 1
# The timed runs' checksums and ray counts agree within this relative
# difference (a path that parts at a tie moves a few of the frame's
# millions of rays and one sample's radiance).
REPEAT_RTOL = 1e-4
BOUNCE_LIMIT = 8


class GateFailed(RuntimeError):
    """The card's render disagrees with the CPU's."""


def env_knobs(env=None) -> dict:
    """:func:`run`'s arguments from the ``RT_BENCH_*`` variables."""
    env = os.environ if env is None else env
    return dict(
        width=int(env.get("RT_BENCH_WIDTH", 1920)),
        height=int(env.get("RT_BENCH_HEIGHT", 1080)),
        spp=int(env.get("RT_BENCH_SPP", 2)),
        scene=env.get("RT_BENCH_SCENE", "sponza_proxy"),
        tile_log2=int(env.get("RT_BENCH_TILE_LOG2", 21)),
        cpu=bool(env.get("RT_BENCH_CPU")),
    )


def build_scene(name: str, routing: Routing, device):
    """The JAX bench's scene ``name`` compiled on ``device``, with the
    rope streams or cluster tables that ``routing`` reads."""
    if name.startswith("sponza_proxy"):
        n_target = int(name.split(":")[1]) if ":" in name else 260_000
        builder = presets.sponza_proxy(n_target)
    elif name == "cornell":
        builder = presets.default_scene(presets.DEFAULT_ASSETS)
    else:
        # a mesh inside the Cornell box, as the JAX bench places it
        builder = presets.mesh_scene(
            name, material=presets.WHITE, scale=0.15,
            position=(0.0, 0.5, 0.0), assets=presets.DEFAULT_ASSETS)
    return builder.compile(
        clusters=True if routing.cluster == "on" else None,
        rope_streams=routing.lanewalk == "force", device=device)


def reset_launches() -> None:
    for m in KERNEL_MODULES:
        m.reset_launches()


def all_launches() -> dict:
    return {k: v for m in KERNEL_MODULES for k, v in m.launches.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tile_ids(t: int, tile: int, n_pix: int, device) -> torch.Tensor:
    """Pixel ids of tile ``t``; the last tile's lanes past the frame repeat
    pixel ``n_pix - 1``, so they trace and count, as in the JAX bench."""
    ids = t * tile + torch.arange(tile, dtype=torch.int32, device=device)
    return torch.clamp(ids, max=n_pix - 1)


def frame_stats(scene, cam, cfg: RenderConfig, spp: int, frame: int):
    """One frame in tiles of ``cfg.max_rays_per_batch`` pixels, each one
    ``trace_wave`` of all ``spp`` samples -> (checksum, (semantic, traced)
    ray counts): the sum of each tile's float32 color sum, and the counts
    summed in float64."""
    dev = scene.device
    n_pix = cfg.n_pixels
    tile = min(n_pix, cfg.max_rays_per_batch)
    checksum, n_rays = 0.0, np.zeros(2)
    for t in range(-(-n_pix // tile)):
        acc, nr = wavefront.trace_wave(
            scene, *cam, tile_ids(t, tile, n_pix, dev), frame, 0, spp, cfg,
            with_stats=True)
        checksum += float(acc.sum())
        n_rays += nr.cpu().numpy()
    return checksum, n_rays


def measure(scene, cfg: RenderConfig, spp: int, timed: int = TIMED,
            warmup: bool = True) -> dict:
    """The bench's measurement: frame 0 once (unless ``warmup`` is False),
    then frame 1 ``timed`` times on the host clock between two
    synchronisations.  Returns the median and every time, the checksum and
    ray counts (which every run must repeat within :data:`REPEAT_RTOL`),
    whether they repeat bit for bit, the launches of the last run and, on
    the card, its peak allocated bytes over the timed runs."""
    dev = scene.device
    cam = _camera_arrays(scene_camera(scene), cfg, dev)
    if warmup:
        frame_stats(scene, cam, cfg, spp, 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times, runs = [], []
    for _ in range(timed):
        reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        checksum, n_rays = frame_stats(scene, cam, cfg, spp, 1)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        runs.append(np.array([checksum, *n_rays]))
    launches = all_launches()
    first = runs[0]
    if not all(np.allclose(r, first, rtol=REPEAT_RTOL, atol=0.0)
               for r in runs):
        raise RuntimeError(f"the timed runs disagree: (checksum, rays_sem, "
                           f"rays_traced) = {[r.tolist() for r in runs]}")
    return dict(
        frame_s=statistics.median(times), frame_s_all=times,
        checksum=float(first[0]), rays_sem=float(first[1]),
        rays_traced=float(first[2]),
        repeats_bitwise=all(np.array_equal(r, first) for r in runs),
        launches=launches,
        max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    )


def images_agree(img: torch.Tensor, ref: torch.Tensor) -> dict:
    """``img`` (the card's render) against ``ref`` (the CPU's): they agree
    where ``img`` is finite, >= 99% of pixels lie within 2e-3 in every
    channel and the mean |diff| is below 1e-3."""
    img = img.cpu()
    diff = (img - ref).abs()
    within = float((diff.amax(dim=-1) <= 2e-3).float().mean())
    mean = float(diff.mean())
    finite = bool(torch.isfinite(img).all())
    return dict(pixels_within_2e3=within, mean_abs_diff=mean,
                max_abs_diff=float(diff.max()), finite=finite,
                agree=finite and within >= 0.99 and mean < 1e-3)


def gate(scene, routing: Routing) -> dict:
    """:func:`images_agree` of ``scene`` rendered through ``routing`` at
    :data:`GATE_SIZE`, spp 2, on its device and on the CPU."""
    cfg = RenderConfig(width=GATE_SIZE[0], height=GATE_SIZE[1],
                       samples_per_pixel=2, bounce_limit=BOUNCE_LIMIT,
                       routing=routing)
    card = render(scene, cfg)
    return images_agree(card, render(scene.to("cpu"), cfg))


def power_limit_w():
    """The card's power limit in W as ``nvidia-smi`` reports it, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.splitlines()[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def run(width: int = 1920, height: int = 1080, spp: int = 2,
        scene: str = "sponza_proxy", tile_log2: int = 21, cpu: bool = False,
        timed: int = TIMED) -> dict:
    """The bench's line: ``scene`` compiled for the route of the ``RT_*``
    variables, the gate on the card, then :func:`measure`.  ``cpu`` runs
    on the CPU without the gate; without it, no CUDA device raises."""
    if cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        raise RuntimeError("no CUDA device (RT_BENCH_CPU=1 runs on the CPU)")
    cfg = RenderConfig(width=width, height=height, bounce_limit=BOUNCE_LIMIT,
                       max_rays_per_batch=1 << tile_log2)
    routing = cfg.resolved_routing()
    t0 = time.perf_counter()
    sc = build_scene(scene, routing, dev)
    _sync(sc.device)
    compile_s = time.perf_counter() - t0
    if cpu:
        verdict, gate_stats = "cpu", None
    else:
        gate_stats = gate(sc, routing)
        if not gate_stats["agree"]:
            raise GateFailed(f"the card's {GATE_SIZE[0]}x{GATE_SIZE[1]} "
                             f"render disagrees with the CPU's: {gate_stats}")
        verdict = "pass"
    m = measure(sc, cfg, spp, timed)
    dt = m["frame_s"]
    return {
        "metric": f"Mrays/s {scene} @{width}x{height} spp{spp} b8",
        "value": m["rays_sem"] / dt / 1e6,
        "unit": "Mrays/s",
        "rays_sem": m["rays_sem"],
        "rays_traced": m["rays_traced"],
        "mrays_traced": m["rays_traced"] / dt / 1e6,
        "frame_s": dt,
        "frame_s_all": m["frame_s_all"],
        "checksum": m["checksum"],
        "repeats_bitwise": m["repeats_bitwise"],
        "device": "cpu" if cpu else torch.cuda.get_device_name(dev),
        "power_limit_w": None if cpu else power_limit_w(),
        "routing": dataclasses.asdict(routing),
        "launches": m["launches"],
        "gate": verdict,
        "gate_stats": gate_stats,
        "compile_s": compile_s,
        # against the walks' limits: binary depth (MAX_TREE_DEPTH), the
        # TOP table (no rows: beyond the TOP walk's limits)
        "scene_stats": {
            "n_tris": sc.meta["n_tris"],
            "bvh_max_depth": sc.meta["bvh_max_depth"],
            "wide_nodes": int(sc.wide_packed.shape[0]),
            "top_rows": int(sc.wide_top.shape[0]),
            "n_treelets": sc.meta["n_treelets"]},
        "max_memory_allocated": m["max_memory_allocated"],
    }


def main() -> int:
    knobs = env_knobs()
    if not knobs["cpu"] and not torch.cuda.is_available():
        print("bench: no CUDA device; RT_BENCH_CPU=1 runs on the CPU",
              file=sys.stderr)
        return 2
    try:
        record = run(**knobs)
    except GateFailed as e:
        print(f"bench: gate failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
