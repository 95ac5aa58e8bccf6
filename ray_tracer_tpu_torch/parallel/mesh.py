"""Multi-device rendering over ``torch.distributed`` (port of
``ray_tracer_tpu/parallel/mesh.py``).

One process per device: NCCL between CUDA devices, gloo on the CPU.  The
world's ranks form a (data, sample) grid, the renderer's two
embarrassingly parallel axes:

* ``data``: each rank path-traces its shard of the pixels against its own
  full copy of the scene;
* ``sample``: the ranks of one pixel shard trace disjoint sample indices
  of the same pixels, and their means are averaged (``all_reduce``).

The pixel shards are then gathered (``all_gather``), so every rank holds
the whole image.  The RNG is counter-based on (pixel, sample), so the
mesh shape does not change the sampled paths: the data axis moves no bit,
the sample axis only the order of a sum.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..api import scene_camera, trace_pixels
from ..config import RenderConfig
from ..scene.types import Camera, CompiledScene

@dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, sample) grid and the sub-groups of
    its two axes: ``data_group`` holds the ranks of its sample index (one
    per pixel shard, in data order), ``sample_group`` those of its pixel
    shard (one per sample slice)."""

    n_data: int
    n_sample: int
    my_data: int
    my_sample: int
    data_group: object
    sample_group: object


def make_mesh(n_data: Optional[int] = None, n_sample: int = 1,
              group=None) -> Mesh:
    """Put the ranks of ``group`` (default: the world) on an
    ``(n_data, n_sample)`` grid, rank ``r`` at ``(r // n_sample,
    r % n_sample)``.  Every rank of the group must call it, with the same
    shape: it creates the sub-groups of both axes."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_data is None:
        n_data = world // n_sample
    if n_data < 1 or n_sample < 1 or n_data * n_sample != world:
        raise ValueError(f"a ({n_data}, {n_sample}) mesh does not use the "
                         f"{world} ranks of the group")
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(world)))
    my_data, my_sample = divmod(rank, n_sample)
    data_group = sample_group = None
    # every rank creates every sub-group, in one order
    for s in range(n_sample):
        g = dist.new_group([ranks[d * n_sample + s] for d in range(n_data)])
        if s == my_sample:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([ranks[d * n_sample + s]
                            for s in range(n_sample)])
        if d == my_data:
            sample_group = g
    return Mesh(n_data, n_sample, my_data, my_sample, data_group,
                sample_group)


def render_frame_sharded(scene: CompiledScene, cfg: RenderConfig,
                         mesh: Mesh, camera: Optional[Camera] = None,
                         frame: int = 0) -> torch.Tensor:
    """The whole frame -> (H,W,3) float32 on the scene's device, on every
    rank of the mesh.

    The pixel ids are padded to a multiple of ``n_data`` with pixel 0 and
    split into contiguous shards; this rank traces its shard's samples
    ``my_sample * spp / n_sample`` onwards with the production wavefront
    (the static scan for the other estimators), the sample axis averages,
    and the data axis gathers the shards."""
    cfg.check()
    spp = cfg.samples_per_pixel
    if spp % mesh.n_sample:
        raise ValueError(f"{spp} samples per pixel do not split over "
                         f"{mesh.n_sample} sample ranks")
    dev = scene.device
    n_pix = cfg.n_pixels
    pad = (-n_pix) % mesh.n_data
    ids = torch.arange(n_pix + pad, dtype=torch.int32, device=dev)
    ids = torch.where(ids < n_pix, ids, 0)  # pad lanes re-trace pixel 0
    shard = ids.view(mesh.n_data, -1)[mesh.my_data].contiguous()
    spp_local = spp // mesh.n_sample
    color = trace_pixels(scene, cfg, camera or scene_camera(scene), shard,
                         frame, spp_local, mesh.my_sample * spp_local)
    dist.all_reduce(color, group=mesh.sample_group)
    color = color / mesh.n_sample
    parts = [torch.empty_like(color) for _ in range(mesh.n_data)]
    dist.all_gather(parts, color, group=mesh.data_group)
    return torch.cat(parts)[:n_pix].reshape(cfg.height, cfg.width, 3)


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_from_env(cpu: bool = False) -> Tuple[int, int, torch.device]:
    """Join the process group described by ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or without it form a world of one on a free loopback
    port.  NCCL with this rank's CUDA device (``LOCAL_RANK``), or gloo on
    the CPU under ``cpu`` -> ``(rank, world_size, device)``."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        rank, world = 0, 1
        init = f"tcp://127.0.0.1:{free_port()}"
    if cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass cpu=True (--cpu) for "
                               "a gloo world on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {} if cpu else dict(device_id=device)
        dist.init_process_group("gloo" if cpu else "nccl", init_method=init,
                                rank=rank, world_size=world, **kw)
    return dist.get_rank(), dist.get_world_size(), device
