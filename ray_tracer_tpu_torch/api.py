"""Top-level rendering API (port of ``ray_tracer_tpu/api.py``).

* :func:`render` / :func:`render_frame`: one frame.  The image is tiled
  into ``cfg.max_rays_per_batch``-pixel chunks only to bound the live
  state.  As in the JAX package, ``path_regen`` with the ``"mis"``
  estimator traces each tile's samples in one path-regeneration
  wavefront; anything else runs the static scan one sample at a time.
* :class:`ProgressiveRenderer`: progressive accumulation with camera and
  scene resets and checkpoint/resume (the JAX package's ``np.savez``
  state, loadable by either package).
* :func:`render_debug`: the BVH-cost heatmaps.

Everything runs on the device of the scene's tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import RenderConfig
from .integrator import film, wavefront
from .scene.types import Camera, CompiledScene
from .utils.transforms import camera_rotation


def _camera_arrays(cam: Camera, cfg: RenderConfig, device):
    """(rotation (3,3), position (3,), fov, aspect, near) as f32 tensors."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return (
        f32(camera_rotation(cam.angles_deg)),
        f32(cam.position),
        f32(cam.fov),
        f32(cfg.width / cfg.height),
        f32(cam.near_plane),
    )


def scene_camera(scene: CompiledScene) -> Camera:
    pos, angles, fov, near = scene.meta.get(
        "camera", ((0.0, -0.5, -3.5), (4.0, 0.0, 0.0), 50.0, 0.1)
    )
    return Camera(position=pos, angles_deg=angles, fov=fov, near_plane=near)


def trace_pixels(scene: CompiledScene, cfg: RenderConfig, camera: Camera,
                 pixel_id: torch.Tensor, frame: int, n_samples: int,
                 sample_base: int = 0) -> torch.Tensor:
    """Trace ``n_samples`` samples of each listed pixel -> (N,3) float32
    mean radiance, on the scene's device.  The pixels are traced in tiles
    of ``cfg.max_rays_per_batch``, the last one padded with its last
    pixel; ``path_regen`` with the ``"mis"`` estimator traces each tile in
    one wavefront, anything else through the static scan one sample at a
    time."""
    dev = scene.device
    rot, pos, fov, aspect, near = _camera_arrays(camera, cfg, dev)
    n = pixel_id.shape[0]
    tile = max(1, min(n, cfg.max_rays_per_batch))
    outs = []
    for start in range(0, n, tile):
        at = torch.clamp(torch.arange(start, start + tile, device=dev),
                         max=n - 1)
        ids = pixel_id[at]
        if cfg.wavefront:
            acc = wavefront.trace_wave(
                scene, rot, pos, fov, aspect, near, ids, frame, sample_base,
                n_samples, cfg,
            )
        else:
            acc = torch.zeros((tile, 3), dtype=torch.float32, device=dev)
            for s in range(n_samples):
                acc = acc + wavefront.render_sample(
                    scene, rot, pos, fov, aspect, near, ids, frame,
                    sample_base + s, cfg,
                )
        outs.append(acc / n_samples)
    return torch.cat(outs)[:n]


def render_frame(
    scene: CompiledScene,
    cfg: RenderConfig,
    camera: Optional[Camera] = None,
    frame: int = 0,
    n_samples: Optional[int] = None,
    sample_base: int = 0,
) -> torch.Tensor:
    """Trace one frame (``n_samples`` spp, default the config's) -> (H,W,3)
    float32 mean radiance, on the scene's device."""
    cfg.check()
    spp = cfg.samples_per_pixel if n_samples is None else n_samples
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=scene.device)
    out = trace_pixels(scene, cfg, camera or scene_camera(scene), ids, frame,
                       spp, sample_base)
    return out.reshape(cfg.height, cfg.width, 3)


def render(
    scene: CompiledScene, cfg: RenderConfig, camera: Optional[Camera] = None
) -> torch.Tensor:
    """Single render to cfg.samples_per_pixel spp."""
    return render_frame(scene, cfg, camera, frame=0)


class ProgressiveRenderer:
    """Progressive accumulation: each :meth:`step` traces one frame and
    blends it in with weight ``1/(frame+1)``; a camera move or a new scene
    restarts it.  ``accum`` lives on the scene's device."""

    def __init__(self, scene: CompiledScene, cfg: RenderConfig,
                 camera: Optional[Camera] = None) -> None:
        self.scene = scene
        self.cfg = cfg
        self.camera = camera or scene_camera(scene)
        self._reset()

    def _reset(self) -> None:
        self.accum = torch.zeros((self.cfg.height, self.cfg.width, 3),
                                 dtype=torch.float32,
                                 device=self.scene.device)
        self.frame = 0
        self.total_samples = 0

    def step(self, n_samples: Optional[int] = None) -> torch.Tensor:
        spp = n_samples or self.cfg.samples_per_pixel
        color = render_frame(self.scene, self.cfg, self.camera,
                             frame=self.frame, n_samples=spp,
                             sample_base=self.total_samples)
        self.accum = film.progressive_blend(self.accum, color, self.frame)
        self.frame += 1
        self.total_samples += spp
        return self.accum

    def move_camera(self, camera: Camera) -> None:
        """A camera move restarts accumulation."""
        self.camera = camera
        self._reset()

    def set_scene(self, scene: CompiledScene) -> None:
        """Swap in a recompiled scene (a live edit) and restart
        accumulation, on the new scene's device."""
        self.scene = scene
        self._reset()

    def save_state(self, path: str) -> None:
        """``accum`` (copied to the host), ``frame``, ``total_samples`` and
        ``seed`` to ``np.savez``: the JAX package's file format."""
        np.savez(path, accum=self.accum.cpu().numpy(), frame=self.frame,
                 total_samples=self.total_samples, seed=self.cfg.seed)

    def load_state(self, path: str) -> None:
        """Resume from :meth:`save_state`'s file (either package's); raises
        ``ValueError`` on another seed or image size."""
        with np.load(path) as z:
            if int(z["seed"]) != self.cfg.seed:
                raise ValueError(f"seed mismatch on resume: the state has "
                                 f"{int(z['seed'])}, the config "
                                 f"{self.cfg.seed}")
            accum = np.asarray(z["accum"], np.float32)
            if accum.shape != tuple(self.accum.shape):
                raise ValueError(f"the state's image is {accum.shape}, the "
                                 f"config's {tuple(self.accum.shape)}")
            self.accum = torch.from_numpy(accum).to(self.scene.device)
            self.frame = int(z["frame"])
            self.total_samples = int(z["total_samples"])


def debug_counts(scene: CompiledScene, cfg: RenderConfig,
                 camera: Optional[Camera] = None):
    """Per-pixel ``(box_tests, tri_tests)``, (H,W) f32 each, summed over the
    whole path (primary, every bounce, the NEE shadow rays) and all
    ``cfg.samples_per_pixel`` samples of frame 0: the static scan with the
    counting walk, as the reference threads one ``stats[2]`` through every
    traversal (raytrace.comp:276,443,496,572)."""
    cfg.check()
    dev = scene.device
    cam = camera or scene_camera(scene)
    rot, pos, fov, aspect, near = _camera_arrays(cam, cfg, dev)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
    rays = wavefront.raygen(rot, pos, fov, aspect, near, ids, cfg.width,
                            cfg.height)
    box = torch.zeros(cfg.n_pixels, dtype=torch.float32, device=dev)
    tri = torch.zeros_like(box)
    for s in range(cfg.samples_per_pixel):
        _, (b, t) = wavefront.trace(scene, rays, ids, 0, s, cfg,
                                    with_heatmap=True)
        box, tri = box + b, tri + t
    return (box.reshape(cfg.height, cfg.width),
            tri.reshape(cfg.height, cfg.width))


def render_debug(scene: CompiledScene, cfg: RenderConfig,
                 camera: Optional[Camera] = None, mode: int = 2,
                 box_cap: float = 200.0, tri_cap: float = 50.0
                 ) -> torch.Tensor:
    """BVH-cost heatmaps, the reference's debug views
    (raytrace.comp:583-591), of :func:`debug_counts` -> (H,W,3) in [0,1]
    on the scene's device.

    mode 0: box tests / ``box_cap`` in gray, red above the cap; mode 1:
    triangle tests / ``tri_cap`` likewise; mode 2: red = box tests /
    ``box_cap``, blue = triangle tests / ``tri_cap``.  The caps default to
    the reference's (vk_engine.h:168-169).
    """
    box, tri = debug_counts(scene, cfg, camera)
    red = box.new_tensor([1.0, 0.0, 0.0])
    if mode in (0, 1):
        count, cap = (box, box_cap) if mode == 0 else (tri, tri_cap)
        img = (count / cap)[..., None].expand(-1, -1, 3)
        img = torch.where((count > cap)[..., None], red, img)
    else:
        zero = torch.zeros_like(box)
        img = torch.stack([box / box_cap, zero, tri / tri_cap], dim=-1)
    return torch.clamp(img, 0.0, 1.0)
