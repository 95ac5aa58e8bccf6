"""ray_tracer_tpu_torch: the PyTorch + CUDA port of ray_tracer_tpu.

A Monte-Carlo path tracer for NVIDIA Hopper: plain tensor code in torch
and hand-written CUDA kernels for traversal (``csrc/``: the BVH8 walk,
the cluster tests).  It imports no JAX; the JAX package beside it is the
reference its tests compare against.  Native libraries (the kernels, the
C++ scene-compiler helpers) are built on first
use, so importing the package needs neither a GPU nor a compiler.
"""

from .api import (
    ProgressiveRenderer,
    render,
    render_debug,
    render_frame,
    scene_camera,
)
from .config import RenderConfig, Routing
from .scene.builder import SceneBuilder
from .scene.types import Camera, CompiledScene, Environment, Material

__all__ = [
    "ProgressiveRenderer",
    "render",
    "render_debug",
    "render_frame",
    "scene_camera",
    "RenderConfig",
    "Routing",
    "SceneBuilder",
    "Camera",
    "CompiledScene",
    "Environment",
    "Material",
]
