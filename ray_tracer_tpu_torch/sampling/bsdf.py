"""BSDF sampling helpers (batched, branchless): the reference's lobe math
(``shaders/raytrace.comp:177-181,405-481``) as tensor functions."""

from __future__ import annotations

import math

import torch

from ..ops.intersect import cross, dot, norm, sqrt

INV_PI = 0.3183098862  # raytrace.comp:7; f32 on use, as in the JAX package


def cosine_hemisphere_dir(normal, r1, r2):
    """Cosine-weighted hemisphere sample via the reference's Gram-Schmidt
    ONB (raytrace.comp:405-424)."""
    phi = 2.0 * math.pi * r1
    sqrt_r2 = sqrt(r2)
    x = torch.cos(phi) * sqrt_r2
    y = torch.sin(phi) * sqrt_r2
    z = sqrt(1.0 - r2)

    ex = normal.new_tensor([1.0, 0.0, 0.0])
    ez = normal.new_tensor([0.0, 0.0, 1.0])
    non_parallel = torch.where(
        (torch.abs(normal[:, 0]) < 1.0)[:, None], ex, ez
    )
    t = cross(normal, non_parallel)
    t = t / torch.clamp(norm(t, keepdim=True), min=1e-20)
    b = cross(normal, t)
    return t * x[:, None] + b * y[:, None] + normal * z[:, None]


def cosine_hemisphere_pdf(normal, direction):
    """raytrace.comp:426-428."""
    return torch.clamp(dot(direction, normal) * INV_PI, min=0.0)


def uniform_hemisphere_dir(normal, r1, r2):
    """Uniform hemisphere sample (pdf 1/2pi) for the ``estimator="uniform"``
    ablation: a uniform sphere point mirrored into the normal's
    hemisphere."""
    phi = 2.0 * math.pi * r1
    z = 2.0 * r2 - 1.0
    s = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)
    return torch.where((dot(d, normal) < 0.0)[:, None], -d, d)


def schlick(cosine, refraction_index):
    """raytrace.comp:177-181."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))  # x**5 as jax.lax.integer_pow
