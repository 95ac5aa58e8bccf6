"""Next-event estimation over the scene's rect-light table: a uniform
light pick, a uniform point on it, and the solid-angle pdf
``dst^2 / (cos_theta * area)`` (``shaders/raytrace.comp:368-403``)."""

from __future__ import annotations

import torch

from ..ops.intersect import dot, norm


def sample_rect_light(scene, origin, r_pick, r1, r2):
    """Pick a light uniformly, sample a point on it.

    Returns (direction (N,3) normalized, light index (N,), number of lights
    (the inverse selection pdf), distance (N,)).
    """
    n_lights = scene.n_lights
    if n_lights <= 1:
        li = torch.zeros(r_pick.shape, dtype=torch.int32, device=r_pick.device)
        corner = scene.light_corner[0]
        edge_u, edge_v = scene.light_edge_u[0], scene.light_edge_v[0]
    else:
        li = torch.clamp((r_pick * n_lights).to(torch.int32), max=n_lights - 1)
        corner = scene.light_corner[li]
        edge_u, edge_v = scene.light_edge_u[li], scene.light_edge_v[li]
    point = corner + edge_u * r1[:, None] + edge_v * r2[:, None]
    vec = point - origin
    dist = norm(vec)
    direction = vec / torch.clamp(dist, min=1e-20)[:, None]
    return direction, li, float(n_lights), dist


def rect_light_pdf_analytic(scene, li, direction, dist):
    """Solid-angle pdf of a sampled light point at the known distance
    ``dist`` (the unoccluded value of the reference's raycast).  A back-side
    sample yields a NEGATIVE pdf, which trips the bad-sample zeroing."""
    if scene.n_lights <= 1:
        normal, area = scene.light_normal[0], scene.light_area[0]
    else:
        normal, area = scene.light_normal[li], scene.light_area[li]
    cos_theta = dot(normal, direction)
    return dist * dist / (cos_theta * area)


def rect_light_emission(scene, li):
    """Emission radiance of light ``li`` via its material slot."""
    if scene.n_lights <= 1:
        mat = scene.light_mat[0]
        return (scene.mat_emission[mat] * scene.mat_emission_strength[mat])[
            None, :
        ]
    mat = scene.light_mat[li]
    return scene.mat_emission[mat] * scene.mat_emission_strength[mat][:, None]


def rect_light_pdf(scene, li, direction, hit_dst, hit_emissive):
    """Solid-angle pdf of the sampled direction given the shadow ray's
    closest hit (``lightSamplePDF``, raytrace.comp:389-403): zero unless
    the ray reached an emissive surface, else ``dst^2 / (cos * area)``."""
    li = li.long()
    cos_theta = dot(scene.light_normal[li], direction)
    pdf = hit_dst * hit_dst / (cos_theta * scene.light_area[li])
    return torch.where(hit_emissive, pdf, 0.0)
