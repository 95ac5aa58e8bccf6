"""The plain reference path tracer, in plain torch: what each pixel of a
progressive render should hold after ``n_frames`` steps.

One sample of one pixel is a pure function of ``(seed, pixel, frame,
sample)``: the camera ray through the pixel's corner (no jitter), then up
to ``bounce_limit + 1`` bounces, each
- closest hit; the pending light resolve of the reference renderer (the
  emission at a delta bounce or at the camera's first hit, else the
  ``direct`` light that the previous vertex's shadow ray found), the sky
  on an escape;
- the diffuse lobe: a cosine-weighted direction through the Gram-Schmidt
  frame of the shading normal, the rect light sampled uniformly by area,
  its shadow ray by occlusion, MIS by the power heuristic on the light
  side;
- russian roulette past ``rr_start_bounce``, survival clamped at
  ``rr_clamp``; a sample with NaN or negative radiance counts as black.
The samples of one step are summed in order and divided by their count;
the steps are blended with weight ``1 / (frame + 1)``, all in float32.

The arithmetic is written in the order of the reference renderer's
``raytrace.comp`` as its torch port writes it, so that the two agree to
the last bit wherever both take the same triangle.  Square roots go
through float64 to be correctly rounded on every device.  The geometry
(rays, hits, normals, the light's sample) takes ``rs.dtype``; the colour
(albedo, emission, the sky, the path's throughput and radiance, the
BSDF's and MIS's weights, roulette, the film blend) takes ``colour``,
``rs.dtype`` unless given.  The controls compute all of it, or only the
colour, in bfloat16.
"""

from __future__ import annotations

import math

import torch

from . import rng
from .scene import RefScene, camera_rotation
from .trace import closest, cross, dot, occluded

INV_PI = 0.3183098862
PATHS = 1 << 18  # paths traced together at most


def sqrt(x):
    return torch.sqrt(x.double()).to(x.dtype)


def norm(v, keepdim=False):
    n = sqrt(dot(v, v))
    return n.unsqueeze(-1) if keepdim else n


def camera_rays(cam: dict, width: int, height: int, pix, dtype):
    """The reference renderer's primary rays through the pixels' corners
    (``uv = pixel / dim``; the view plane at z = 0.1, sized by the near
    plane)."""
    dev = pix.device
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).to(dtype)
    rot = f(camera_rotation(cam["angles_deg"]))
    pos, fov = f(cam["position"]), f(cam["fov"])
    aspect, near = f(width / height), f(cam["near_plane"])
    x = (pix % width).to(dtype)
    y = torch.div(pix, width, rounding_mode="floor").to(dtype)
    u = x / width
    v = y / height
    plane_h = near * torch.tan(torch.deg2rad(fov * 0.5)) * 2.0
    plane_w = plane_h * aspect
    px = -plane_w / 2.0 + plane_w * u
    py = -plane_h / 2.0 + plane_h * v
    point = torch.stack([px, py, torch.full_like(px, 0.1)], dim=-1)
    d = point / norm(point, keepdim=True)
    d = torch.stack([d[:, 0] * rot[i, 0] + d[:, 1] * rot[i, 1]
                     + d[:, 2] * rot[i, 2] for i in range(3)], dim=-1)
    return pos.expand(d.shape), d


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sky(env: dict, d):
    """The procedural sky: a horizon-to-zenith gradient on ``-d.y`` (y
    points down), a ``pow(cos, focus)`` sun, and the ground below the
    horizon."""
    if not env["enabled"]:
        return torch.zeros_like(d)
    horizon, zenith, ground = env["horizon"], env["zenith"], env["ground"]
    light_dir = env["light_dir"]
    neg_y = -d[:, 1]
    sky_t = smoothstep(0.0, 0.4, neg_y) ** 0.35
    col = horizon[None, :] + (zenith - horizon)[None, :] * sky_t[:, None]
    cos_sun = torch.clamp(-(d[:, 0] * light_dir[0] + d[:, 1] * light_dir[1]
                            + d[:, 2] * light_dir[2]), min=0.0)
    sun = cos_sun ** env["sun_focus"] * env["sun_intensity"]
    ground_to_sky = smoothstep(-0.01, 0.0, neg_y)
    sun_mask = (ground_to_sky >= 1.0).to(d.dtype)
    return (ground[None, :] + (col - ground[None, :]) * ground_to_sky[:, None]
            + (sun * sun_mask)[:, None])


def cosine_dir(normal, r1, r2):
    phi = 2.0 * math.pi * r1
    s = sqrt(r2)
    x = torch.cos(phi) * s
    y = torch.sin(phi) * s
    z = sqrt(1.0 - r2)
    ex = normal.new_tensor([1.0, 0.0, 0.0])
    ez = normal.new_tensor([0.0, 0.0, 1.0])
    other = torch.where((torch.abs(normal[:, 0]) < 1.0)[:, None], ex, ez)
    t = cross(normal, other)
    t = t / torch.clamp(norm(t, keepdim=True), min=1e-20)
    b = cross(normal, t)
    return t * x[:, None] + b * y[:, None] + normal * z[:, None]


def cosine_pdf(normal, direction):
    return torch.clamp(dot(direction, normal) * INV_PI, min=0.0)


def shade_point(rs: RefScene, o, d, t, tri):
    """Hit point, unit shading normal (vertex normals interpolated by the
    barycentrics re-derived from the triangle, flipped to the ray's side),
    albedo and emission."""
    is_tri = tri >= 0
    k = torch.where(is_tri, tri, 0)
    hp = o + d * t[:, None]
    v0, e1, e2, n = rs.v0[k], rs.e1[k], rs.e2[k], rs.n_geo[k]
    d_eps = torch.where(d == 0.0, torch.full_like(d, 1e-20), d)
    q = cross(o - v0, d_eps)
    d0 = -dot(d_eps, n)
    dinv = 1.0 / torch.where(d0 == 0.0, torch.full_like(d0, 1e-20), d0)
    zero = torch.zeros_like(d0)
    hu = torch.where(is_tri, dot(e2, q) * dinv, zero)
    hv = torch.where(is_tri, -dot(e1, q) * dinv, zero)
    front = d0 >= 1e-8
    w = 1.0 - hu - hv
    vn = rs.vn[k]
    nrm = vn[:, 0] * w[:, None] + vn[:, 1] * hu[:, None] + vn[:, 2] * hv[:, None]
    nrm = nrm * torch.where(front, 1.0, -1.0).to(d.dtype)[:, None]
    normal = nrm / torch.clamp(norm(nrm, keepdim=True), min=1e-20)
    return hp, normal, rs.albedo[k], rs.emission[k]


def radiance(rs: RefScene, cfg: dict, o, d, pix, frame, sample, first,
             colour=None):
    """One sample's radiance for each path -> (N,3) in ``colour``.
    ``frame`` and ``sample`` are (N,) tensors; ``first`` is the camera
    rays' closest hit ``(distance, triangle)``."""
    n = o.shape[0]
    dt = rs.dtype
    ct = colour or dt
    dev = o.device
    f3 = lambda v: torch.full((n, 3), v, dtype=ct, device=dev)
    light = rs.light
    t, tri = first
    atten, total, direct = f3(1.0), f3(0.0), f3(0.0)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    bad = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(cfg["bounce_limit"] + 1):
        did = alive & (tri >= 0)
        hp, normal, albedo, emission = shade_point(rs, o, d, t, tri)
        albedo, emission = albedo.to(ct), emission.to(ct)

        was_delta = direct[:, 0] == -1.0
        final_light = torch.where(was_delta[:, None], emission, direct)
        contrib = final_light + emission if j == 0 else final_light
        total = torch.where(did[:, None], total + contrib * atten, total)
        bad = bad | (did & (torch.isnan(total).any(dim=-1)
                            | (total < 0).any(dim=-1)))
        esc = alive & ~(tri >= 0)
        total = torch.where(esc[:, None],
                            total + atten * sky(rs.env, d).to(ct), total)
        shaded = did & ~bad
        alive = shaded

        u = rng.uniforms(cfg["seed"], pix, frame, sample, j, 7).to(dt)
        nee_o = hp + normal * 0.01
        point = light["corner"] + light["edge_u"] * u[:, 1:2] \
            + light["edge_v"] * u[:, 2:3]
        vec = point - nee_o
        l_dist = norm(vec)
        l_dir = vec / torch.clamp(l_dist, min=1e-20)[:, None]
        cos_pdf_at_l = cosine_pdf(normal, l_dir)
        new_dir = cosine_dir(normal, u[:, 3], u[:, 4])
        real_cos_pdf = cosine_pdf(normal, new_dir)
        rad = albedo * INV_PI * (dot(normal, new_dir) / torch.clamp(
            real_cos_pdf, min=1e-20)).to(ct)[:, None]
        nee_k = albedo * (INV_PI * torch.clamp(dot(normal, l_dir),
                                               min=0.0)).to(ct)[:, None]
        atten = atten * torch.where(alive[:, None], rad, 1.0)

        if j <= cfg["rr_start_bounce"]:
            rr = torch.ones(n, dtype=ct, device=dev)
        else:
            rr = torch.clamp(atten.max(dim=-1).values, max=cfg["rr_clamp"])
        alive = alive & ~(u[:, 6] > rr)
        atten = atten / torch.clamp(rr, min=1e-20)[:, None]
        alive = alive & (j < cfg["bounce_limit"])
        nee_on = alive & (dot(normal, l_dir) > 0.0)

        sign = torch.ones(n, dtype=dt, device=dev)
        new_o = hp + normal * (sign * 1e-5)[:, None]
        new_o = torch.where(alive[:, None], new_o, o)
        new_dir = torch.where(alive[:, None], new_dir, d)
        t, tri = closest(rs, new_o, new_dir, alive)
        blocked = occluded(rs, nee_o, l_dir, nee_on, l_dist * (1.0 - 1e-3))

        reached = nee_on & ~blocked
        cos_l = dot(light["normal"], l_dir)
        pdf = torch.where(reached, l_dist * l_dist / (cos_l * light["area"]),
                          0.0).to(ct)
        pdf = pdf / 1.0  # one light, picked with probability 1
        cos_pdf_at_l = cos_pdf_at_l.to(ct)
        w1 = pdf ** 2 / (pdf ** 2 + cos_pdf_at_l ** 2)
        w1 = torch.where(torch.isnan(w1), 0.0, w1)
        direct_diff = light["emission"].to(ct) * nee_k * torch.where(
            pdf == 0.0, 0.0, w1 / pdf)[:, None]
        direct = torch.where(shaded[:, None], direct_diff, direct)
        o, d = new_o, new_dir
    return torch.where(bad[:, None], 0.0, total)


def render_pixels(rs: RefScene, cfg: dict, cam: dict, pix, n_frames: int,
                  colour=None):
    """The progressive image at pixels ``pix`` after ``n_frames`` steps of
    ``cfg["spp"]`` samples each (frames 0 .. n_frames - 1, samples
    ``frame * spp + k``) -> (P,3) in ``colour`` (``rs.dtype`` unless
    given)."""
    ct = colour or rs.dtype
    dev = pix.device
    spp = cfg["spp"]
    width, height = cfg["width"], cfg["height"]
    per_pixel = n_frames * spp
    block = max(1, PATHS // per_pixel)
    out = []
    for a in range(0, pix.shape[0], block):
        p = pix[a:a + block].to(torch.int64)
        co, cd = camera_rays(cam, width, height, p, rs.dtype)
        cdist, ctri = closest(rs, co, cd, torch.ones(p.shape[0],
                                                  dtype=torch.bool,
                                                  device=dev))
        # path order: (pixel, frame, sample)
        rep = lambda x: x.repeat_interleave(per_pixel, dim=0)
        frame = torch.arange(n_frames, device=dev).repeat_interleave(spp)
        frame = frame.repeat(p.shape[0])
        sample = torch.arange(per_pixel, device=dev).repeat(p.shape[0])
        # no jitter: every sample of a pixel starts with the same camera
        # ray, so its first hit is traced once
        lum = radiance(rs, cfg, rep(co), rep(cd), rep(p), frame, sample,
                       (rep(cdist), rep(ctri)), colour)
        lum = lum.reshape(p.shape[0], n_frames, spp, 3)
        accum = torch.zeros((p.shape[0], 3), dtype=ct, device=dev)
        for f in range(n_frames):
            color = lum[:, f, 0]
            for k in range(1, spp):
                color = color + lum[:, f, k]
            color = color / spp
            w = torch.tensor(1.0, dtype=torch.float32) / (float(f) + 1.0)
            accum = accum * (1.0 - w) + color * w
        out.append(accum)
    return torch.cat(out) if out else torch.zeros((0, 3), dtype=ct,
                                                 device=dev)
